"""Deterministic fault injection for chaos testing (a copy of the training
side of ``lightgbm_tpu/resilience/faults.py``; its serving hooks wait for
ROADMAP Queue A item 10f).

``LIGHTGBM_TPU_FAULTS`` holds a comma-separated list of specs, the JAX
package's interface::

    kind@iteration[:rank=R]

    crash@5:rank=1      os._exit(43) when training reaches iteration 5 on
                        rank 1
    hang@6:rank=0       sleep "forever" at iteration 6 on rank 0, so the
                        peers' guarded collectives time out
    diverge@4:rank=1    perturb the newest grown tree on rank 1 (model and
                        that rank's scores together), a divergence the
                        rank-0 resync repairs
    torn_ckpt@3         write half of the rank's checkpoint arrays at
                        iteration 3 and no manifest: the selector must
                        skip it

Every fault fires at most once per run lineage: when
``LIGHTGBM_TPU_FAULT_STATE`` names a directory, a marker file records the
firing, so a respawned process (same environment, fresh pid) does not
fire it again. Without a state directory the firing state is the
process's own.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

from ..parallel import mesh
from ..utils import log

FAULTS_ENV = "LIGHTGBM_TPU_FAULTS"
FAULT_STATE_ENV = "LIGHTGBM_TPU_FAULT_STATE"

CRASH_EXIT_CODE = 43


class Fault:
    __slots__ = ("kind", "iteration", "rank")

    def __init__(self, kind: str, iteration: int, rank: int = -1):
        self.kind = kind
        self.iteration = int(iteration)
        self.rank = int(rank)

    def key(self) -> str:
        return f"{self.kind}@{self.iteration}.rank{self.rank}"


def parse_faults(spec: str) -> List[Fault]:
    faults: List[Fault] = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        try:
            head, *mods = part.split(":")
            kind, it = head.split("@", 1)
            rank = -1
            for m in mods:
                if m.startswith("rank="):
                    rank = int(m[5:])
            faults.append(Fault(kind.strip(), int(it), rank))
        except (ValueError, IndexError):
            log.warning("ignoring malformed fault spec %r "
                        "(expected kind@iteration[:rank=R])", part)
    return faults


class FaultRegistry:
    """Parsed faults and their at-most-once firing bookkeeping."""

    def __init__(self, faults: List[Fault], state_dir: str = ""):
        self.faults = faults
        self.state_dir = state_dir
        self._fired: set = set()

    def _already_fired(self, f: Fault) -> bool:
        if f.key() in self._fired:
            return True
        if self.state_dir:
            return os.path.exists(os.path.join(self.state_dir, f.key()))
        return False

    def _mark_fired(self, f: Fault) -> None:
        self._fired.add(f.key())
        if self.state_dir:
            try:
                os.makedirs(self.state_dir, exist_ok=True)
                # existence is the bit; written plainly, since a crash
                # fault exits right after and a half-written marker still
                # exists
                with open(os.path.join(self.state_dir, f.key()), "w") as fh:
                    fh.write(str(time.time()))
            except OSError as e:
                log.warning("fault marker write failed: %s", e)

    def due(self, kind: str, iteration: int, rank: int,
            at_or_after: bool = False) -> Optional[Fault]:
        """The first unfired fault of ``kind`` for this rank whose
        iteration equals ``iteration`` (or is at most it, with
        ``at_or_after``); marks it fired."""
        for f in self.faults:
            if f.kind != kind:
                continue
            if f.rank >= 0 and f.rank != int(rank):
                continue
            hit = (f.iteration <= iteration) if at_or_after \
                else (f.iteration == iteration)
            if hit and not self._already_fired(f):
                self._mark_fired(f)
                return f
        return None

    def __bool__(self) -> bool:
        return bool(self.faults)


_EMPTY = FaultRegistry([])
_CACHE: Dict[str, FaultRegistry] = {}


def registry_from_env() -> FaultRegistry:
    """The registry of the current environment values (cached per value,
    so the parse and its warnings happen once and the firing state is
    shared per spec)."""
    spec = os.environ.get(FAULTS_ENV, "")
    if not spec:
        return _EMPTY
    state = os.environ.get(FAULT_STATE_ENV, "")
    key = f"{spec}|{state}"
    reg = _CACHE.get(key)
    if reg is None:
        reg = _CACHE[key] = FaultRegistry(parse_faults(spec), state)
    return reg


# ---------------------------------------------------------------- hooks
def on_training_step(gbdt) -> None:
    """Called by the trainer at the top of every training iteration: fires
    the crash and hang faults once the iteration reaches theirs."""
    reg = getattr(gbdt, "_faults", None) or _EMPTY
    if not reg:
        return
    rank = mesh.rank()
    it = int(gbdt.iter)
    if reg.due("crash", it, rank, at_or_after=True) is not None:
        log.warning("fault injection: crashing rank %d at iteration %d",
                    rank, it)
        os._exit(CRASH_EXIT_CODE)
    if reg.due("hang", it, rank, at_or_after=True) is not None:
        log.warning("fault injection: hanging rank %d at iteration %d",
                    rank, it)
        time.sleep(10 ** 7)


def maybe_diverge(gbdt, iteration: int) -> None:
    """Fires the ``diverge`` fault: perturbs the newest grown tree on the
    target rank (``recovery.inject_divergence``)."""
    reg = getattr(gbdt, "_faults", None) or _EMPTY
    if not reg:
        return
    if reg.due("diverge", int(iteration), mesh.rank()) is not None:
        from . import recovery
        recovery.inject_divergence(gbdt, int(iteration))


def torn_checkpoint_due(iteration: int, rank: int) -> bool:
    reg = registry_from_env()
    if not reg:
        return False
    return reg.due("torn_ckpt", int(iteration), int(rank),
                   at_or_after=True) is not None
