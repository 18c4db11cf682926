"""Asynchronous per-rank training checkpoints (a copy of
``lightgbm_tpu/resilience/checkpoint.py``, in its format: either package
reads the other's checkpoints; its telemetry counters wait for ROADMAP
Queue A item 10e).

Layout, one directory per checkpoint with per-rank files::

    <checkpoint_dir>/
      ckpt_0000000008/
        rank0.npz     arrays (trees, scores, random streams)
        rank0.json    manifest: schema, rank, world, iteration,
                      model-state hash, npz byte size, JSON payload

Commit order per rank: the ``.npz`` (temp, fsync, rename), then the
manifest likewise. The manifest's existence commits the rank's part, so a
crash at any point leaves the previous checkpoint whole and the new one
incomplete, which :func:`select_checkpoint` skips. Retention keeps the
newest ``keep`` checkpoints per rank; the older one is pruned only after
the next one commits.

The training thread captures the state (``state.capture``: the device to
host copies happen there, at an iteration edge) and hands numpy arrays
and a JSON payload to the writer thread, which serializes, writes,
renames and prunes without blocking an iteration. The writer never sees a
torch tensor. ``wait()`` joins the write in flight.
"""
from __future__ import annotations

import io
import json
import os
import queue
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils import log
from .atomicio import atomic_write_bytes, atomic_write_json

SCHEMA_VERSION = 1
_CKPT_RE = re.compile(r"^ckpt_(\d{10})$")


def _ckpt_dirname(iteration: int) -> str:
    return f"ckpt_{int(iteration):010d}"


def list_checkpoints(root: str) -> List[Tuple[int, str]]:
    """(iteration, path) of every checkpoint directory under ``root``,
    newest first. Existence only: completeness is the selector's job."""
    out: List[Tuple[int, str]] = []
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for name in names:
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(root, name)))
    out.sort(reverse=True)
    return out


def _read_manifest(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path) as fh:
            man = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(man, dict) or man.get("schema") != SCHEMA_VERSION:
        return None
    return man


def checkpoint_manifests(path: str, world: int) -> Optional[List[Dict]]:
    """The ``world`` rank manifests of one checkpoint directory when it is
    complete and consistent (every rank present, one iteration, one
    model-state hash, each npz at its recorded size); None otherwise: a
    torn write fails one of these checks."""
    mans = []
    for r in range(world):
        man = _read_manifest(os.path.join(path, f"rank{r}.json"))
        if man is None or int(man.get("rank", -1)) != r \
                or int(man.get("world", 0)) != world:
            return None
        npz = os.path.join(path, man.get("npz", ""))
        try:
            if os.path.getsize(npz) != int(man.get("npz_bytes", -1)):
                return None
        except OSError:
            return None
        mans.append(man)
    iters = {int(m["iteration"]) for m in mans}
    hashes = {m.get("model_hash") for m in mans}
    if len(iters) != 1 or len(hashes) != 1:
        return None
    return mans


def select_checkpoint(root: str, world: int) -> Optional[str]:
    """The newest checkpoint directory complete and hash-consistent across
    all ``world`` ranks: a restart's starting point."""
    for _, path in list_checkpoints(root):
        if checkpoint_manifests(path, world) is not None:
            return path
    return None


def load_rank(path: str, rank: int):
    """(payload dict, npz mapping) of one rank of a checkpoint directory;
    raises on a missing or torn checkpoint, so a resume never trains
    silently from nothing."""
    man = _read_manifest(os.path.join(path, f"rank{rank}.json"))
    if man is None:
        raise FileNotFoundError(
            f"no valid rank{rank} manifest in checkpoint {path!r} "
            "(incomplete or torn write — pick a checkpoint "
            "select_checkpoint accepts)")
    npz_path = os.path.join(path, man["npz"])
    arrays = np.load(npz_path, allow_pickle=False)
    return man["payload"], arrays


def encode_npz(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


class CheckpointManager:
    """One rank's asynchronous checkpoint writer over one root."""

    def __init__(self, root: str, rank: int, world: int, keep: int = 2):
        self.root = str(root)
        self.rank = int(rank)
        self.world = max(1, int(world))
        self.keep = max(1, int(keep))
        self.last_error: Optional[str] = None
        # the newest committed write: iteration, path, model hash, and the
        # npz bytes and seconds the write took
        self.last_written: Optional[Dict[str, Any]] = None
        os.makedirs(self.root, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._worker: Optional[threading.Thread] = threading.Thread(
            target=self._run, daemon=True,
            name=f"ckpt-writer-rank{self.rank}")
        self._worker.start()

    # ------------------------------------------------------------ write
    def save(self, iteration: int, payload: Dict[str, Any],
             arrays: Dict[str, np.ndarray]) -> None:
        """Enqueue one checkpoint of host arrays, owned by the writer from
        here on. Blocks only while a prior write is in flight (a queue of
        one: checkpoints stay ordered, and saves faster than the disk show
        as backpressure, not as memory)."""
        self._q.put((int(iteration), payload, arrays))

    def wait(self, timeout: float = 120.0) -> None:
        """Block until every enqueued write has committed
        (``unfinished_tasks`` falls only after a write completes)."""
        deadline = time.time() + timeout
        while self._q.unfinished_tasks:
            if time.time() > deadline:
                raise TimeoutError("checkpoint writer did not drain")
            time.sleep(0.01)

    def close(self, timeout: float = 120.0) -> None:
        """Drain the queue and stop the writer thread; the manager is dead
        afterwards (a reset replaces it, never reuses it)."""
        if self._worker is None:
            return
        self.wait(timeout)
        self._q.put(None)           # the writer's exit sentinel
        self._worker.join(timeout=5.0)
        self._worker = None

    def _run(self) -> None:
        while True:
            job = self._q.get()
            try:
                if job is None:
                    return
                self._write(*job)
            finally:
                self._q.task_done()

    def _write(self, iteration: int, payload: Dict[str, Any],
               arrays: Dict[str, np.ndarray]) -> None:
        t0 = time.perf_counter()
        try:
            cdir = os.path.join(self.root, _ckpt_dirname(iteration))
            os.makedirs(cdir, exist_ok=True)
            blob = encode_npz(arrays)
            npz_name = f"rank{self.rank}.npz"
            from . import faults
            if faults.torn_checkpoint_due(iteration, self.rank):
                # chaos hook: a crash mid-write — half the npz bytes, no
                # manifest, written in place so the torn file is visible
                log.warning("fault injection: torn checkpoint write at "
                            "iteration %d", iteration)
                with open(os.path.join(cdir, npz_name), "wb") as fh:
                    fh.write(blob[:max(1, len(blob) // 2)])
                return
            atomic_write_bytes(os.path.join(cdir, npz_name), blob)
            manifest = {
                "schema": SCHEMA_VERSION,
                "rank": self.rank,
                "world": self.world,
                "iteration": int(iteration),
                "model_hash": payload.get("model_hash", ""),
                "npz": npz_name,
                "npz_bytes": len(blob),
                "ts": time.time(),
                "payload": payload,
            }
            # the manifest commits this rank's part: last
            atomic_write_json(os.path.join(cdir, f"rank{self.rank}.json"),
                              manifest)
            self.last_written = {"iteration": int(iteration), "path": cdir,
                                 "model_hash": payload.get("model_hash",
                                                           ""),
                                 "bytes": len(blob),
                                 "seconds": time.perf_counter() - t0}
            self.last_error = None
            self._prune()
        except Exception as e:
            # a failed checkpoint never kills training: only its insurance
            # lapsed, and the warning says so
            self.last_error = f"{type(e).__name__}: {e}"
            log.warning("checkpoint write at iteration %d failed: %s",
                        iteration, self.last_error)

    # ------------------------------------------------------------ prune
    def _prune(self) -> None:
        """Remove this rank's files from the checkpoints older than the
        newest ``keep`` that hold its manifest, then rmdir where empty
        (the last rank to prune removes the directory)."""
        mine = [(it, path) for it, path in list_checkpoints(self.root)
                if os.path.exists(os.path.join(path,
                                               f"rank{self.rank}.json"))]
        for it, path in mine[self.keep:]:
            for name in (f"rank{self.rank}.json", f"rank{self.rank}.npz"):
                try:
                    os.remove(os.path.join(path, name))
                except OSError:
                    pass
            try:
                os.rmdir(path)
            except OSError:
                pass  # other ranks' files still inside
