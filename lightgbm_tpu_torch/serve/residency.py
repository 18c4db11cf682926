"""Multi-model device residency under a bytes budget, per device.

PyTorch counterpart of ``lightgbm_tpu/serve/residency.py``. One process
serves N boosters:

- engines build lazily on first use and stay resident;
- every build charges the engine's ``packed_nbytes`` against
  ``budget_bytes``; when the budget would overflow, least-recently-used
  unpinned engines are evicted (their device tensors dropped; the host
  booster is kept, so a later request re-packs, and because the signature
  registry is process-wide, a re-pack of unchanged shapes counts no new
  compile);
- ``pin()`` exempts hot models from eviction; a pinned set alone past the
  budget is allowed but flagged with a ``serve_budget_exceeded`` event;
- ``build_candidate`` / ``swap`` install a rollover candidate in one
  critical section.

Fleet mode (``devices=[...]``, one entry per dispatch lane, repeats
allowed): one replica table per lane. ``get(model_id, device)`` returns
lane ``device``'s replica, built from an existing replica's packing (one
pack per model, N placements: ``ServingEngine(shared=...)``). LRU
recency is kept per lane; ``budget_bytes`` applies per physical device,
over the bytes every lane on it is charged (replicas on the base's device
hold its very tensors and are charged nothing), and an eviction drops a
model from every lane in one step, so the pack its replicas share is
freed with it and the charges stay the storages still alive. ``swap``
installs the full replica set in one critical section, so no mix of
model versions across lanes is ever observable. ``devices=None`` is the
single-device plane.

Telemetry: ``serve.evictions`` / ``serve.rebuilds`` counters,
``serve.resident_bytes`` / ``serve.resident_models`` gauges (and
``serve.d<i>.resident_bytes`` / ``resident_models`` in fleet mode),
``serve_eviction`` events.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from .engine import ServingEngine


class ResidencyManager:
    """LRU cache of :class:`ServingEngine` replicas under a per-lane
    budget."""

    def __init__(self, budget_bytes: Optional[int] = None,
                 telemetry=None,
                 engine_factory: Optional[Callable[..., ServingEngine]]
                 = None, devices: Optional[Sequence] = None,
                 **engine_knobs: Any):
        self.budget_bytes = None if budget_bytes is None \
            else int(budget_bytes)
        self.tel = telemetry
        self._factory = engine_factory or ServingEngine
        self._knobs = engine_knobs
        # one replica table per lane; devices=None builds engines without
        # placement arguments, so custom factories keep working
        self.devices = list(devices) if devices else None
        self.n_devices = len(self.devices) if self.devices else 1
        self._boosters: Dict[str, Any] = {}
        self._tables: List[
            "collections.OrderedDict[str, ServingEngine]"] = [
            collections.OrderedDict()      # LRU: oldest first
            for _ in range(self.n_devices)]
        self._pinned = set()
        self._builds: Dict[str, int] = {}
        self._lock = threading.RLock()

    @property
    def _engines(self) -> "collections.OrderedDict[str, ServingEngine]":
        """Lane 0's table (the only one without a fleet)."""
        return self._tables[0]

    # ------------------------------------------------------------------
    def register(self, model_id: str, booster) -> None:
        with self._lock:
            self._boosters[model_id] = booster

    def model_ids(self) -> List[str]:
        with self._lock:
            return list(self._boosters)

    def has(self, model_id: str) -> bool:
        with self._lock:
            return model_id in self._boosters

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return sum(e.packed_nbytes for t in self._tables
                       for e in t.values())

    def resident_bytes_on(self, device: int) -> int:
        with self._lock:
            return sum(e.packed_nbytes
                       for e in self._tables[device].values())

    # ------------------------------------------------------------------
    def _build_key(self, model_id: str, device: int) -> str:
        return model_id if self.devices is None \
            else f"{model_id}@d{device}"

    def _placement(self, device: int, shared=None) -> Dict[str, Any]:
        if self.devices is None:
            return {}
        kw = {"device": self.devices[device], "device_index": device}
        if shared is not None:
            kw["shared"] = shared
        return kw

    def _build_locked(self, model_id: str, device: int) -> ServingEngine:
        booster = self._boosters.get(model_id)
        if booster is None:
            raise KeyError(f"unknown model_id: {model_id!r}")
        # reuse an existing replica's packing: one pack per model
        shared = next((t[model_id] for t in self._tables
                       if model_id in t), None) \
            if self.devices is not None else None
        eng = self._factory(booster, model_id=model_id, telemetry=self.tel,
                            **self._placement(device, shared),
                            **self._knobs)
        bk = self._build_key(model_id, device)
        self._builds[bk] = self._builds.get(bk, 0) + 1
        if self._builds[bk] > 1 and self.tel is not None:
            self.tel.inc("serve.rebuilds")
        return eng

    def get(self, model_id: str, device: int = 0) -> ServingEngine:
        """The replica of ``model_id`` on lane ``device``, built (or
        rebuilt after an eviction) on demand; touches LRU recency."""
        with self._lock:
            table = self._tables[device]
            eng = table.get(model_id)
            if eng is not None:
                table.move_to_end(model_id)
                return eng
            eng = self._build_locked(model_id, device)
            table[model_id] = eng
            self._evict_to_budget(device, keep=model_id)
            self._update_gauges()
            return eng

    def _same_card(self, device: int) -> List[int]:
        """The lanes on lane ``device``'s physical device, it first."""
        if self.devices is None:
            return [0]
        at = self.devices[device]
        return [device] + [d for d, dev in enumerate(self.devices)
                           if dev == at and d != device]

    def _evict_to_budget(self, device: int, keep: str) -> None:
        if self.budget_bytes is None:
            return
        lanes = self._same_card(device)

        def charged() -> int:
            return sum(e.packed_nbytes for d in lanes
                       for e in self._tables[d].values())
        total = charged()
        while total > self.budget_bytes:
            # least recent first on this lane, then on its card's others
            victim = next((mid for d in lanes for mid in self._tables[d]
                           if mid != keep and mid not in self._pinned),
                          None)
            if victim is None:
                # nothing evictable left (all pinned / just built): the
                # overflow is deliberate, but it must be visible
                if self.tel is not None:
                    self.tel.event("serve_budget_exceeded",
                                   resident_bytes=total,
                                   budget_bytes=self.budget_bytes,
                                   **({} if self.devices is None
                                      else {"device": device}))
                return
            # every lane at once: the replicas share one pack
            for t in self._tables:
                t.pop(victim, None)
            freed = total - charged()
            total -= freed
            if self.tel is not None:
                self.tel.inc("serve.evictions")
                self.tel.event("serve_eviction", model_id=victim,
                               bytes=freed, resident_bytes=total,
                               budget_bytes=self.budget_bytes,
                               **({} if self.devices is None
                                  else {"device": device}))

    def _resident_ids(self) -> List[str]:
        seen: "collections.OrderedDict[str, None]" = \
            collections.OrderedDict()
        for t in self._tables:
            for mid in t:
                seen.setdefault(mid)
        return list(seen)

    def _update_gauges(self) -> None:
        if self.tel is None:
            return
        self.tel.gauge("serve.resident_models", len(self._resident_ids()))
        self.tel.gauge("serve.resident_bytes", self.resident_bytes)
        if self.devices is not None:
            for d, t in enumerate(self._tables):
                self.tel.gauge(f"serve.d{d}.resident_models", len(t))
                self.tel.gauge(f"serve.d{d}.resident_bytes",
                               sum(e.packed_nbytes for e in t.values()))

    # ------------------------------------------------------- rollover
    def build_candidate(self, model_id: str, booster
                        ) -> Union[ServingEngine,
                                   Dict[int, ServingEngine]]:
        """The engine of a rollover candidate, built outside the resident
        tables and without the lock (packing and warmup are the slow part
        and must not stall live dispatches); install it with
        :meth:`swap`. In fleet mode the full replica set ``{lane:
        engine}`` over one packing."""
        if self.devices is None:
            return self._factory(booster, model_id=model_id,
                                 telemetry=self.tel, **self._knobs)
        base = self._factory(booster, model_id=model_id, telemetry=self.tel,
                             **self._placement(0), **self._knobs)
        replicas = {0: base}
        for d in range(1, self.n_devices):
            replicas[d] = self._factory(
                booster, model_id=model_id, telemetry=self.tel,
                **self._placement(d, base), **self._knobs)
        return replicas

    def swap(self, model_id: str, booster,
             engine: Union[ServingEngine, Dict[int, ServingEngine]]
             ) -> Optional[ServingEngine]:
        """Replace ``model_id``'s booster and every lane's replica in one
        critical section: a dispatch in flight finishes on the old engine
        it holds, every later one, on any lane, gets the new. Pin state is
        kept; returns the old lane-0 engine."""
        replicas = engine if isinstance(engine, dict) else {0: engine}
        with self._lock:
            if model_id not in self._boosters:
                raise KeyError(f"unknown model_id: {model_id!r}")
            self._boosters[model_id] = booster
            old = None
            for d, t in enumerate(self._tables):
                o = t.pop(model_id, None)
                if d == 0:
                    old = o
            for d, eng in replicas.items():
                self._tables[d][model_id] = eng
                bk = self._build_key(model_id, d)
                self._builds[bk] = self._builds.get(bk, 0) + 1
            for d in replicas:
                self._evict_to_budget(d, keep=model_id)
            self._update_gauges()
            return old

    # ------------------------------------------------------------------
    def pin(self, model_id: str) -> None:
        """Exempt from eviction (and make resident now, on every lane)."""
        for d in range(self.n_devices):
            self.get(model_id, d)
        with self._lock:
            self._pinned.add(model_id)

    def unpin(self, model_id: str) -> None:
        with self._lock:
            self._pinned.discard(model_id)

    def evict(self, model_id: str) -> bool:
        """Drop a model's device tensors on every lane (its booster stays
        registered; the next request re-packs)."""
        with self._lock:
            hit = False
            for t in self._tables:
                if t.pop(model_id, None) is not None:
                    hit = True
            self._update_gauges()
            return hit

    def resident(self) -> List[str]:
        with self._lock:
            return self._resident_ids()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {"models": list(self._boosters),
                   "resident": self._resident_ids(),
                   "pinned": sorted(self._pinned),
                   "resident_bytes": self.resident_bytes,
                   "budget_bytes": self.budget_bytes,
                   "builds": dict(self._builds),
                   "engines": {mid: e.stats()
                               for mid, e in self._tables[0].items()}}
            if self.devices is not None:
                out["devices"] = self.n_devices
                out["per_device"] = [
                    {"device": d, "resident": list(t),
                     "resident_bytes": sum(e.packed_nbytes
                                           for e in t.values())}
                    for d, t in enumerate(self._tables)]
            return out
