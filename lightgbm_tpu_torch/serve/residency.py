"""Multi-model device residency under a bytes budget.

PyTorch counterpart of ``lightgbm_tpu/serve/residency.py`` on one card (the
per-device replica tables of the serving fleet come with it). One process
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

Telemetry: ``serve.evictions`` / ``serve.rebuilds`` counters,
``serve.resident_bytes`` / ``serve.resident_models`` gauges,
``serve_eviction`` events.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Dict, List, Optional

from .engine import ServingEngine


class ResidencyManager:
    """LRU cache of :class:`ServingEngine` under a bytes budget."""

    def __init__(self, budget_bytes: Optional[int] = None,
                 telemetry=None,
                 engine_factory: Optional[Callable[..., ServingEngine]]
                 = None, **engine_knobs: Any):
        self.budget_bytes = None if budget_bytes is None \
            else int(budget_bytes)
        self.tel = telemetry
        self._factory = engine_factory or ServingEngine
        self._knobs = engine_knobs
        self._boosters: Dict[str, Any] = {}
        self._engines: "collections.OrderedDict[str, ServingEngine]" = \
            collections.OrderedDict()      # LRU: oldest first
        self._pinned = set()
        self._builds: Dict[str, int] = {}
        self._lock = threading.RLock()

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
            return sum(e.packed_nbytes for e in self._engines.values())

    # ------------------------------------------------------------------
    def _new_engine(self, model_id: str, booster) -> ServingEngine:
        return self._factory(booster, model_id=model_id,
                             telemetry=self.tel, **self._knobs)

    def get(self, model_id: str) -> ServingEngine:
        """The engine of ``model_id``, built (or rebuilt after an
        eviction) on demand; touches LRU recency."""
        with self._lock:
            eng = self._engines.get(model_id)
            if eng is not None:
                self._engines.move_to_end(model_id)
                return eng
            booster = self._boosters.get(model_id)
            if booster is None:
                raise KeyError(f"unknown model_id: {model_id!r}")
            eng = self._new_engine(model_id, booster)
            self._builds[model_id] = self._builds.get(model_id, 0) + 1
            if self._builds[model_id] > 1 and self.tel is not None:
                self.tel.inc("serve.rebuilds")
            self._engines[model_id] = eng
            self._evict_to_budget(keep=model_id)
            self._update_gauges()
            return eng

    def _evict_to_budget(self, keep: str) -> None:
        if self.budget_bytes is None:
            return
        total = sum(e.packed_nbytes for e in self._engines.values())
        while total > self.budget_bytes:
            victim = next((mid for mid in self._engines
                           if mid != keep and mid not in self._pinned),
                          None)
            if victim is None:
                # nothing evictable left (all pinned / just built): the
                # overflow is deliberate, but it must be visible
                if self.tel is not None:
                    self.tel.event("serve_budget_exceeded",
                                   resident_bytes=total,
                                   budget_bytes=self.budget_bytes)
                return
            freed = self._engines.pop(victim).packed_nbytes
            total -= freed
            if self.tel is not None:
                self.tel.inc("serve.evictions")
                self.tel.event("serve_eviction", model_id=victim,
                               bytes=freed, resident_bytes=total,
                               budget_bytes=self.budget_bytes)

    def _update_gauges(self) -> None:
        if self.tel is None:
            return
        self.tel.gauge("serve.resident_models", len(self._engines))
        self.tel.gauge("serve.resident_bytes", self.resident_bytes)

    # ------------------------------------------------------- rollover
    def build_candidate(self, model_id: str, booster) -> ServingEngine:
        """The engine of a rollover candidate, built outside the resident
        table and without the lock (packing and warmup are the slow part
        and must not stall live dispatches); install it with
        :meth:`swap`."""
        return self._new_engine(model_id, booster)

    def swap(self, model_id: str, booster,
             engine: ServingEngine) -> Optional[ServingEngine]:
        """Replace ``model_id``'s booster and engine in one critical
        section: a dispatch in flight finishes on the old engine it holds,
        every later one gets the new. Pin state is kept; returns the old
        engine."""
        with self._lock:
            if model_id not in self._boosters:
                raise KeyError(f"unknown model_id: {model_id!r}")
            self._boosters[model_id] = booster
            old = self._engines.pop(model_id, None)
            self._engines[model_id] = engine
            self._builds[model_id] = self._builds.get(model_id, 0) + 1
            self._evict_to_budget(keep=model_id)
            self._update_gauges()
            return old

    # ------------------------------------------------------------------
    def pin(self, model_id: str) -> None:
        """Exempt from eviction (and make resident now)."""
        self.get(model_id)
        with self._lock:
            self._pinned.add(model_id)

    def unpin(self, model_id: str) -> None:
        with self._lock:
            self._pinned.discard(model_id)

    def evict(self, model_id: str) -> bool:
        """Drop a model's device tensors (its booster stays registered;
        the next request re-packs)."""
        with self._lock:
            hit = self._engines.pop(model_id, None) is not None
            self._update_gauges()
            return hit

    def resident(self) -> List[str]:
        with self._lock:
            return list(self._engines)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"models": list(self._boosters),
                    "resident": list(self._engines),
                    "pinned": sorted(self._pinned),
                    "resident_bytes": self.resident_bytes,
                    "budget_bytes": self.budget_bytes,
                    "builds": dict(self._builds),
                    "engines": {mid: e.stats()
                                for mid, e in self._engines.items()}}
