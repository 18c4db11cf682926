"""Thread-safe telemetry registry: the part of
``lightgbm_tpu/obs/registry.py`` that serving needs.

One :class:`Telemetry` instance per prediction service. It holds

- **counters** — monotone sums (requests, dispatches, compiles, ...);
- **gauges** — last-written values (queue depth, resident bytes, device
  memory watermarks) and high-watermark gauges (``gauge_max``);
- **distributions** — a bounded ring of recent samples per name (request
  latencies, micro-batch sizes), summarised with p50/p95/p99;
- **events** — a bounded ring of structured records, mirrored to the JSONL
  sink when one is attached (``telemetry_out=<path>``).

Disabled-path contract: every recording method returns after one
``self.enabled`` check. The rank is ``torch.distributed``'s where it is
initialised, else 0. The JAX package's training records (per-iteration
sections, collectives, megastep records, the jax.monitoring bridge) and
its trace spans (``trace_out``) wait for ROADMAP Queue A item 10e.
:func:`allgather_json` is the host-plane gather the rank-0 resync rides
(``resilience/recovery.py``).
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional

_EVENT_RING = 512       # bounded in-memory event history
_DIST_RING = 8192       # recent samples per value distribution
# torch.cuda.memory_stats keys gauged at each serving dispatch boundary
_MEM_KEYS = (("allocated_bytes.all.current", "bytes_in_use"),
             ("allocated_bytes.all.peak", "peak_bytes_in_use"),
             ("reserved_bytes.all.current", "bytes_reserved"))


class Telemetry:
    """Counters + gauges + value distributions + structured events."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._lock = threading.RLock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._events = collections.deque(maxlen=_EVENT_RING)
        self._dists: Dict[str, collections.deque] = {}
        # cumulative [count, sum] per dist name: monotone even after the
        # ring wraps
        self._dist_totals: Dict[str, List[float]] = {}
        self._sink = None
        self._rank: Optional[int] = None

    # ------------------------------------------------------------ admin
    @property
    def rank(self) -> int:
        if self._rank is None:
            try:
                import torch.distributed as dist
                self._rank = int(dist.get_rank()) \
                    if dist.is_available() and dist.is_initialized() else 0
            except Exception:
                self._rank = 0
        return self._rank

    def enable(self, sink_path: Optional[str] = None) -> bool:
        """Turn recording on; ``sink_path`` also streams every event as a
        JSONL line (rank-suffixed off rank 0). Returns True when this call
        attached a new sink (the same path again is a no-op; another path
        closes the old sink)."""
        from .events import JsonlSink
        attached = False
        with self._lock:
            if sink_path:
                old = self._sink
                if old is not None and old.requested_path != sink_path:
                    old.close()
                    self._sink = None
                if self._sink is None:
                    self._sink = JsonlSink(sink_path, rank=self.rank)
                    attached = True
            self.enabled = True
        return attached

    def disable(self) -> None:
        self.flush()
        self.enabled = False

    def flush(self) -> None:
        sink = self._sink
        if sink is not None:
            sink.flush()

    def close(self) -> None:
        self.disable()
        sink, self._sink = self._sink, None
        if sink is not None:
            sink.close()

    # ------------------------------------------------------- primitives
    def inc(self, name: str, value: float = 1) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def gauge(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._gauges[name] = value

    def gauge_max(self, name: str, value: float) -> None:
        """High-watermark gauge: keeps the largest value recorded."""
        if not self.enabled:
            return
        with self._lock:
            prev = self._gauges.get(name)
            if prev is None or value > prev:
                self._gauges[name] = value

    def dist(self, name: str, value: float) -> None:
        """One sample of a value distribution (request latency, batch
        size): a bounded ring per name, so the snapshot reports
        p50/p95/p99 of the most recent ``_DIST_RING`` samples."""
        if not self.enabled:
            return
        with self._lock:
            d = self._dists.get(name)
            if d is None:
                d = self._dists[name] = collections.deque(
                    maxlen=_DIST_RING)
                self._dist_totals[name] = [0, 0.0]
            d.append(float(value))
            tot = self._dist_totals[name]
            tot[0] += 1
            tot[1] += float(value)

    @staticmethod
    def _dist_summary(samples, totals=None) -> Dict[str, float]:
        vals = sorted(samples)
        n = len(vals)
        count, total = (totals if totals is not None
                        else (n, float(sum(vals))))
        if n == 0:
            return {"count": int(count), "sum": float(total)}

        def q(p: float) -> float:
            return vals[min(n - 1, int(p * (n - 1) + 0.5))]

        return {"count": int(count), "sum": float(total),
                "min": vals[0], "max": vals[-1],
                "p50": q(0.50), "p95": q(0.95), "p99": q(0.99)}

    def event(self, name: str, **attrs: Any) -> None:
        """Structured event: ring-buffered, counted, sunk to JSONL."""
        if not self.enabled:
            return
        rec: Dict[str, Any] = {"ts": time.time(), "rank": self.rank,
                               "event": name}
        rec.update(attrs)
        with self._lock:
            self._events.append(rec)
            key = "events." + name
            self._counters[key] = self._counters.get(key, 0) + 1
            sink = self._sink
        if sink is not None:
            sink.write(rec)

    def compile_executable(self, signature: str, compile_ms: float,
                           operand_bytes: int, **attrs: Any) -> None:
        """One record per new dispatch signature (a serving bucket): its
        first call's wall time and the bytes its operands pin."""
        if not self.enabled:
            return
        self.inc("compile.executables")
        self.inc("compile.operand_bytes", max(0, int(operand_bytes)))
        self.event("compile_executable", signature=str(signature),
                   compile_ms=round(float(compile_ms), 3),
                   operand_bytes=int(operand_bytes), **attrs)

    def memory_watermarks(self, where: str = "") -> None:
        """Gauge the current CUDA device's allocated, peak and reserved
        bytes (``mem.d<i>.*``, from ``torch.cuda.memory_stats``) and count
        the observation; nothing without an initialised CUDA device."""
        if not self.enabled:
            return
        try:
            import torch
            if not torch.cuda.is_initialized():
                return
            dev = torch.cuda.current_device()
            stats = torch.cuda.memory_stats(dev)
        except Exception:
            return
        for key, name in _MEM_KEYS:
            if key in stats:
                self.gauge(f"mem.d{dev}.{name}", int(stats[key]))
        if where:
            self.inc("mem.watermarks." + where)

    # --------------------------------------------------------- snapshot
    def metrics_snapshot(self) -> Dict[str, Any]:
        """Counters, gauges and distributions without the event ring (the
        admission controller reads its p99 here)."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "rank": self.rank,
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "dists": {k: self._dist_summary(v, self._dist_totals[k])
                          for k, v in self._dists.items() if v},
            }

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time view: counters, gauges, distributions and the
        recent event ring."""
        out = self.metrics_snapshot()
        with self._lock:
            out["events"] = [dict(e) for e in self._events]
        return out


def allgather_json(obj: Any) -> List[Any]:
    """Every rank's JSON-serializable ``obj``, in rank order, over the host
    plane (``[obj]`` without a group of two or more; the JAX package's
    ``allgather_json``). Every rank calls it at the same point. Both
    gathers (the sizes, then the padded bytes) run under the
    host-collective policy, so a hung peer raises a ``CollectiveError``
    once ``collective_timeout`` passes."""
    import json

    import numpy as np

    from ..parallel import mesh
    from ..parallel.multiproc import _allgather
    if mesh.world() <= 1:
        return [obj]
    payload = np.frombuffer(json.dumps(obj).encode("utf-8"), np.uint8)
    sizes = _allgather(np.asarray([payload.size], np.int64),
                       what="allgather_json/sizes").reshape(-1)
    width = int(sizes.max())
    buf = np.zeros(width, np.uint8)
    buf[:payload.size] = payload
    gathered = _allgather(buf, what="allgather_json/payload")
    return [json.loads(bytes(gathered[r, :int(sizes[r])]).decode("utf-8"))
            for r in range(sizes.size)]
