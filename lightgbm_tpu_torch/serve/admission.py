"""Adaptive admission control driven by the live latency distribution.

A copy of ``lightgbm_tpu/serve/admission.py`` (which imports no JAX; the
port keeps its own).

The static queue bounds (``max_queue_rows``/``max_queue_requests``)
protect memory, but the number an operator actually cares about is the
latency SLO — so the controller closes the loop from the live
``serve.latency_ms`` p95/p99 rings the telemetry registry already
maintains back onto
the batcher's three levers:

- ``max_delay_ms`` — coalescing delay: halved per escalation level, so
  under pressure requests stop waiting for company they do not need;
- the micro-batch row cap (bucket selection) — halved per level, so
  each device call pads into a SMALLER warmed power-of-two bucket and
  bounds the tail latency it adds (never below ``min_batch_rows``, and
  never a fresh compile: every smaller bucket was AOT-compiled by
  ``warmup()``);
- the shed watermark — an admission bound UNDER the hard queue cap:
  above it, new submits are rejected with ``ServeRejected`` so the
  backlog (and therefore queue wait) cannot grow past what the SLO can
  absorb.

Hysteresis so it cannot flap: escalation needs ``hysteresis``
CONSECUTIVE over-target evaluations, recovery needs ``hysteresis``
consecutive evaluations under ``recover_ratio * target`` — the band in
between resets both streaks, holding the current level.  Every level
change emits a structured ``serve_admission`` event and re-gauges
``serve.admission_level`` / ``serve.max_delay_ms`` /
``serve.shed_watermark_rows``.

The controller runs on the batcher's worker thread (the
``on_batch_done`` hook), time-gated to ``interval_s`` — no extra
threads, and an idle service (no batches) is by definition not
overloaded.  Armed by ``PredictionService(target_p99_ms=...)`` (config
key ``serve_target_p99_ms``); the default 0 keeps it off and the
serving plane byte-for-byte on its pre-overload-hardening behavior.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

_MAX_LEVEL = 4


class AdmissionController:
    """p99-driven hysteresis controller over one MicroBatcher."""

    def __init__(self, batcher, telemetry, target_p99_ms: float,
                 interval_s: float = 0.25, hysteresis: int = 3,
                 min_delay_ms: float = 0.25, min_batch_rows: int = 16,
                 recover_ratio: float = 0.7,
                 dist_name: str = "serve.latency_ms"):
        self.batcher = batcher
        self.tel = telemetry
        self.target_p99_ms = float(target_p99_ms)
        self.interval_s = float(interval_s)
        self.hysteresis = max(1, int(hysteresis))
        self.min_delay_s = float(min_delay_ms) / 1000.0
        self.min_batch_rows = max(1, int(min_batch_rows))
        self.recover_ratio = float(recover_ratio)
        self.dist_name = dist_name
        # the healthy-state operating point the levels divide down from
        self.base_delay_s = batcher.max_delay_s
        self.base_batch_rows = batcher.max_batch_rows
        # watermark base: the configured hard cap, or (unbounded queue)
        # a generous multiple of the batch cap — the watermark exists to
        # bound queue WAIT, which an unbounded queue cannot do alone
        self.base_queue_rows = batcher.max_queue_rows or \
            self.base_batch_rows * 16
        self.level = 0
        self._over = 0
        self._under = 0
        self._last_eval = 0.0

    # ------------------------------------------------------------------
    def _p99(self) -> Optional[float]:
        if self.tel is None:
            return None
        d = self.tel.metrics_snapshot().get("dists", {}) \
            .get(self.dist_name)
        return None if not d else float(d.get("p99", 0.0))

    def step(self, now: Optional[float] = None,
             p99_ms: Optional[float] = None, force: bool = False) -> None:
        """One evaluation (batcher ``on_batch_done`` hook).  ``p99_ms``/
        ``force`` exist for deterministic unit tests; production calls
        pass nothing and are time-gated."""
        if self.target_p99_ms <= 0:
            return
        now = time.perf_counter() if now is None else now
        if not force and now - self._last_eval < self.interval_s:
            return
        self._last_eval = now
        p99 = self._p99() if p99_ms is None else float(p99_ms)
        if p99 is None or p99 <= 0:
            return
        if p99 > self.target_p99_ms:
            self._over += 1
            self._under = 0
        elif p99 < self.target_p99_ms * self.recover_ratio:
            self._under += 1
            self._over = 0
        else:
            # dead band: neither escalate nor recover — the hysteresis
            # core; an oscillating p99 around the target holds level
            self._over = self._under = 0
        if self._over >= self.hysteresis and self.level < _MAX_LEVEL:
            self.level += 1
            self._over = 0
            self._apply("shed", p99)
        elif self._under >= self.hysteresis and self.level > 0:
            self.level -= 1
            self._under = 0
            self._apply("recover", p99)

    # ------------------------------------------------------------------
    def _apply(self, direction: str, p99: float) -> None:
        b = self.batcher
        lv = self.level
        b.max_delay_s = max(self.min_delay_s,
                            self.base_delay_s / (2 ** lv))
        b.max_batch_rows = max(self.min_batch_rows,
                               self.base_batch_rows >> lv)
        # no batch-rows floor here: when the configured hard cap is
        # smaller than a micro-batch, a floored watermark would sit
        # above the cap and be clamped inert — shedding down to a
        # below-one-batch backlog is fine (the oversized-single-on-
        # empty-queue exemption keeps requests flowing)
        b.shed_watermark_rows = None if lv == 0 else max(
            1, self.base_queue_rows >> lv)
        if self.tel is not None:
            self.tel.gauge("serve.admission_level", lv)
            self.tel.gauge("serve.max_delay_ms", b.max_delay_s * 1000.0)
            self.tel.gauge("serve.shed_watermark_rows",
                           b.shed_watermark_rows or 0)
            self.tel.event(
                "serve_admission", level=lv, direction=direction,
                p99_ms=round(p99, 3), target_p99_ms=self.target_p99_ms,
                max_delay_ms=round(b.max_delay_s * 1000.0, 3),
                max_batch_rows=int(b.max_batch_rows),
                shed_watermark_rows=b.shed_watermark_rows)

    def stats(self) -> Dict[str, Any]:
        b = self.batcher
        return {"level": self.level,
                "target_p99_ms": self.target_p99_ms,
                "max_delay_ms": b.max_delay_s * 1000.0,
                "max_batch_rows": int(b.max_batch_rows),
                "shed_watermark_rows": b.shed_watermark_rows}
