"""PredictionService: the public serving facade.

PyTorch counterpart of ``lightgbm_tpu/serve/service.py`` on one card. It
owns the engine, micro-batcher and residency layers plus the telemetry
registry::

    import lightgbm_tpu_torch as lgb
    svc = lgb.serve.PredictionService(
        {"churn": "churn_model.txt", "rank": rank_booster},
        max_batch_rows=8192, max_delay_ms=2.0,
        device_budget_bytes=256 << 20, telemetry_out="serve.jsonl",
        max_queue_rows=65536,             # admission control (bounded
        default_deadline_ms=250.0,        #  queue + dequeue shedding)
        target_p99_ms=50.0,               # adaptive controller
        retry_policy=lgb.serve.RetryPolicy())
    svc.warmup()                          # every bucket dispatched once
    y = svc.predict("churn", X)           # sync (submit + wait + retry)
    fut = svc.submit("rank", X2, deadline_ms=100)   # future form
    svc.rollover("churn", "churn_v2.txt", shadow_requests=100)
    svc.stats()                           # latency p50/p95/p99, counters
    svc.close(drain_timeout_s=10)

Models may be live ``Booster`` objects (binned routing through their
training BinMappers) or model-file paths / model strings (raw routing, no
training dataset needed; loaded on ``device_type``, default the card). A
model the stacked predictor cannot hold serves through the float64 walk
with a ``serve_degradation`` event, never an error.

Overload and rollover: admission control, deadlines and adaptive shedding
live in the micro-batcher and the controller, every knob off by default;
``predict`` retries shed or rejected requests under a :class:`RetryPolicy`
(never compute errors); :meth:`rollover` hot-swaps a new version (pack and
warm off the serving thread, optional shadow scoring, one atomic swap).

Not ported yet: the serving fleet (``serve_devices > 1``, ``BulkScorer``)
waits for ROADMAP Queue A item 9; the metrics exporter (``metrics_port``),
``trace_out``, the SLO plane, the cost ledger, the drift monitor and
rollover from a resilience checkpoint wait for item 10. Asking for any of
them raises ``NotImplementedError``; their defaults arm nothing, and
:meth:`stats` has no keys for them.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from ..config import param_default
from ..obs import Telemetry, reqtrace
from .admission import AdmissionController
from .batcher import MicroBatcher
from .errors import RetryPolicy
from .residency import ResidencyManager

_ITEM_9 = "ROADMAP Queue A item 9 (the serving fleet)"
_ITEM_10 = "ROADMAP Queue A item 10 (observability and resilience)"


def _as_booster(spec, device_type: str):
    from ..basic import Booster
    if isinstance(spec, Booster):
        return spec
    if isinstance(spec, (str, os.PathLike)):
        text = str(spec)
        params = {"device_type": device_type}
        if os.path.isdir(text):
            raise NotImplementedError(
                f"serving from a resilience checkpoint directory ({text}) "
                f"waits for {_ITEM_10}")
        if os.path.exists(text):
            return Booster(params=params, model_file=text)
        if text.startswith("tree\n") or "\ntree\n" in text[:200]:
            return Booster(params=params, model_str=text)
        raise FileNotFoundError(f"model file not found: {text}")
    raise TypeError(f"cannot serve {type(spec).__name__}; expected "
                    "Booster, model-file path or model string")


def _refuse_unported(serve_devices, metrics_port, trace_out, cost_ledger,
                     drift, slo_enabled, slo_config, slo_readyz_gating,
                     slo_tick_period_s) -> int:
    """The planes this port has not yet: raise for any that is asked for;
    returns the resolved device count (1)."""
    import torch
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    nd = int(serve_devices or 0)
    nd = max(1, min(local if nd <= 0 else nd, max(local, 1)))
    if nd > 1:
        raise NotImplementedError(
            f"serve_devices resolves to {nd} devices: serving on more than "
            f"one card waits for {_ITEM_9}; pass serve_devices=1")
    asked = [name for name, on in (
        ("metrics_port", int(metrics_port or 0) > 0),
        ("trace_out", bool(trace_out)),
        ("cost_ledger", cost_ledger not in (None, "off")),
        ("the drift monitor", drift),
        ("slo_enabled", bool(slo_enabled) or bool(slo_readyz_gating)
         or slo_tick_period_s is not None),
        ("slo_config", bool(slo_config))) if on]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: not ported yet; waits for {_ITEM_10}")
    return nd


class PredictionService:
    """Micro-batched, multi-model, device-resident prediction server."""

    def __init__(self,
                 boosters_or_paths: Union[Dict[str, Any], List[Any], Any],
                 max_batch_rows: int = 8192,
                 max_delay_ms: float = 2.0,
                 min_bucket_rows: int = 64,
                 device_budget_bytes: Optional[int] = None,
                 raw_score: bool = False,
                 num_iteration: Optional[int] = None,
                 telemetry_out: str = "",
                 batch_events: bool = True,
                 metrics_port: int = 0,
                 trace_out: str = "",
                 memory_watermarks: bool = True,
                 max_queue_rows: Optional[int] = None,
                 max_queue_requests: Optional[int] = None,
                 default_deadline_ms: Optional[float] = None,
                 target_p99_ms: Optional[float] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 cost_ledger: Optional[str] = None,
                 drift_enabled: Optional[bool] = None,
                 drift_psi_threshold: Optional[float] = None,
                 drift_eval_rows: Optional[int] = None,
                 drift_hysteresis: Optional[int] = None,
                 serve_devices: Optional[int] = None,
                 slo_enabled: Optional[bool] = None,
                 slo_config: Optional[str] = None,
                 slo_tick_period_s: Optional[float] = None,
                 slo_readyz_gating: Optional[bool] = None,
                 device_type: str = "cuda"):
        if isinstance(boosters_or_paths, dict):
            specs = dict(boosters_or_paths)
        elif isinstance(boosters_or_paths, (list, tuple)):
            specs = {str(i): s for i, s in enumerate(boosters_or_paths)}
        else:
            specs = {"default": boosters_or_paths}
        if not specs:
            raise ValueError("PredictionService needs at least one model")
        if serve_devices is None:
            serve_devices = param_default("serve_devices")
        drift = bool(drift_enabled) or any(
            v is not None for v in (drift_psi_threshold, drift_eval_rows,
                                    drift_hysteresis))
        self.n_devices = _refuse_unported(
            serve_devices, metrics_port, trace_out, cost_ledger, drift,
            slo_enabled, slo_config, slo_readyz_gating, slo_tick_period_s)
        # admission-control knobs default from the config registry; all 0
        # is off
        if max_queue_rows is None:
            max_queue_rows = param_default("serve_max_queue_rows")
        if max_queue_requests is None:
            max_queue_requests = param_default("serve_max_queue_requests")
        if default_deadline_ms is None:
            default_deadline_ms = param_default("serve_default_deadline_ms")
        if target_p99_ms is None:
            target_p99_ms = param_default("serve_target_p99_ms")
        self.retry_policy = retry_policy
        self.device_type = str(device_type)
        self.raw_score = bool(raw_score)
        self.tel = Telemetry(enabled=True)
        if telemetry_out:
            self.tel.enable(telemetry_out)
        self._closed = False
        self._warmed = False
        self._rollover_swapping = False
        self._rollover_lock = threading.Lock()
        self._shadow: Dict[str, Dict[str, Any]] = {}
        self.residency = ResidencyManager(
            budget_bytes=device_budget_bytes, telemetry=self.tel,
            max_batch_rows=max_batch_rows,
            min_bucket_rows=min_bucket_rows,
            num_iteration=num_iteration)
        for mid, spec in specs.items():
            self.residency.register(str(mid),
                                    _as_booster(spec, self.device_type))
        self.batcher = MicroBatcher(
            self._dispatch_batch, max_batch_rows=max_batch_rows,
            max_delay_ms=max_delay_ms, telemetry=self.tel,
            batch_events=batch_events,
            memory_watermarks=memory_watermarks,
            max_queue_rows=int(max_queue_rows or 0),
            max_queue_requests=int(max_queue_requests or 0),
            default_deadline_ms=float(default_deadline_ms or 0.0))
        # adaptive admission: armed only by a nonzero p99 target; runs on
        # the worker thread through the post-batch hook
        self.admission: Optional[AdmissionController] = None
        if float(target_p99_ms or 0.0) > 0:
            self.admission = AdmissionController(
                self.batcher, self.tel, float(target_p99_ms))
            self.batcher.on_batch_done = self.admission.step
        self.tel.event("serve_start", models=list(specs),
                       max_batch_rows=int(max_batch_rows),
                       max_delay_ms=float(max_delay_ms),
                       budget_bytes=device_budget_bytes,
                       max_queue_rows=int(max_queue_rows or 0),
                       max_queue_requests=int(max_queue_requests or 0),
                       default_deadline_ms=float(default_deadline_ms
                                                 or 0.0),
                       target_p99_ms=float(target_p99_ms or 0.0),
                       devices=self.n_devices)

    # ------------------------------------------------------------------
    def _readiness(self) -> Tuple[bool, str]:
        """The readiness probe: ready only once ``warmup()`` ran, unready
        during a rollover swap and after close (load balancers drain on
        it)."""
        if self._closed:
            return False, "closed"
        if getattr(self.batcher, "_wedged", False):
            return False, "worker_wedged"
        if self._rollover_swapping:
            return False, "rollover_swap"
        if not self._warmed:
            return False, "warmup_pending"
        return True, "ready"

    def _dispatch_batch(self, model_id: str, X) -> np.ndarray:
        eng = self.residency.get(model_id)
        out = eng.predict(X, raw_score=self.raw_score)
        st = self._shadow.get(model_id)
        if st is not None and st["remaining"] > 0:
            self._score_shadow(st, model_id, X, out)
        return out

    def _score_shadow(self, st: Dict[str, Any], model_id: str, X,
                      out: np.ndarray) -> None:
        """Score a rollover candidate on mirrored live traffic and report
        the divergence, on the worker thread after the live response; a
        shadow failure never fails live traffic."""
        try:
            reqtrace.begin_shadow()
            try:
                sout = st["engine"].predict(X, raw_score=self.raw_score)
            finally:
                reqtrace.end_shadow()
            div = 0.0
            if np.asarray(out).size:
                div = float(np.max(np.abs(
                    np.asarray(sout, np.float64)
                    - np.asarray(out, np.float64))))
            st["max_divergence"] = max(st["max_divergence"], div)
            st["requests"] += 1
            st["remaining"] -= 1
            reqtrace.annotate(shadow_divergence=round(div, 9))
            self.tel.gauge("serve.shadow_divergence", div)
            self.tel.event("serve_shadow", model_id=model_id,
                           divergence=round(div, 9),
                           remaining=int(st["remaining"]),
                           candidate_hash=st["engine"].model_hash[:16])
            if st["remaining"] <= 0:
                st["done"].set()
        except Exception as e:
            st["error"] = repr(e)
            st["done"].set()

    # ------------------------------------------------------------------
    def model_ids(self) -> List[str]:
        return self.residency.model_ids()

    def submit(self, model_id: str, X,
               deadline_ms: Optional[float] = None) -> Future:
        """Future form: enqueue and return at once. The future carries
        ``future.trace_id``, the request's identity in its
        ``serve_access`` record. ``deadline_ms`` overrides the service's
        default: a request still queued past it is shed before dispatch
        with ``ServeDeadlineExceeded``. Raises ``ServeRejected`` when
        admission control refuses the request."""
        if self._closed:
            raise RuntimeError("PredictionService is closed")
        model_id = str(model_id)
        if not self.residency.has(model_id):
            raise KeyError(f"unknown model_id: {model_id!r}")
        return self.batcher.submit(model_id, X, deadline_ms=deadline_ms)

    def predict(self, model_id: str, X,
                timeout: Optional[float] = None,
                deadline_ms: Optional[float] = None,
                retry: Optional[RetryPolicy] = None) -> np.ndarray:
        """Sync form: ``submit`` and wait for the micro-batched result;
        with a :class:`RetryPolicy` (here or service-wide), shed or
        rejected requests are resubmitted under capped exponential
        backoff; compute errors surface at once."""
        policy = self.retry_policy if retry is None else retry

        def _once():
            return self.submit(model_id, X,
                               deadline_ms=deadline_ms).result(
                                   timeout=timeout)
        if policy is None:
            return _once()
        return policy.call(_once, telemetry=self.tel)

    def predict_bulk(self, model_id: str, X,
                     raw_score: Optional[bool] = None) -> np.ndarray:
        """Offline scoring of a large batch, bypassing the micro-batch
        queue: with one card, the engine's path (bucketed chunks), as the
        JAX package takes it with one device."""
        if self._closed:
            raise RuntimeError("PredictionService is closed")
        model_id = str(model_id)
        if not self.residency.has(model_id):
            raise KeyError(f"unknown model_id: {model_id!r}")
        rs = self.raw_score if raw_score is None else bool(raw_score)
        return self.residency.get(model_id).predict(X, raw_score=rs)

    def warmup(self, buckets: Optional[List[int]] = None,
               model_ids: Optional[List[str]] = None) -> Dict[str, Any]:
        """Pack every model (or ``model_ids``) and dispatch each bucket
        size (or ``buckets``) once: afterwards steady serving counts no
        compile, and the readiness probe reports ready."""
        out = {str(mid): self.residency.get(str(mid)).warmup(buckets)
               for mid in (model_ids or self.model_ids())}
        self._warmed = True
        return out

    def refresh(self, model_id: str) -> None:
        """Re-pack a model whose live booster trained further since its
        engine was built (engines pack a snapshot)."""
        self.residency.evict(str(model_id))
        self.residency.get(str(model_id))

    # ------------------------------------------------------- rollover
    def rollover(self, model_id: str, new_source,
                 warm: bool = True,
                 shadow_requests: int = 0,
                 shadow_timeout_s: float = 30.0,
                 shadow_abort_threshold: Optional[float] = None
                 ) -> Dict[str, Any]:
        """Zero-downtime rollover: load a candidate (booster, model file
        or model string), pack and warm it off the serving thread,
        optionally score it on ``shadow_requests`` mirrored micro-batches
        (``serve_shadow`` events; with ``shadow_abort_threshold`` the
        rollover is aborted, the old model serving on, when the divergence
        exceeds it or the shadow does not complete in
        ``shadow_timeout_s``), then promote it in one atomic swap. Returns
        a report: ``promoted``, ``old_hash``/``new_hash``, ``shadow``."""
        if self._closed:
            raise RuntimeError("PredictionService is closed")
        model_id = str(model_id)
        if not self.residency.has(model_id):
            raise KeyError(f"unknown model_id: {model_id!r}")
        with self._rollover_lock:
            booster = _as_booster(new_source, self.device_type)
            old_hash = self.residency.get(model_id).model_hash
            cand = self.residency.build_candidate(model_id, booster)
            if warm:
                cand.warmup()
            report: Dict[str, Any] = {
                "model_id": model_id, "promoted": False,
                "old_hash": old_hash[:16],
                "new_hash": cand.model_hash[:16], "shadow": None}
            source_kind = "file" if isinstance(
                new_source, (str, os.PathLike)) \
                else type(new_source).__name__
            if int(shadow_requests) > 0:
                st = {"engine": cand, "remaining": int(shadow_requests),
                      "requests": 0, "max_divergence": 0.0,
                      "done": threading.Event()}
                self._shadow[model_id] = st
                completed = st["done"].wait(float(shadow_timeout_s))
                self._shadow.pop(model_id, None)
                shadow_rep = {
                    "requests": int(st["requests"]),
                    "max_divergence": float(st["max_divergence"]),
                    "completed": bool(completed and "error" not in st)}
                if "error" in st:
                    shadow_rep["error"] = st["error"]
                report["shadow"] = shadow_rep
                if shadow_abort_threshold is not None and (
                        not shadow_rep["completed"]
                        or shadow_rep["max_divergence"]
                        > float(shadow_abort_threshold)):
                    self.tel.inc("serve.rollover_aborts")
                    self.tel.event(
                        "serve_rollover_aborted", model_id=model_id,
                        old_hash=old_hash[:16],
                        new_hash=cand.model_hash[:16],
                        **{f"shadow_{k}": v for k, v in shadow_rep.items()})
                    return report
            # the swap window: the readiness probe reports unready
            self._rollover_swapping = True
            try:
                self.residency.swap(model_id, booster, cand)
            finally:
                self._rollover_swapping = False
            self.tel.inc("serve.rollovers")
            self.tel.event("serve_rollover", model_id=model_id,
                           old_hash=old_hash[:16],
                           new_hash=cand.model_hash[:16],
                           source=source_kind, warmed=bool(warm),
                           devices=self.n_devices,
                           shadow=report["shadow"])
            report["promoted"] = True
            return report

    def pin(self, model_id: str) -> None:
        self.residency.pin(str(model_id))

    def unpin(self, model_id: str) -> None:
        self.residency.unpin(str(model_id))

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Operator view: request, batch, dispatch and compile counters,
        the latency and batch-size distributions (p50/p95/p99), admission
        and residency state. ``dispatches_per_request`` and
        ``compiles_per_1k_requests`` leave warmup out."""
        snap = self.tel.snapshot()
        c = snap.get("counters", {})
        g = snap.get("gauges", {})
        requests = int(c.get("serve.requests", 0))
        out: Dict[str, Any] = {
            "requests": requests,
            "rows": int(c.get("serve.rows", 0)),
            "batches": int(c.get("serve.batches", 0)),
            "dispatches": int(c.get("serve.dispatches", 0)),
            "compiles": int(c.get("serve.compiles", 0)),
            "warmup_dispatches": int(c.get("serve.warmup_dispatches", 0)),
            "warmup_compiles": int(c.get("serve.warmup_compiles", 0)),
            "evictions": int(c.get("serve.evictions", 0)),
            "rebuilds": int(c.get("serve.rebuilds", 0)),
            "degradations": int(c.get("serve.degradations", 0)),
            "host_rows": int(c.get("serve.host_rows", 0)),
            "rejected": int(c.get("serve.rejected", 0)),
            "shed": int(c.get("serve.shed", 0)),
            "retries": int(c.get("serve.retries", 0)),
            "rollovers": int(c.get("serve.rollovers", 0)),
            "queue_depth": g.get("serve.queue_depth", 0),
            "queue_peak_requests": g.get("serve.queue_peak_requests", 0),
            "latency_ms": snap.get("dists", {}).get("serve.latency_ms"),
            "batch_rows": snap.get("dists", {}).get("serve.batch_rows"),
            "residency": self.residency.stats(),
        }
        if self.admission is not None:
            out["admission"] = self.admission.stats()
        if requests > 0:
            out["dispatches_per_request"] = round(
                max(0, out["dispatches"] - out["warmup_dispatches"])
                / requests, 6)
            out["compiles_per_1k_requests"] = round(
                max(0, out["compiles"] - out["warmup_compiles"])
                * 1000.0 / requests, 6)
        return out

    # ------------------------------------------------------------------
    def close(self, drain: bool = True,
              drain_timeout_s: Optional[float] = None) -> None:
        """Stop the worker (serving what is queued first when ``drain``,
        bounded by ``drain_timeout_s``; past it the rest is shed with
        structured errors), emit the final ``serve_stats`` event and
        flush."""
        if self._closed:
            return
        self._closed = True
        self.batcher.close(drain=drain, drain_timeout_s=drain_timeout_s)
        final = self.stats()
        final.pop("residency", None)
        final.pop("admission", None)
        self.tel.event("serve_stats", **final)
        self.tel.close()

    def __enter__(self) -> "PredictionService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
