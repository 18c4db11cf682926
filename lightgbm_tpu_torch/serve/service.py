"""PredictionService: the public serving facade.

PyTorch counterpart of ``lightgbm_tpu/serve/service.py``. It owns the
engine, micro-batcher and residency layers plus the telemetry registry::

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

The serving fleet: ``serve_devices=N`` replicates each model onto N local
devices (``cuda:0`` .. ``cuda:N-1``; 0 means all; 1, or one local device,
is the single-device plane), one dispatch lane (queue, worker thread,
CUDA stream) per replica. ``routing`` is ``"least_loaded"`` (the
``serve_routing`` default) or ``"round_robin"``; a submit its lane would
reject spills to the coldest lane first; ``rollover`` swaps every
replica at once; ``predict_bulk`` splits large batches across the lanes
(``BulkScorer``); ``stats()["fleet"]`` has the per-lane counters.
``devices=[torch.device(...), ...]`` names the lanes' devices outright,
repeats allowed: it is how the CPU tests run lanes on the CPU and how a
machine with one card runs several lanes on it, the counterpart of the
forced host device count the JAX package's fleet tests run on, not a
serving mode of its own.

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

Not ported yet: the metrics exporter (``metrics_port``), ``trace_out``,
the SLO plane, the cost ledger, the drift monitor and rollover from a
resilience checkpoint wait for ROADMAP Queue A item 10. Asking for any of
them raises ``NotImplementedError``; their defaults arm nothing, and
:meth:`stats` has no keys for them.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..config import param_default
from ..obs import Telemetry, reqtrace
from .admission import AdmissionController
from .batcher import MicroBatcher
from .errors import RetryPolicy
from .residency import ResidencyManager

_ITEM_10 = ("ROADMAP Queue A item 10f (the serving side of observability "
            "and resilience)")


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


def resolve_devices(serve_devices, device_type: str,
                    devices: Optional[Sequence] = None) -> List:
    """The lanes' devices: ``devices`` as given (repeats allowed), else
    the first ``serve_devices`` local devices (0: all of them, every card
    for ``"cuda"``, the one CPU device for ``"cpu"``), at least one."""
    import torch
    if devices is not None:
        out = [torch.device(d) for d in devices]
        if not out:
            raise ValueError("devices= names no device")
        return out
    local = [torch.device("cpu")] if str(device_type) == "cpu" else [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    local = local or [torch.device(device_type)]
    nd = int(serve_devices or 0)
    if nd <= 0:
        nd = len(local)
    return local[:max(1, min(nd, len(local)))]


def _refuse_unported(metrics_port, trace_out, cost_ledger, drift,
                     slo_enabled, slo_config, slo_readyz_gating,
                     slo_tick_period_s) -> None:
    """The planes this port has not yet: raise for any that is asked
    for."""
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
                 routing: Optional[str] = None,
                 slo_enabled: Optional[bool] = None,
                 slo_config: Optional[str] = None,
                 slo_tick_period_s: Optional[float] = None,
                 slo_readyz_gating: Optional[bool] = None,
                 device_type: str = "cuda",
                 devices: Optional[Sequence] = None):
        if isinstance(boosters_or_paths, dict):
            specs = dict(boosters_or_paths)
        elif isinstance(boosters_or_paths, (list, tuple)):
            specs = {str(i): s for i, s in enumerate(boosters_or_paths)}
        else:
            specs = {"default": boosters_or_paths}
        if not specs:
            raise ValueError("PredictionService needs at least one model")
        drift = bool(drift_enabled) or any(
            v is not None for v in (drift_psi_threshold, drift_eval_rows,
                                    drift_hysteresis))
        _refuse_unported(metrics_port, trace_out, cost_ledger, drift,
                         slo_enabled, slo_config, slo_readyz_gating,
                         slo_tick_period_s)
        # the serving fleet: one replica and one dispatch lane per device;
        # one device is the single-device plane (devices None)
        if serve_devices is None:
            serve_devices = param_default("serve_devices")
        if routing is None:
            routing = param_default("serve_routing")
        self.routing = str(routing or "least_loaded")
        lanes = resolve_devices(serve_devices, device_type, devices)
        self.n_devices = len(lanes)
        self.devices = lanes if self.n_devices > 1 else None
        # the bulk scorers over the lanes, built lazily per model
        self._bulk: Dict[str, Any] = {}
        self._bulk_lock = threading.Lock()
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
            devices=self.devices, max_batch_rows=max_batch_rows,
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
            default_deadline_ms=float(default_deadline_ms or 0.0),
            n_lanes=self.n_devices, routing=self.routing)
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
                       devices=self.n_devices, routing=self.routing)

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

    def _dispatch_batch(self, model_id: str, X,
                        device: int = 0) -> np.ndarray:
        eng = self.residency.get(model_id, device)
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
        queues: split across the lanes (:class:`~.bulk.BulkScorer`: one
        ``predict_pass`` a lane per chunk of up to ``lanes x 65,536`` rows,
        the same scores as the engine's dispatch); a model that serves
        through the float64 walk takes the engine's path."""
        if self._closed:
            raise RuntimeError("PredictionService is closed")
        model_id = str(model_id)
        if not self.residency.has(model_id):
            raise KeyError(f"unknown model_id: {model_id!r}")
        rs = self.raw_score if raw_score is None else bool(raw_score)
        eng = self.residency.get(model_id, 0)
        if not eng.device_ok:
            return eng.predict(X, raw_score=rs)
        from ..basic import _is_scipy_sparse, finalize_raw_predictions
        if not _is_scipy_sparse(X):
            # the engine's input contract (ServingEngine.predict)
            if not isinstance(X, np.ndarray):
                X = np.asarray(X, np.float64)
            if X.ndim == 1:
                X = X.reshape(1, -1)
        raw = self._bulk_scorer(model_id, eng).predict_raw(X)
        b = eng.booster
        return finalize_raw_predictions(raw, eng.k, b.objective,
                                        b.average_output,
                                        eng.num_iteration, rs)

    def _bulk_scorer(self, model_id: str, eng):
        """The cached bulk scorer of ``model_id``, built again whenever a
        resident replica changed (rollover, refresh, eviction)."""
        replicas = [eng] + [self.residency.get(model_id, d)
                            for d in range(1, self.n_devices)]
        with self._bulk_lock:
            sc = self._bulk.get(model_id)
            if sc is not None and all(
                    a is b for a, b in zip(sc.replicas, replicas)):
                return sc
            from .bulk import BulkScorer
            sc = BulkScorer(eng, replicas, telemetry=self.tel)
            self._bulk[model_id] = sc
            return sc

    def warmup(self, buckets: Optional[List[int]] = None,
               model_ids: Optional[List[str]] = None) -> Dict[str, Any]:
        """Pack every model (or ``model_ids``) and dispatch each bucket
        size (or ``buckets``) once on every lane: afterwards steady
        serving counts no compile, and the readiness probe reports
        ready. A fleet returns each model's list of per-lane reports."""
        out = {}
        for mid in (model_ids or self.model_ids()):
            mid = str(mid)
            if self.devices is None:
                out[mid] = self.residency.get(mid).warmup(buckets)
            else:
                # each lane dispatches its own signatures: an unwarmed
                # replica would count a compile on its first request
                out[mid] = [self.residency.get(mid, d).warmup(buckets)
                            for d in range(self.n_devices)]
        self._warmed = True
        return out

    def refresh(self, model_id: str) -> None:
        """Re-pack a model whose live booster trained further since its
        engines were built (engines pack a snapshot), on every lane."""
        self.residency.evict(str(model_id))
        for d in range(self.n_devices):
            self.residency.get(str(model_id), d)

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
            # pack and warm on this thread while the lanes serve the old
            # engines; a fleet builds and warms every replica before the
            # one swap, never a mixed-version fleet
            cand = self.residency.build_candidate(model_id, booster)
            replicas = cand if isinstance(cand, dict) else {0: cand}
            cand0 = replicas[0]
            if warm:
                for eng in replicas.values():
                    eng.warmup()
            report: Dict[str, Any] = {
                "model_id": model_id, "promoted": False,
                "old_hash": old_hash[:16],
                "new_hash": cand0.model_hash[:16], "shadow": None}
            source_kind = "file" if isinstance(
                new_source, (str, os.PathLike)) \
                else type(new_source).__name__
            if int(shadow_requests) > 0:
                st = {"engine": cand0, "remaining": int(shadow_requests),
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
                        new_hash=cand0.model_hash[:16],
                        **{f"shadow_{k}": v for k, v in shadow_rep.items()})
                    return report
            # the swap window: the readiness probe reports unready
            self._rollover_swapping = True
            try:
                self.residency.swap(model_id, booster, cand)
            finally:
                self._rollover_swapping = False
            with self._bulk_lock:
                # the packing changed: the bulk scorer is built again from
                # the new replicas on its next call
                self._bulk.pop(model_id, None)
            self.tel.inc("serve.rollovers")
            self.tel.event("serve_rollover", model_id=model_id,
                           old_hash=old_hash[:16],
                           new_hash=cand0.model_hash[:16],
                           source=source_kind, warmed=bool(warm),
                           devices=len(replicas),
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
        ``compiles_per_1k_requests`` leave warmup out. A fleet adds
        ``fleet``: the lanes, the routing, spills, the bulk counters and
        ``per_device``, each lane's counters and, once it took traffic,
        its two rates."""
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
        if self.devices is not None:
            out["fleet"] = self._fleet_stats(c, g)
        return out

    def _fleet_stats(self, c: Dict[str, Any],
                     g: Dict[str, Any]) -> Dict[str, Any]:
        """The fleet's view: the per-lane contract (1.0 dispatch per
        request and 0 compiles per 1,000 on every lane that took
        traffic)."""
        per = []
        for i in range(self.n_devices):
            d_req = int(c.get(f"serve.d{i}.requests", 0))
            d_disp = int(c.get(f"serve.d{i}.dispatches", 0))
            d_comp = int(c.get(f"serve.d{i}.compiles", 0))
            d_wd = int(c.get(f"serve.d{i}.warmup_dispatches", 0))
            d_wc = int(c.get(f"serve.d{i}.warmup_compiles", 0))
            ent: Dict[str, Any] = {
                "device": i, "requests": d_req,
                "rows": int(c.get(f"serve.d{i}.rows", 0)),
                "batches": int(c.get(f"serve.d{i}.batches", 0)),
                "dispatches": d_disp, "compiles": d_comp,
                "warmup_dispatches": d_wd, "warmup_compiles": d_wc,
                "spills": int(c.get(f"serve.d{i}.spills", 0)),
                "queue_depth": g.get(f"serve.d{i}.queue_depth", 0)}
            if d_req > 0:
                ent["dispatches_per_request"] = round(
                    max(0, d_disp - d_wd) / d_req, 6)
                ent["compiles_per_1k_requests"] = round(
                    max(0, d_comp - d_wc) * 1000.0 / d_req, 6)
            per.append(ent)
        return {"devices": self.n_devices, "routing": self.routing,
                "routed_devices": sum(1 for e in per if e["requests"] > 0),
                "spills": int(c.get("serve.spills", 0)),
                "bulk_rows": int(c.get("serve.bulk_rows", 0)),
                "bulk_dispatches": int(c.get("serve.bulk_dispatches", 0)),
                "bulk_compiles": int(c.get("serve.bulk_compiles", 0)),
                "per_device": per}

    # ------------------------------------------------------------------
    def close(self, drain: bool = True,
              drain_timeout_s: Optional[float] = None) -> None:
        """Stop the workers (serving what is queued first when ``drain``,
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
