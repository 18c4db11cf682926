"""Request-scoped serving traces.

Started as a copy of ``lightgbm_tpu/obs/reqtrace.py`` (which imports no
JAX; the port keeps its own); the records here also carry the serving
engine's dispatch parts (:data:`DISPATCH_PARTS`). A serving request is invisible between
``PredictionService.submit()`` and its future resolving: the batcher
coalesces it, the engine buckets and dispatches it, and nothing ties the
pieces back to THE request an operator is debugging.  This module
supplies the thread of identity:

- :func:`mint_trace_id` — 16-hex-char id stamped on the request at
  ``submit()`` (also exposed as ``future.trace_id`` so callers can
  quote it in their own logs);
- a worker-thread batch context (:func:`begin_batch` /
  :func:`annotate` / :func:`end_batch`) the engine annotates from
  INSIDE the dispatch (bucket size, device dispatch wall,
  compile-on-this-call, host-walk degradation) without the batcher and
  engine knowing each other's internals;
- :func:`emit_access` — exactly one structured ``serve_access`` JSONL
  record per request (trace_id, model_id, rows, queue_ms, batch_ms,
  dispatch_ms, bucket, degraded, and the dispatch's parts); the JAX package's Perfetto span beside
  it waits for ``trace_out`` (ROADMAP Queue A item 10).

The batch context is a plain thread-local: the micro-batcher owns ONE
worker thread, and the engine's dispatch runs inside it — no locking,
and a second service in the same process gets its own worker and its
own context.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

_tls = threading.local()

# the serving engine's dispatch parts (serve/engine.py ``_dispatch``), in
# ms, summed over a batch's dispatches and carried by its serve_access
# records: host encode, staging into the pinned buffer, the host's wait for
# the card; on the card the copy in, the kernel and the copy back
DISPATCH_PARTS = ("encode_ms", "stage_ms", "device_ms", "copy_in_ms",
                  "kernel_ms", "copy_out_ms")
_SUMMED = ("dispatch_ms", "dispatches", "compiles") + DISPATCH_PARTS


def mint_trace_id() -> str:
    """16 hex chars of OS entropy — unique per request, short enough to
    grep."""
    return os.urandom(8).hex()


# ------------------------------------------------------- batch context
def begin_batch(model_id: str,
                device: Optional[int] = None) -> Dict[str, Any]:
    ctx = {"model_id": str(model_id), "bucket": None,
           "dispatch_ms": 0.0, "dispatches": 0, "compiles": 0,
           "degraded": False, "model_version": None,
           # fleet lane index (None on a single-device batcher): which
           # device replica served this batch — the serve_access field
           # the fleet: summary's per-device request share reads
           "device": device}
    _tls.batch = ctx
    return ctx


def current() -> Optional[Dict[str, Any]]:
    return getattr(_tls, "batch", None)


def begin_shadow() -> None:
    """Suppress annotate() while a rollover candidate scores mirrored
    traffic on the worker thread: the shadow engine's dispatch facts
    (dispatch_ms, bucket, model_version) must not overwrite the LIVE
    request's context — the live response came from the serving
    engine, and its trace must say so."""
    _tls.shadow = True


def end_shadow() -> None:
    _tls.shadow = False


def annotate(**attrs: Any) -> None:
    """Merge engine-side facts into the open batch context (no-op when
    no batch is open — the engine also serves ``Booster.predict`` style
    direct calls that carry no request identity — or while a shadow
    engine is scoring mirrored traffic)."""
    if getattr(_tls, "shadow", False):
        return
    ctx = current()
    if ctx is None:
        return
    for k, v in attrs.items():
        if k in _SUMMED:
            ctx[k] = ctx.get(k, 0) + v      # accumulate across chunks
        else:
            ctx[k] = v


def end_batch() -> Dict[str, Any]:
    ctx = current() or {}
    _tls.batch = None
    return ctx


# ------------------------------------------------------------ emission
def emit_access(tel, req, ctx: Dict[str, Any], queue_ms: float,
                batch_ms: float) -> None:
    """One ``serve_access`` record for one finished request.  ``req`` is
    the batcher's request (trace_id, model_id, rows); ``ctx`` is the
    engine-annotated batch context shared by the request's batch."""
    if tel is None or not tel.enabled:
        return
    bucket = ctx.get("bucket")
    degraded = bool(ctx.get("degraded", False))
    dispatch_ms = round(float(ctx.get("dispatch_ms", 0.0)), 3)
    extra = {}
    if ctx.get("error"):
        extra["error"] = str(ctx["error"])   # failed requests trace too
    if ctx.get("model_version"):
        # rollover attribution: which packed model state produced THIS
        # response (the rollover-under-load test's exactly-one-version
        # contract reads this field)
        extra["model_version"] = str(ctx["model_version"])
    if ctx.get("shadow_divergence") is not None:
        extra["shadow_divergence"] = float(ctx["shadow_divergence"])
    if ctx.get("device") is not None:
        extra["device"] = int(ctx["device"])
    for k in DISPATCH_PARTS:
        if k in ctx:
            extra[k] = round(float(ctx[k]), 4)
    tel.inc("serve.access_records")
    tel.event("serve_access", trace_id=req.trace_id,
              model_id=req.model_id, rows=int(req.rows),
              queue_ms=round(float(queue_ms), 3),
              batch_ms=round(float(batch_ms), 3),
              dispatch_ms=dispatch_ms,
              bucket=None if bucket is None else int(bucket),
              degraded=degraded, **extra)
