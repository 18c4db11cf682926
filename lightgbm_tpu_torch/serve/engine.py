"""Serving engine: one booster packed once, dispatched many times.

PyTorch counterpart of ``lightgbm_tpu/serve/engine.py``. It wraps the
stacked-tree predictors (``models/predictor.py``) with what serving needs:

- **row-count bucketing** — request rows are zero-padded up to a
  power-of-two bucket in ``[min_bucket_rows, max_batch_rows]`` and the
  result sliced back, so after :meth:`ServingEngine.warmup` every request
  size reuses a warmed bucket;
- **deterministic counters** — a "compile" is the first dispatch of a
  signature (variant, k, ``max_steps``, the encoded rows' width and
  dtype, the device and lane, the stacks' shapes, the bucket) in a
  process-wide registry, as the JAX package counts its jit cache;
  ``dispatches`` counts device calls. Warmup runs every bucket once, so
  steady traffic counts 0 compiles and 1 dispatch per request that fits
  one bucket;
- **placement** — the packed stacks live on the card from construction
  on. A dispatch encodes the rows on the host into the bucket's pinned
  buffer, copies it into the bucket's device buffer, launches one
  ``predict_pass`` on the lane's own ``torch.cuda.Stream`` and copies the
  scores back: nothing more;
- **fleet replicas** — ``device=`` and ``device_index=`` place one
  replica of the serving fleet (lane ``device_index`` on ``device``);
  ``shared=`` names the base replica whose packing it reuses (one pack
  per model). A replica on the base's device holds the base's very
  tensors (``Tensor.to`` of a tensor already there returns it) and is
  charged nothing; one on another card holds copies and is charged them;
- **degradation** — only for the packer's reasons (linear trees, a
  categorical vocabulary past the raw variant's cap, ...): the model
  serves through the exact float64 walk (``basic.host_walk_raw``) with a
  ``serve_degradation`` event and the ``serve.degradations`` counter. A
  kernel that fails to build or launch is not degradation: it raises, and
  the batcher resolves the error into the batch's futures.

File-loaded boosters (no training BinMappers) pack through
:class:`RawDevicePredictor`: thresholds pre-rounded so float32 inputs
route as the float64 walk does.
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.predictor import (DevicePredictor, RawDevicePredictor,
                                _round_up_pow2)
from ..obs import reqtrace
from ..ops.predict import predict_pass

# process-wide registry of dispatched signatures: a second model with the
# same packed shapes, or an engine rebuilt after an eviction, counts no
# new compile
_COMPILED_SIGS = set()
_SIG_LOCK = threading.Lock()
# one CUDA stream per dispatch lane: a fleet's lanes on one card each
# have their own
_LANE_STREAMS: Dict[Tuple[int, int], "torch.cuda.Stream"] = {}
_STREAM_LOCK = threading.Lock()


def lane_stream(device: torch.device,
                lane: int = 0) -> "torch.cuda.Stream":
    """The CUDA stream of dispatch lane ``lane`` on ``device``."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _STREAM_LOCK:
        s = _LANE_STREAMS.get((index, lane))
        if s is None:
            s = _LANE_STREAMS[(index, lane)] = torch.cuda.Stream(
                device=index)
        return s


def _storage_key(t: torch.Tensor) -> Tuple[str, int]:
    return str(t.device), t.untyped_storage().data_ptr()


def storage_nbytes(tensors, exclude=()) -> int:
    """Bytes of the distinct storages behind ``tensors`` (None skipped),
    leaving out those behind ``exclude``: what the tensors keep alive
    beyond the excluded ones (views share their base's storage)."""
    seen = {_storage_key(t) for t in exclude if t is not None}
    total = 0
    for t in tensors:
        if t is None:
            continue
        key = _storage_key(t)
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def model_state_hash(models) -> str:
    """SHA-256 over every tree's leaf values and split parameters in
    model order: the identity of one packed model state (the JAX
    package's ``obs.health.model_state_hash``)."""
    h = hashlib.sha256()
    for t in models:
        for arr, dt in ((t.leaf_value, np.float64),
                        (t.split_feature, np.int32),
                        (t.threshold, np.float64),
                        (t.threshold_bin, np.int32),
                        (t.decision_type, np.int32)):
            h.update(np.ascontiguousarray(
                np.asarray(arr, dtype=dt)).tobytes())
    return h.hexdigest()


# the engine's counters that a fleet replica also counts per lane, as
# ``serve.d<i>.<name>``
_PER_LANE = ("serve.dispatches", "serve.compiles",
             "serve.warmup_dispatches", "serve.warmup_compiles")


def _is_sparse(X) -> bool:
    from ..basic import _is_scipy_sparse
    return _is_scipy_sparse(X)


class ServingEngine:
    """Device-resident predictor for one booster state."""

    def __init__(self, booster, model_id: str = "default",
                 telemetry=None, max_batch_rows: int = 8192,
                 min_bucket_rows: int = 64, start_iteration: int = 0,
                 num_iteration: Optional[int] = None,
                 device=None, device_index: int = 0,
                 shared: Optional["ServingEngine"] = None):
        self.booster = booster
        self.model_id = model_id
        self.tel = telemetry
        # fleet placement: ``device`` holds this replica's operands and
        # takes its dispatches, on lane ``device_index``'s stream;
        # ``shared`` is the base replica whose packing this one reuses.
        # Both None: the single-device engine, as before the fleet
        self.device = booster._predict_device() if device is None \
            else torch.device(device)
        self.device_index = int(device_index)
        self._dtag = None if device is None else f"d{self.device_index}"
        self._owns_pred = shared is None
        self.model_hash = shared.model_hash if shared is not None \
            else model_state_hash(booster.models)
        self.k = max(1, booster.num_tree_per_iteration)
        total_iter = len(booster.models) // self.k
        if num_iteration is None:
            num_iteration = (booster.best_iteration
                             if booster.best_iteration > 0 else -1)
        if num_iteration <= 0:
            num_iteration = total_iter - start_iteration
        num_iteration = max(0, min(num_iteration,
                                   total_iter - start_iteration))
        self.lo = start_iteration * self.k
        self.hi = (start_iteration + num_iteration) * self.k
        self.num_iteration = num_iteration

        self.max_bucket = _round_up_pow2(max(2, int(max_batch_rows)))
        self.min_bucket = min(_round_up_pow2(max(2, int(min_bucket_rows))),
                              self.max_bucket)
        self.dispatches = 0
        self.compiles = 0
        self.host_rows = 0
        self._lock = threading.Lock()
        # the bucket buffers are reused: one dispatch at a time
        self._dispatch_lock = threading.Lock()
        self._buffers: Dict[int, tuple] = {}
        self._events: Optional[List["torch.cuda.Event"]] = None
        self._resident_nbytes = 0

        if shared is not None:
            self.variant = shared.variant
            self.pred = shared.pred
            self.device_ok = self.pred is not None and num_iteration > 0
            self.degraded_reason = "" if self.device_ok else \
                (shared.degraded_reason or "no_trees")
        else:
            ts = getattr(booster, "train_set", None)
            if ts is not None and getattr(ts, "_inner", None) is not None:
                self.variant = "binned"
                self.pred = DevicePredictor(booster.models, ts._inner,
                                            self.k)
            else:
                self.variant = "raw"
                self.pred = RawDevicePredictor(
                    booster.models, booster.max_feature_idx + 1, self.k,
                    device=self.device)
            self.device_ok = bool(self.pred.ok) and num_iteration > 0
            self.degraded_reason = "" if self.device_ok else \
                (self.pred.reason or "no_trees")
        if not self.device_ok:
            self.pred = None
            if shared is None:
                self._event("serve_degradation", model_id=model_id,
                            reason=self.degraded_reason)
                self._inc("serve.degradations")
        else:
            # [lo, hi) is fixed for the engine's life: its operands (views
            # of the packed stack, on this replica's device) and tids once
            if shared is not None and shared.pred is not None \
                    and (shared.lo, shared.hi) == (self.lo, self.hi):
                ops, tids = shared._ops, shared._tids
            else:
                ops, tids = self.pred.run_args(self.lo, self.hi)
            self._ops = tuple(None if a is None else a.to(self.device)
                              for a in ops)
            self._tids = tids.to(self.device)
            # bytes charged: the base replica the packing (and its tids);
            # a replica the storages it holds beyond the base's: none on
            # the base's device, its copies on another card
            owned = list(self.pred.stack.values())
            if shared is None:
                self._resident_nbytes = self.pred.packed_nbytes \
                    + storage_nbytes(self._ops + (self._tids,), owned)
            else:
                self._resident_nbytes = storage_nbytes(
                    self._ops + (self._tids,),
                    owned + list(shared._ops) + [shared._tids])
            if self.device.type == "cuda":
                # the lane's stream reads what the packing stream wrote
                lane_stream(self.device, self.device_index).wait_stream(
                    torch.cuda.current_stream(self.device))
            self._sig_base = (
                self.pred.variant, self.k, self.pred.max_steps,
                self.pred.enc_width, self.pred.enc_dtype, str(self.device),
                # each lane dispatches its own signatures, as the JAX
                # package's committed placements fork executables per
                # device: a replica's warmup counts its own compiles
                self.device_index,
                tuple(None if a is None
                      else (tuple(a.shape), str(a.dtype))
                      for a in self._ops))
        self._event("serve_model_loaded", model_id=model_id,
                    variant=self.variant, device=self.device_ok,
                    trees=self.hi - self.lo, bytes=self.packed_nbytes,
                    **({} if self._dtag is None
                       else {"device_index": self.device_index}))

    # ------------------------------------------------------- telemetry
    def _inc(self, name: str, v: float = 1) -> None:
        if self.tel is not None:
            self.tel.inc(name, v)
            if self._dtag is not None and name in _PER_LANE:
                self.tel.inc(f"serve.{self._dtag}.{name[6:]}", v)

    def _event(self, name: str, **attrs: Any) -> None:
        if self.tel is not None:
            self.tel.event(name, **attrs)

    # ------------------------------------------------------------------
    @property
    def packed_nbytes(self) -> int:
        """Device bytes this engine keeps alive (the residency manager's
        accounting unit): the base replica's packing and the operands it
        holds beyond it, a replica's copies on another card; the bucket
        buffers, a few bucket x F words each, are left out as the JAX
        package leaves its request buffers out."""
        return 0 if self.pred is None else self._resident_nbytes

    def buckets(self) -> List[int]:
        """All power-of-two bucket sizes this engine pads into."""
        out, b = [], self.min_bucket
        while b < self.max_bucket:
            out.append(b)
            b <<= 1
        out.append(self.max_bucket)
        return out

    def bucket_for(self, rows: int) -> int:
        return min(self.max_bucket,
                   max(self.min_bucket, _round_up_pow2(max(2, rows))))

    def _signature(self, bucket: int):
        return self._sig_base + (bucket,)

    # ------------------------------------------------------------------
    def warmup(self, buckets: Optional[List[int]] = None) -> Dict[str, Any]:
        """Dispatch a zero batch at every ``buckets`` size (default: all
        of :meth:`buckets`): each signature's first dispatch (its
        "compile") and its buffers happen here, not on a request."""
        if not self.device_ok:
            return {"warmed": [], "compiles": 0, "degraded": True}
        compiles_before, dispatches_before = self.compiles, self.dispatches
        warmed = []
        for b in sorted(set(buckets or self.buckets())):
            b = self.bucket_for(b)
            if b in warmed:
                continue
            self._dispatch(np.zeros((1, self.booster.max_feature_idx + 1),
                                    np.float32), b)
            warmed.append(b)
        n = self.compiles - compiles_before
        # counted apart so steady-state rates leave warmup out
        self._inc("serve.warmup_compiles", n)
        self._inc("serve.warmup_dispatches",
                  self.dispatches - dispatches_before)
        self._event("serve_warmup", model_id=self.model_id,
                    buckets=warmed, compiles=n,
                    **({} if self._dtag is None
                       else {"device_index": self.device_index}))
        return {"warmed": warmed, "compiles": n, "degraded": False}

    def _bucket_buffers(self, bucket: int):
        """(host staging [bucket, F], device input [bucket, F], host output
        [k, bucket]) of one bucket; pinned host memory on the card."""
        bufs = self._buffers.get(bucket)
        if bufs is None:
            dt = torch.int32 if self.pred.enc_dtype == "int32" \
                else torch.float32
            shape = (bucket, self.pred.enc_width)
            pin = self.device.type == "cuda"
            host_in = torch.zeros(shape, dtype=dt, pin_memory=pin)
            dev_in = host_in
            if pin:
                # every dispatch copies the whole bucket in, so no fill;
                # allocated on the lane's stream, which alone uses it
                with torch.cuda.stream(lane_stream(self.device,
                                                   self.device_index)):
                    dev_in = torch.empty(shape, dtype=dt,
                                         device=self.device)
            host_out = torch.zeros((self.k, bucket), dtype=torch.float32,
                                   pin_memory=pin)
            bufs = self._buffers[bucket] = (host_in, dev_in, host_out)
        return bufs

    def _timing_events(self) -> List["torch.cuda.Event"]:
        """Four CUDA events around the copy in, the kernel and the copy
        back, made once and reused: the dispatch lock makes them one
        dispatch's alone."""
        if self._events is None:
            self._events = [torch.cuda.Event(enable_timing=True)
                            for _ in range(4)]
        return self._events

    def _dispatch(self, Xc: np.ndarray, bucket: int) -> np.ndarray:
        """Scores [k, rows] float32 of up to ``bucket`` raw rows: encode on
        the host into the bucket's buffer (zero padding), copy it to the
        card, one ``predict_pass`` on the lane's stream, copy back. With
        telemetry on, the parts' times (``reqtrace.DISPATCH_PARTS``: host
        clock for the encode, the staging and the wait for the card, CUDA
        events on the lane's stream for the copies and the kernel) go to
        the ``serve.dispatch.*`` distributions and to the request's
        ``serve_access`` record."""
        sig = self._signature(bucket)
        with _SIG_LOCK:
            fresh = sig not in _COMPILED_SIGS
        timed = self.tel is not None and self.tel.enabled
        t0 = time.perf_counter()
        rows = Xc.shape[0]
        enc = self.pred.encode(Xc)
        t1 = time.perf_counter()
        with self._dispatch_lock:
            host_in, dev_in, host_out = self._bucket_buffers(bucket)
            staged = host_in.numpy()
            staged[:rows] = enc
            staged[rows:] = 0
            t2 = time.perf_counter()
            ev = None
            if self.device.type == "cuda":
                stream = lane_stream(self.device, self.device_index)
                ev = self._timing_events() if timed else None
                with torch.cuda.stream(stream):
                    if ev is not None:
                        ev[0].record()
                    dev_in.copy_(host_in, non_blocking=True)
                    if ev is not None:
                        ev[1].record()
                    out = predict_pass(dev_in, self._ops, self._tids,
                                       self.k, self.pred.max_steps,
                                       self.variant)
                    if ev is not None:
                        ev[2].record()
                    host_out.copy_(out, non_blocking=True)
                    if ev is not None:
                        ev[3].record()
                stream.synchronize()
            else:
                host_out.copy_(predict_pass(dev_in, self._ops, self._tids,
                                            self.k, self.pred.max_steps,
                                            self.variant))
            res = host_out.numpy()[:, :rows].copy()
            if timed:
                parts = {"encode_ms": (t1 - t0) * 1000.0,
                         "stage_ms": (t2 - t1) * 1000.0,
                         "device_ms": (time.perf_counter() - t2) * 1000.0}
                if ev is not None:
                    parts.update(copy_in_ms=ev[0].elapsed_time(ev[1]),
                                 kernel_ms=ev[1].elapsed_time(ev[2]),
                                 copy_out_ms=ev[2].elapsed_time(ev[3]))
        if timed:
            for name, v in parts.items():
                self.tel.dist("serve.dispatch." + name, v)
            reqtrace.annotate(**parts)
        # registered only after the call returned: a failed first dispatch
        # must not mark its signature warm
        if fresh:
            with _SIG_LOCK:
                if sig in _COMPILED_SIGS:
                    fresh = False
                else:
                    _COMPILED_SIGS.add(sig)
            if fresh:
                compile_ms = (time.perf_counter() - t0) * 1000.0
                with self._lock:
                    self.compiles += 1
                self._inc("serve.compiles")
                reqtrace.annotate(compiles=1)
                sig_hash = hashlib.sha1(repr(sig).encode()).hexdigest()[:12]
                op_bytes = self.packed_nbytes
                self._event("serve_compile", model_id=self.model_id,
                            bucket=bucket, variant=self.variant,
                            signature=sig_hash,
                            compile_ms=round(compile_ms, 3),
                            operand_bytes=op_bytes)
                if self.tel is not None:
                    self.tel.compile_executable(
                        f"serve[{self.variant},bucket={bucket},"
                        f"sig={sig_hash}]", compile_ms, op_bytes,
                        model_id=self.model_id)
        with self._lock:
            self.dispatches += 1
        self._inc("serve.dispatches")
        reqtrace.annotate(dispatches=1, bucket=bucket)
        return res

    # ------------------------------------------------------------------
    def predict_raw(self, X) -> np.ndarray:
        """Raw scores [k, n] float64 over trees [lo, hi)."""
        if not self.device_ok:
            return self._host_predict_raw(X)
        reqtrace.annotate(model_version=self.model_hash[:16])
        sparse_in = _is_sparse(X)
        if sparse_in:
            X = X.tocsr()
        n = X.shape[0]
        out = np.zeros((self.k, n), np.float64)
        for c0 in range(0, n, self.max_bucket):
            sl = slice(c0, min(n, c0 + self.max_bucket))
            Xc = X[sl].toarray() if sparse_in else X[sl]
            t0 = time.perf_counter()
            out[:, sl] = self._dispatch(Xc, self.bucket_for(Xc.shape[0]))
            disp_ms = (time.perf_counter() - t0) * 1000.0
            reqtrace.annotate(dispatch_ms=disp_ms)
            if self._dtag is not None and self.tel is not None:
                self.tel.dist(f"serve.{self._dtag}.dispatch_ms", disp_ms)
        return out

    def _host_predict_raw(self, X) -> np.ndarray:
        """Degraded path: the exact float64 walk (``basic.host_walk_raw``,
        shared with ``Booster.predict``)."""
        from ..basic import host_walk_raw
        t0 = time.perf_counter()
        reqtrace.annotate(model_version=self.model_hash[:16])
        out = host_walk_raw(self.booster.models, X, self.lo, self.hi,
                            self.k, self.device)
        n = X.shape[0]
        with self._lock:
            self.host_rows += n
        self._inc("serve.host_rows", n)
        reqtrace.annotate(degraded=True,
                          dispatch_ms=(time.perf_counter() - t0) * 1000.0)
        return out

    # ------------------------------------------------------------------
    def predict(self, X, raw_score: bool = False) -> np.ndarray:
        """Final predictions, the output contract of ``Booster.predict``
        (``basic.finalize_raw_predictions``, shared with it)."""
        from ..basic import finalize_raw_predictions
        if not _is_sparse(X) and not isinstance(X, np.ndarray):
            X = np.asarray(X, np.float64)
        if getattr(X, "ndim", 2) == 1:
            X = np.asarray(X).reshape(1, -1)
        b = self.booster
        raw = self.predict_raw(X)
        return finalize_raw_predictions(raw, self.k, b.objective,
                                        b.average_output,
                                        self.num_iteration, raw_score)

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"model_id": self.model_id, "variant": self.variant,
                    "model_hash": self.model_hash[:16],
                    "device": self.device_ok,
                    "degraded_reason": self.degraded_reason,
                    "trees": self.hi - self.lo,
                    "packed_bytes": self.packed_nbytes,
                    "compiles": self.compiles,
                    "dispatches": self.dispatches,
                    "host_rows": self.host_rows,
                    "buckets": self.buckets(),
                    **({} if self._dtag is None
                       else {"device_index": self.device_index})}
