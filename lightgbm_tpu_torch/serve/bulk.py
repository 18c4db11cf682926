"""Row-sharded bulk scoring over the serving fleet's lanes.

PyTorch counterpart of ``lightgbm_tpu/serve/bulk.py``. The micro-batcher's
latency path runs one lane per dispatch — right for small online
requests, wasteful for offline jobs (backfills, batch re-scoring) the
fleet could take whole. :class:`BulkScorer` splits the rows across the
lanes instead, where the JAX package ``shard_map``\\ s its traversal over
the serve mesh:

- rows are chunked to ``n_lanes x _MAX_SHARD_ROWS`` (65,536); each
  chunk gives each lane one shard of a power-of-two row count (zero
  padding past the rows), so a steady bulk stream reuses its shard
  signatures;
- each shard is one ``predict_pass`` on its lane's replica operands and
  its lane's CUDA stream (the lanes' shards are issued before any is
  waited for, so one lane's copies overlap another's kernel); the
  shards are gathered in row order. ``predict_pass`` sums each row's
  trees in tree order whatever rows share its tile, so the scores are
  the single-lane engine's, and on the card ``Booster.predict``'s, bit
  for bit;
- encoding: on the card a binned model's rows go up as float64 and are
  binned there (``binning.values_to_bins``, as ``Booster.predict`` bins
  them: the host's bins bit for bit), a raw model's as float32; on the
  CPU the host encode;
- ``serve.bulk_dispatches`` counts chunks (the JAX package's one
  ``shard_map`` call a chunk), ``serve.bulk_rows`` rows and
  ``serve.bulk_compiles`` first dispatches of a ``"bulk"``-prefixed
  signature in the engine's process-wide registry; ``ops/predict``'s
  launch counters count one launch per shard. Every call sends one
  ``serve_bulk`` event (rows, lanes, wall, rows/s).

Eligibility: a device-routable engine (``engine.device_ok``); the service
serves a degraded model through the engine's float64 walk without ever
building a scorer.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Sequence

import numpy as np
import torch

from ..binning import device_bin_tables, values_to_bins
from ..models.predictor import _round_up_pow2
from ..ops.predict import predict_pass
from .engine import _COMPILED_SIGS, _SIG_LOCK, lane_stream

# per-lane shard-rows cap (a power of two): bounds one shard's padded
# buffers; chunks beyond n_lanes x this loop
_MAX_SHARD_ROWS = 1 << 16


class BulkScorer:
    """Row-sharded scorer for one packed model over the fleet's lanes:
    ``replicas[i]`` is lane i's engine (the service's residency
    replicas)."""

    def __init__(self, engine, replicas: Sequence, telemetry=None):
        if engine.pred is None:
            raise ValueError("BulkScorer needs a device-routable engine")
        self.eng = engine
        self.pred = engine.pred
        self.k = engine.k
        self.model_hash = engine.model_hash
        self.tel = telemetry
        self.replicas = list(replicas)
        self.n_lanes = len(self.replicas)
        self.max_shard_rows = _MAX_SHARD_ROWS
        self.dispatches = 0
        self.compiles = 0
        self._bin_tables: Dict[str, object] = {}
        # the same process-wide registry the online engines count against,
        # "bulk"-prefixed so a bulk shard never aliases an online bucket
        self._sig_base = (
            "bulk", self.pred.variant, self.k, self.pred.max_steps,
            self.pred.enc_width, self.pred.enc_dtype,
            tuple((str(r.device), r.device_index) for r in self.replicas),
            tuple(None if a is None else (tuple(a.shape), str(a.dtype))
                  for a in engine._ops))

    # ------------------------------------------------------------------
    def _encode(self, Xc: np.ndarray, device: torch.device) -> torch.Tensor:
        """Encoded rows of ``Xc`` on ``device``; on the card a binned
        model's rows are binned there (on the current stream)."""
        pred = self.pred
        if device.type == "cpu":
            return torch.from_numpy(pred.encode(Xc))
        if pred.variant != "binned":
            return torch.from_numpy(pred.encode(Xc)).to(device)
        tables = self._bin_tables.get(str(device))
        if tables is None:
            ds = pred.ds
            tables = self._bin_tables[str(device)] = device_bin_tables(
                [ds.mappers[j] for j in ds.used_features], device)
        return values_to_bins(
            torch.from_numpy(pred.used_values(Xc)).to(device), tables)

    def _shard(self, lane: int, Xs: np.ndarray, shard: int):
        """Issue lane ``lane``'s shard (``Xs``, zero-padded to ``shard``
        rows): one ``predict_pass`` on its replica's operands and stream;
        returns the [k, shard] scores (a pinned host copy on the card,
        complete once the stream is)."""
        rep = self.replicas[lane]
        dev = rep.device
        stream = None
        if dev.type == "cuda":
            stream = lane_stream(dev, rep.device_index)
            stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream) if stream is not None \
                else contextlib.nullcontext():
            enc = self._encode(Xs, dev)
            if enc.shape[0] < shard:
                enc = torch.cat([enc, enc.new_zeros(
                    (shard - enc.shape[0], enc.shape[1]))])
            out = predict_pass(enc, rep._ops, rep._tids, self.k,
                               self.pred.max_steps, self.pred.variant)
            if stream is None:
                return out, None
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
        return host, stream

    def predict_raw(self, X) -> np.ndarray:
        """Raw scores [k, n] float64: per ``n_lanes x shard`` chunk one
        shard a lane, each lane scoring its own rows against its replica's
        operands."""
        from ..basic import _is_scipy_sparse
        sparse_in = _is_scipy_sparse(X)
        if sparse_in:
            X = X.tocsr()
        n = int(X.shape[0])
        out = np.zeros((self.k, n), np.float64)
        if n == 0:
            return out
        d = self.n_lanes
        step = d * self.max_shard_rows
        t_all = time.perf_counter()
        compiles = dispatches = 0
        for c0 in range(0, n, step):
            c1 = min(n, c0 + step)
            rows = c1 - c0
            shard = min(self.max_shard_rows,
                        _round_up_pow2(max(2, -(-rows // d))))
            sig = self._sig_base + (shard,)
            with _SIG_LOCK:
                fresh = sig not in _COMPILED_SIGS
            issued = []
            for lane in range(d):
                s0 = min(c1, c0 + lane * shard)
                s1 = min(c1, s0 + shard)
                Xs = X[s0:s1]
                Xs = Xs.toarray() if sparse_in else np.asarray(Xs)
                issued.append((s0, s1) + self._shard(lane, Xs, shard))
            for s0, s1, scores, stream in issued:
                if stream is not None:
                    stream.synchronize()
                out[:, s0:s1] = scores.numpy()[:, :s1 - s0]
            # registered only after the chunk returned (as the engine's: a
            # failed first dispatch must not mark its signature warm)
            if fresh:
                with _SIG_LOCK:
                    if sig in _COMPILED_SIGS:
                        fresh = False
                    else:
                        _COMPILED_SIGS.add(sig)
            compiles += int(fresh)
            dispatches += 1
        self.dispatches += dispatches
        self.compiles += compiles
        wall = time.perf_counter() - t_all
        if self.tel is not None:
            try:
                self.tel.inc("serve.bulk_dispatches", dispatches)
                self.tel.inc("serve.bulk_rows", n)
                if compiles:
                    self.tel.inc("serve.bulk_compiles", compiles)
                self.tel.event(
                    "serve_bulk", model_id=self.eng.model_id,
                    rows=n, devices=d, dispatches=dispatches,
                    compiles=compiles, wall_ms=round(wall * 1000.0, 3),
                    rows_per_s=round(n / wall, 1) if wall > 0 else 0.0)
            except Exception:
                pass   # monitoring must never fail a prediction
        return out

    def stats(self) -> dict:
        return {"model_hash": self.model_hash[:16],
                "devices": self.n_lanes,
                "dispatches": self.dispatches,
                "compiles": self.compiles,
                "max_shard_rows": self.max_shard_rows}
