"""Payload accounting of the distributed growers' collectives.

PyTorch counterpart of ``lightgbm_tpu/ops/collectives.py``. Every
all-reduce the tree learners make goes through :func:`record_psum`,
:func:`record_pmax` or :func:`record_pmin`, which call
``torch.distributed.all_reduce`` (SUM, MAX, MIN) over the grower's process
group; while a :class:`CollectiveTrace` is active each call adds its
per-rank payload (elements x itemsize) to the trace. The JAX package
records at trace time, once per jit signature; PyTorch has no trace, so
the port counts each call as it is made, and the trace around one grow
holds the real payload of one tree.

A bool tensor goes over the wire as int32 (the JAX package's
``learner.py:431-434``); the result comes back as bool (any rank true
under SUM and MAX, every rank true under MIN). ``group=None`` is never
passed here: the growers' ``group=None`` means serial and makes no
collective call at all.

A timed trace (``CollectiveTrace(timed=True)``) also keeps the wall
seconds spent inside the calls; it synchronizes the tensor's device
before each call, so the time is the collective's own and not the wait
for the kernels queued before it.
"""
from __future__ import annotations

import time
from typing import Optional

import torch


class CollectiveTrace:
    """Context manager accumulating (count, bytes) of every collective
    made while it is active, with the per-dtype breakdown of the JAX
    package (``by_dtype[str(dtype)] = (count, bytes)``). Nesting replaces
    the active recorder for its scope and restores the outer one on
    exit."""

    _active: Optional["CollectiveTrace"] = None

    def __init__(self, timed: bool = False):
        self.count = 0
        self.bytes = 0
        self.seconds = 0.0
        self.timed = bool(timed)
        self.by_dtype: dict = {}
        self._outer: Optional["CollectiveTrace"] = None

    def __enter__(self) -> "CollectiveTrace":
        self._outer = CollectiveTrace._active
        CollectiveTrace._active = self
        return self

    def __exit__(self, *exc) -> None:
        CollectiveTrace._active = self._outer
        self._outer = None
        return None

    @property
    def profile(self):
        return self.count, self.bytes

    def _add(self, x: torch.Tensor) -> None:
        nbytes = int(x.numel()) * int(x.element_size())
        self.count += 1
        self.bytes += nbytes
        key = str(x.dtype).replace("torch.", "")
        cnt, byt = self.by_dtype.get(key, (0, 0))
        self.by_dtype[key] = (cnt + 1, byt + nbytes)


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    import torch.distributed as dist
    is_bool = x.dtype == torch.bool
    buf = (x.to(torch.int32) if is_bool else x).contiguous().clone()
    rec = CollectiveTrace._active
    if rec is not None:
        rec._add(buf)
        if rec.timed and buf.is_cuda:
            torch.cuda.synchronize(buf.device)
        t0 = time.perf_counter()
    dist.all_reduce(buf, op=op, group=group)
    if rec is not None:
        if rec.timed and buf.is_cuda:
            torch.cuda.synchronize(buf.device)
        rec.seconds += time.perf_counter() - t0
    return buf > 0 if is_bool else buf


def record_psum(x: torch.Tensor, group) -> torch.Tensor:
    """``all_reduce(SUM)`` over ``group`` with payload accounting (the JAX
    package's ``jax.lax.psum``); returns a new tensor."""
    import torch.distributed as dist
    return _all_reduce(x, group, dist.ReduceOp.SUM)


def record_pmax(x: torch.Tensor, group) -> torch.Tensor:
    """``all_reduce(MAX)`` over ``group`` (``jax.lax.pmax``)."""
    import torch.distributed as dist
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def record_pmin(x: torch.Tensor, group) -> torch.Tensor:
    """``all_reduce(MIN)`` over ``group`` (the ``jax.lax.pmin`` of
    ``merge_best_over_shards``)."""
    import torch.distributed as dist
    return _all_reduce(x, group, dist.ReduceOp.MIN)
