"""Multi-process data-parallel training: the row layout and the host plane.

PyTorch counterpart of ``lightgbm_tpu/parallel/multiproc.py``. The
reference trains ONE model across N machines, each rank holding a
disjoint row shard (ref: src/treelearner/data_parallel_tree_learner.cpp:
126-276). Here each rank is one process on one device; the growers'
all-reduces (``ops/collectives.py``) span the ranks, and the host-side
state every rank must agree on moves over the CPU gloo group of
``mesh.host_group`` (JAX's ``process_allgather``).

Layout contract (rank-blocked padded rows), the JAX package's:

- every rank owns ``block = S`` consecutive rows of the padded global
  space, its real rows first; ``S`` is the largest rank's row count
  rounded up to ``row_align`` (the fused kernel's widest tile, 2048, on
  the fused engine), so ``Np = S * W``;
- pad rows carry ZERO weight everywhere: ``real_mask`` folds into the
  bagging weights and into the metadata weight column;
- host-side per-row state (labels, weights, bagging draws) is allgathered
  or recomputed identically on every rank, so every rank runs the same
  Python program on the same values and emits the same model.

A rank keeps its device tensors at its own ``local_real`` rows (the fused
engine pads them to its kernel tile with rows at leaf -1); the global
index of its row ``i`` is ``rank * block + i``, which the quantized
gradients' dither hashes and the bagging draws slice by.

Every host-plane gather is counted (``host_count``, ``host_bytes``:
gathered result sizes) and runs under the host-collective policy
(``resilience/comms.guarded_call``). The two agreement guards of the JAX
package live here too: :func:`allgather_sample`
(``lightgbm_tpu/dataset.py:91-112``:
every rank bins from the gathered sample) and :func:`cohort_votes`
(``lightgbm_tpu/basic.py:128-145``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..utils import log
from . import mesh


def _allgather(arr: np.ndarray, group=None,
               what: str = "mp_allgather") -> np.ndarray:
    """[W, *arr.shape] from every rank's equally-shaped ``arr`` over the
    host plane (CPU tensors; bool travels as uint8). Guarded: with
    ``collective_timeout`` set, a hung peer raises a ``CollectiveError``
    here instead of wedging this rank (``resilience/comms.py``)."""
    import torch
    import torch.distributed as dist

    from ..resilience.comms import guarded_call
    group = mesh.host_group() if group is None else group
    a = np.ascontiguousarray(arr)
    is_bool = a.dtype == np.bool_
    t = torch.from_numpy(a.astype(np.uint8) if is_bool else a.copy())
    W = dist.get_world_size(group)
    out = [torch.empty_like(t) for _ in range(W)]
    guarded_call(lambda: dist.all_gather(out, t, group=group), what=what)
    res = torch.stack(out).numpy()
    return res.astype(np.bool_) if is_bool else res


def allgather_sample(sample: np.ndarray) -> np.ndarray:
    """Concatenate every rank's binning sample, in rank order (no-op
    without a group of two or more). The ranks' sample sizes may differ:
    the counts are gathered first and each sample padded to the largest."""
    if mesh.world() <= 1:
        return sample
    cnts = _allgather(np.array([sample.shape[0]], np.int64)).reshape(-1)
    m = int(cnts.max())
    padded = np.zeros((m, sample.shape[1]), np.float64)
    padded[:sample.shape[0]] = np.asarray(sample, np.float64)
    g = _allgather(padded)
    return np.concatenate([g[p, :int(cnts[p])] for p in range(len(cnts))],
                          axis=0)


def cohort_votes(flag: bool) -> Tuple[bool, bool]:
    """Allgather a boolean vote -> (any_true, all_true). A decision that
    leads one rank into a collective its peers skip must be taken on the
    cohort's votes, never on one rank's view."""
    if mesh.world() <= 1:
        return flag, flag
    votes = _allgather(np.array([1 if flag else 0], np.int32)).reshape(-1)
    return bool(votes.max() == 1), bool(votes.min() == 1)


class GlobalMetadata:
    """Host-side global view of the per-row metadata, identical on every
    rank: objectives and metrics are initialised on it, so their
    statistics (label means, class counts, metric weights) are global, as
    the reference's Network::GlobalSyncUp* paths make them. ``weight``
    always exists (the real-row mask when the data is unweighted).

    Ranking: ``query_boundaries`` is cumulative over the COMPACTED real
    rows (``total_real``), and ``query_row_map`` [total_real] maps each
    compacted row to its padded global row (the rank blocks leave gaps);
    consumers index labels, weights and scores through the map. Every
    rank holds whole queries (ref: metadata.cpp:141 CheckOrPartition)."""

    def __init__(self, label, weight, init_score, query_boundaries=None,
                 query_row_map=None):
        self.label = label
        self.weight = weight
        self.init_score = init_score
        self.query_boundaries = query_boundaries
        self.query_row_map = query_row_map


class MultiProcLayout:
    """The rank-blocked row layout over the default process group."""

    def __init__(self, local_rows: int, row_align: int = 1):
        import torch.distributed as dist
        self.group = mesh.host_group()
        self.process_index = dist.get_rank()
        self.process_count = dist.get_world_size()
        self.host_count = 0
        self.host_bytes = 0
        self.local_real = int(local_rows)
        counts = self._allgather(np.asarray([self.local_real], np.int64))
        self.counts = [int(c) for c in counts.reshape(-1)]
        self.total_real = int(sum(self.counts))
        self.S = max(1, max(self.counts))
        if row_align > 1:
            self.S = ((self.S + row_align - 1) // row_align) * row_align
        self.block = self.S
        self.Np = self.S * self.process_count
        self.offset = self.process_index * self.block
        log.info("multi-process layout: %d processes, %d real rows -> %d "
                 "padded (%d rows/rank)", self.process_count,
                 self.total_real, self.Np, self.S)

    # ------------------------------------------------------------ host
    def _allgather(self, arr: np.ndarray) -> np.ndarray:
        out = _allgather(arr, self.group)
        self.host_count += 1
        self.host_bytes += int(out.nbytes)
        return out

    def pad_local(self, arr: np.ndarray) -> np.ndarray:
        """[local_real, ...] -> [block, ...] zero-padded."""
        arr = np.asarray(arr)
        pad = self.block - arr.shape[0]
        if pad < 0:
            log.fatal("local shard has %d rows but the block is %d",
                      arr.shape[0], self.block)
        if pad == 0:
            return arr
        return np.pad(arr, [(0, pad)] + [(0, 0)] * (arr.ndim - 1))

    def allgather_rows(self, local: Optional[np.ndarray]
                       ) -> Optional[np.ndarray]:
        """Per-rank local rows -> identical [Np, ...] host array on every
        rank (the mapper-allgather pattern of dataset_loader.cpp:1146
        applied to metadata columns); pad rows 0."""
        if local is None:
            return None
        loc = self.pad_local(np.asarray(local))
        out = self._allgather(loc)
        return out.reshape((self.Np,) + loc.shape[1:])

    def real_mask_np(self) -> np.ndarray:
        """[Np] f32: 1.0 for real rows, 0.0 for pads."""
        m = np.zeros((self.Np,), np.float32)
        for r, c in enumerate(self.counts):
            off = r * self.block
            m[off:off + c] = 1.0
        return m

    def global_queries(self, query_boundaries):
        """(global compacted query boundaries [Q+1] int64, query_row_map
        [total_real] int64) from this rank's boundaries over its own rows
        (lightgbm_tpu/parallel/multiproc.py:183-223): two host gathers,
        the query counts and the padded sizes. Every rank's sizes cover
        exactly its own rows (``basic._check_rank_queries``, on the
        cohort's vote), so no query straddles ranks."""
        sizes = np.diff(np.asarray(query_boundaries, np.int64))
        nq = self._allgather(np.asarray([sizes.size], np.int64)).reshape(-1)
        m = max(1, int(nq.max()))
        pad = np.zeros(m, np.int64)
        pad[:sizes.size] = sizes
        allq = self._allgather(pad).reshape(self.process_count, m)
        all_sizes = np.concatenate(
            [allq[r, :int(nq[r])] for r in range(self.process_count)])
        qb = np.concatenate([[0], np.cumsum(all_sizes)]).astype(np.int64)
        # compacted row -> padded global row: rank r's rows sit at
        # [r * block, r * block + counts[r]), the pads of its block skipped
        qmap = np.concatenate(
            [r * self.block + np.arange(c, dtype=np.int64)
             for r, c in enumerate(self.counts)])
        return qb, qmap

    def global_metadata(self, md) -> GlobalMetadata:
        """Global host metadata from the rank-local one; pad rows carry
        zero weight through objectives and metrics."""
        qb = qmap = None
        if md.query_boundaries is not None:
            qb, qmap = self.global_queries(md.query_boundaries)
        label = self.allgather_rows(md.label)
        weight = self.allgather_rows(md.weight)
        mask = self.real_mask_np()
        weight = mask if weight is None else (weight * mask).astype(
            np.float32)
        init_score = md.init_score
        if init_score is not None:
            init_score = np.asarray(init_score)
            if init_score.ndim == 1 and init_score.size != self.local_real:
                # per-class flattened layout [k*n]: gather per class
                k = init_score.size // self.local_real
                cols = init_score.reshape(k, self.local_real)
                init_score = np.concatenate(
                    [self.allgather_rows(c) for c in cols])
            else:
                init_score = self.allgather_rows(init_score)
        return GlobalMetadata(label, weight, init_score,
                              query_boundaries=qb, query_row_map=qmap)

    def local_block(self, arr, axis: int = -1):
        """This rank's real rows of a global array or tensor whose ``axis``
        runs over the Np padded rows."""
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(self.offset, self.offset + self.local_real)
        return arr[tuple(sl)]

    def gather_cols(self, local):
        """[k, local_real] tensor on this rank's device -> [k, Np] on every
        rank, pad columns 0 (the training scores' global view for
        metrics), through the host plane."""
        import torch
        loc = np.zeros((local.shape[0], self.block), np.float32)
        loc[:, :self.local_real] = local.detach().float().cpu().numpy()
        g = self._allgather(loc)                     # [W, k, block]
        full = np.concatenate(list(g), axis=1)
        return torch.as_tensor(full, device=local.device)
