"""Feature-parallel and voting-parallel tree learners.

PyTorch counterparts of ``lightgbm_tpu/parallel/tree_parallel.py``:

- feature-parallel (ref: src/treelearner/feature_parallel_tree_learner.cpp):
  every rank holds the full row set but histograms and scans only its own
  column slice; each level's best splits are merged with a MAX + winner
  pick (the SyncUpGlobalBestSplit all-reduce of 48-byte SplitInfo
  records, parallel_tree_learner.h:191-214). Zero histogram traffic — the
  only exchange is [num_leaves]-sized split records.

- voting-parallel (ref: src/treelearner/voting_parallel_tree_learner.cpp):
  rows sharded as in data-parallel, but instead of all-reducing the full
  [L, F, B, 3] histogram each level, ranks vote for their local top_k
  features and only the 2*top_k winners' columns are summed — the level
  payload drops from F*B*3 to 2*top_k*B*3 (GlobalVoting/CopyLocalHistogram
  :151-184). Divergence from the reference, the JAX package's: winners are
  the per-LEVEL union of slot votes.
"""
from __future__ import annotations

import torch

from ..models.learner import FeatureMeta, grow_tree_depthwise
from ..ops.split import SplitParams

FEATURE_AXIS = "feature"


def pad_features(F: int, n_shards: int) -> int:
    return ((F + n_shards - 1) // n_shards) * n_shards


def make_feature_parallel_grow_fn(group, params: SplitParams,
                                  num_leaves: int, max_bins: int,
                                  max_depth: int = -1,
                                  hist_impl: str = "auto", cat_idx=None):
    """Feature-parallel growth: the callable one rank runs,
    ``fn(bins_full, gh, meta, feature_mask) -> (tree, row_leaf)``, with
    the rows REPLICATED on every rank (JAX's ``in_specs=P()``): ``bins``
    [R, Fp] and ``gh`` [R, 3] in full, ``meta`` over Fp features,
    ``feature_mask`` [Fp]. The rank histograms and scans its slice of
    ``Fp / W`` columns and routes on the full matrix; the tree carries
    GLOBAL feature indices and equals the serial grower's, bit for bit
    (every rank takes the leaf totals from global column 0, as the serial
    scan does). Fp must divide by the group size (pad trivial features and
    mask them off)."""
    import torch.distributed as dist
    n_shards = dist.get_world_size(group)
    sid = dist.get_rank(group)

    def per_shard(bins_full, gh, meta, feature_mask):
        Fp = bins_full.shape[1]
        if pad_features(Fp, n_shards) != Fp:
            raise ValueError(f"feature-parallel needs a column count that "
                             f"divides by the group size {n_shards}; pad "
                             f"{Fp} to pad_features(F, W) = "
                             f"{pad_features(Fp, n_shards)} trivial-masked "
                             f"columns")
        Fs = Fp // n_shards
        f0 = sid * Fs
        # a rank not owning global column 0 histograms it too, as a
        # leading column masked out of its scans: the split scan takes the
        # leaf totals from the first column's bins, and this way they are
        # the serial grower's sums on every rank, to the last bit
        lead = f0 > 0
        cols = ([0] if lead else []) + list(range(f0, f0 + Fs))
        idx = torch.as_tensor(cols, device=bins_full.device)

        def sl(a):
            return a.index_select(0, idx)
        meta_loc = FeatureMeta(
            num_bin=sl(meta.num_bin), missing_type=sl(meta.missing_type),
            default_bin=sl(meta.default_bin), monotone=sl(meta.monotone),
            is_cat=None if meta.is_cat is None else sl(meta.is_cat))
        mask_loc = sl(feature_mask).clone()
        if lead:
            mask_loc[0] = False
        loc_cat = None
        if cat_idx is not None:
            owned = [cols.index(int(c)) for c in cat_idx.tolist()
                     if f0 <= int(c) < f0 + Fs]
            loc_cat = (torch.as_tensor(owned, device=bins_full.device)
                       if owned else None)
        return grow_tree_depthwise(
            bins_full.index_select(1, idx), gh, meta_loc, mask_loc, params,
            num_leaves, max_bins, max_depth, hist_impl=hist_impl,
            cat_idx=loc_cat, group=group, parallel_mode="feature",
            route_bins=bins_full, route_meta=meta,
            feature_offset=f0 - 1 if lead else f0)
    return per_shard


def make_voting_parallel_grow_fn(group, params: SplitParams,
                                 num_leaves: int, max_bins: int,
                                 max_depth: int = -1, top_k: int = 20,
                                 hist_impl: str = "auto", cat_idx=None):
    """Voting-parallel growth (rows sharded): the depth-wise grower with
    each level's histogram exchange restricted to the 2*top_k vote
    winners; ``fn(bins, gh, meta, feature_mask) -> (tree, row_leaf)`` as
    :func:`data_parallel.make_sharded_grow_fn`."""
    def per_shard(bins, gh, meta, feature_mask):
        return grow_tree_depthwise(
            bins, gh, meta, feature_mask, params, num_leaves, max_bins,
            max_depth, hist_impl=hist_impl, cat_idx=cat_idx, group=group,
            parallel_mode="voting", top_k=top_k)
    return per_shard
