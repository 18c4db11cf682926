"""Data-parallel tree growth: rows sharded, histograms all-reduced.

PyTorch counterpart of ``lightgbm_tpu/parallel/data_parallel.py`` (ref:
src/treelearner/data_parallel_tree_learner.cpp). The reference
reduce-scatters byte-laid-out histograms so each rank owns a feature
subset, finds its best split, then all-reduces 48-byte SplitInfo records
(:155-260). Here the whole exchange is one SUM all-reduce of each
histogram (``ops/collectives.record_psum``, inside the growers): every
rank then computes the same global argmax, so no second sync is needed.
"""
from __future__ import annotations

from ..models.learner import grow_tree_depthwise, grow_tree_leafwise
from ..ops.split import SplitParams


def make_sharded_grow_fn(group, params: SplitParams, num_leaves: int,
                         max_bins: int, max_depth: int = -1,
                         policy: str = "leafwise", hist_impl: str = "auto",
                         cat_idx=None, use_mono_bounds: bool = False,
                         node_masks=None):
    """The callable one rank runs on its row shard: ``fn(bins, gh, meta,
    feature_mask) -> (tree, row_leaf)``, ``bins`` [R_local, F] and ``gh``
    [R_local, 3] this rank's rows (pad rows with zero weight), the tree
    identical on every rank of ``group``, ``row_leaf`` this rank's rows'
    leaves. ``cat_idx`` enables the categorical scan (the JAX factory's
    ``has_cat``).

    Role: the standalone composition surface (unit tests, embedders
    growing single trees). The trainer calls the same growers,
    where the all-reduces live exactly once."""
    grow = grow_tree_leafwise if policy == "leafwise" else grow_tree_depthwise

    def per_shard(bins, gh, meta, feature_mask):
        return grow(bins, gh, meta, feature_mask, params, num_leaves,
                    max_bins, max_depth, hist_impl=hist_impl,
                    cat_idx=cat_idx, use_mono_bounds=use_mono_bounds,
                    node_masks=node_masks, group=group,
                    parallel_mode="data")
    return per_shard
