"""Frontier-batched tree growth: the frontier-v1 engine.

PyTorch counterpart of ``lightgbm_tpu/models/frontier.py``. Under a
process group (``group``, the JAX grower's ``psum_axis``) each level's
histogram planes are summed over the ranks before the split search
(``_hist_level``); ``boosting/gbdt.py`` moves distributed runs to the
fused engine, as the JAX package's trainer does.
Every level splits up to ``S_cap = min(slot_cap, num_leaves)`` leaves,
chosen by gain, and histograms the smaller child of each split through
:func:`ops.pallas_histogram.build_histograms_pallas_cm` (the CUDA
``hist_pass`` on the card) at the uniform slot count S_cap; the sibling
comes from the parent's pooled histogram by subtraction (ref:
serial_tree_learner.cpp:423-425). The root histogram is one more pass at
S=8. The level count is the JAX package's, so both grow the same trees.

Differences from the JAX grower, all of them PyTorch's idiom:

- the per-level ``lax.cond(n_sel > 0)`` is a host branch on ``n_sel``,
  read once per level and counted in ``frontier2.host_syncs``;
- routing (``route_one``, a loop over the S_d slots) and the score lookup
  (``leaf_value_lookup``, a where-chain over the L leaves) exist in the JAX
  package only because per-row gathers are slow on the TPU; here both are
  per-row gathers of the per-leaf tables, with the same integer results;
- the split search runs on the 2*n_sel fresh children only (the JAX
  grower rescans all L leaves; the others' pools and outputs are unchanged,
  so their results would be too), and the pools are written by exact
  indexing.
"""
from __future__ import annotations

import torch

from ..ops.collectives import record_psum
from ..ops.pallas_histogram import build_histograms_pallas_cm
from ..ops.split import SplitParams, best_numerical_split_cm, \
    calculate_leaf_output, map_split
from .frontier2 import host_syncs
from .learner import NEG_INF, FeatureMeta, _masked_gain, _masked_scatter
from .tree import empty_tree

ROOT_SLOTS = 8


def level_count(num_leaves: int, max_depth: int, slot_cap: int) -> int:
    """Level passes of one tree (``frontier.py:83-89``): the balanced
    tree's depth, plus the extra passes that a frontier wider than
    ``slot_cap`` needs."""
    L = num_leaves
    S_cap = min(slot_cap, L)
    n_levels = max_depth if max_depth > 0 else max(1, (L - 1).bit_length()
                                                   + 1)
    n_levels = min(n_levels, L - 1)
    return n_levels + max(0, (L - 1 + S_cap - 1) // S_cap - n_levels)


def _hist_level(bins_i32, gh3, row_slot, S, B, group):
    """[S, F, B] (g, h, c) planes of one level, summed over ``group``
    (lightgbm_tpu/models/frontier.py:38-50)."""
    g, h, c = build_histograms_pallas_cm(bins_i32, gh3, row_slot,
                                         num_slots=S, num_bins=B)
    if group is not None:
        g, h, c = (record_psum(x, group) for x in (g, h, c))
    return g, h, c


def grow_tree_frontier(bins_i32: torch.Tensor, gh3: torch.Tensor,
                       meta: FeatureMeta, feature_mask: torch.Tensor,
                       params: SplitParams, num_leaves: int, max_bins: int,
                       max_depth: int = -1, slot_cap: int = 64, group=None):
    """Grow one tree level by level.

    Args:
      bins_i32: [R, Fp] int32 binned rows, feature-padded for the kernel
        (the JAX grower's transposed copy ``bins_T`` is not needed: routing
        gathers each row's split-feature bin from this matrix).
      gh3: [R, 3] float32 (grad, hess, weight).
      meta: FeatureMeta sized Fp (padding features num_bin=2, masked out).
      feature_mask: [Fp] bool.
      max_bins: the padded pow2 bin count Bp.
      group: the data-parallel process group (rows sharded), or None.

    Returns (TreeArrays, row_leaf [R] int32).
    """
    R, Fp = bins_i32.shape
    dev = bins_i32.device
    L = num_leaves
    B = max_bins
    S_cap = min(slot_cap, L)

    tree = empty_tree(L, B, dev)
    row_leaf = torch.zeros(R, dtype=torch.int32, device=dev)
    pool_g = torch.zeros((L, Fp, B), dtype=torch.float32, device=dev)
    pool_h = torch.zeros_like(pool_g)
    pool_c = torch.zeros_like(pool_g)

    g0, h0, c0 = _hist_level(bins_i32, gh3, row_leaf, ROOT_SLOTS, B, group)
    pool_g[0] = g0[0]
    pool_h[0] = h0[0]
    pool_c[0] = c0[0]
    root_g = g0[0, 0, :].sum()
    root_h = h0[0, 0, :].sum()
    root_c = c0[0, 0, :].sum()
    tree.leaf_value[0] = calculate_leaf_output(root_g, root_h, params,
                                               root_c, 0.0)
    tree.leaf_count[0] = root_c
    tree.leaf_weight[0] = root_h

    root_best = best_numerical_split_cm(
        g0[:1], h0[:1], c0[:1], meta.num_bin, meta.missing_type,
        meta.default_bin, feature_mask, params, tree.leaf_value[:1])
    best = map_split(lambda a: torch.cat(
        [a, torch.zeros((L - 1,), dtype=a.dtype, device=dev)]), root_best)
    best = best._replace(gain=torch.cat(
        [root_best.gain, torch.full((L - 1,), NEG_INF, device=dev)]))
    lpn = torch.full((L,), -1, dtype=torch.int32, device=dev)  # leaf->parent
    lil = torch.zeros((L,), dtype=torch.bool, device=dev)      # is left child

    state = (tree, row_leaf, pool_g, pool_h, pool_c, best, lpn, lil)
    for _ in range(level_count(L, max_depth, slot_cap)):
        state = _one_level(state, bins_i32, gh3, meta, feature_mask, params,
                           L, B, S_cap, max_depth, group)
    return state[0], state[1]


def leaf_value_lookup(leaf_value: torch.Tensor, row_leaf: torch.Tensor,
                      num_leaves: int) -> torch.Tensor:
    """Score contribution per row: ``leaf_value[row_leaf]``, and 0 where
    the leaf lies outside [0, min(num_leaves, len(leaf_value)))."""
    L = min(num_leaves, leaf_value.shape[0])
    ok = (row_leaf >= 0) & (row_leaf < L)
    vals = leaf_value[row_leaf.clamp(0, L - 1).long()]
    return torch.where(ok, vals, torch.zeros((), dtype=leaf_value.dtype,
                                             device=leaf_value.device))


def _one_level(state, bins_i32, gh3, meta, feature_mask, params, L, B, S_d,
               max_depth, group=None):
    tree, row_leaf, pool_g, pool_h, pool_c, best, lpn, lil = state
    dev = bins_i32.device
    nl = tree.num_leaves
    slots = torch.arange(L, dtype=torch.int32, device=dev)

    gains = _masked_gain(best.gain, tree.leaf_depth, nl, max_depth, L)
    budget = L - nl
    # stable, like jnp.argsort: on tied gains (NEG_INF above all) the slot
    # order decides which leaves split
    order = torch.argsort(-gains, stable=True)
    rank = torch.empty(L, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(L, device=dev)
    selected = (gains > 0.0) & (rank < budget) & (rank < S_d)
    n_sel = int(selected.sum())          # the level's one host sync
    host_syncs["count"] += 1
    if n_sel == 0:
        return state

    sel_i32 = selected.to(torch.int32)
    k_of_leaf = torch.cumsum(sel_i32, 0, dtype=torch.int32) - sel_i32
    new_of_leaf = torch.where(selected, nl + k_of_leaf, -1).to(torch.int32)
    node_of_leaf = torch.where(selected, nl - 1 + k_of_leaf, -1) \
        .to(torch.int32)
    # the selected leaves in slot order (k_of_leaf counts them up from 0)
    leaf_of_slot = _masked_scatter(torch.zeros(S_d, dtype=torch.int32,
                                               device=dev),
                                   torch.clamp(k_of_leaf, max=S_d - 1),
                                   slots, selected)
    sel = leaf_of_slot[:n_sel].long()
    new = new_of_leaf[sel].long()

    # ---- routing + slot assignment by per-row gathers of the leaf tables
    left_smaller = best.left_count <= best.right_count          # [L]
    leaf = row_leaf.long()
    on = selected[leaf]
    feat = best.feature.clamp(min=0)[leaf].long()
    b = bins_i32.gather(1, feat[:, None])[:, 0]
    nb = meta.num_bin[feat]
    mt = meta.missing_type[feat]
    db = meta.default_bin[feat]
    missing = ((mt == 1) & (b == db)) | ((mt == 2) & (b == nb - 1))
    left = torch.where(missing, best.default_left[leaf],
                       b <= best.threshold[leaf])
    row_leaf2 = torch.where(on & ~left, new_of_leaf[leaf], row_leaf)
    is_small = torch.where(left_smaller[leaf], left, ~left)
    row_slot = torch.where(on & is_small, k_of_leaf[leaf], -1) \
        .to(torch.int32)

    # ---- histogram the SMALLER child per split; sibling by subtraction
    hg, hh, hc = _hist_level(bins_i32, gh3, row_slot, S_d, B, group)
    sl = left_smaller[sel][:, None, None]
    fresh = []
    for pool, got in ((pool_g, hg[:n_sel]), (pool_h, hh[:n_sel]),
                      (pool_c, hc[:n_sel])):
        sib = pool[sel] - got
        lv, rv = torch.where(sl, got, sib), torch.where(sl, sib, got)
        pool[sel] = lv             # left child keeps the leaf id (in place)
        pool[new] = rv
        fresh.append(torch.cat([lv, rv]))

    # ---- tree bookkeeping (ref: tree.h:62 Tree::Split)
    new_depth = tree.leaf_depth + 1

    def w(arr, vals):
        return _masked_scatter(arr, node_of_leaf, vals, selected)

    lc = w(tree.left_child, -slots - 1)
    rc = w(tree.right_child, -new_of_leaf - 1)
    wl = selected & (lpn >= 0) & lil
    wr = selected & (lpn >= 0) & ~lil
    lc = _masked_scatter(lc, lpn, node_of_leaf, wl)
    rc = _masked_scatter(rc, lpn, node_of_leaf, wr)
    lpn2 = torch.where(selected, node_of_leaf, lpn)
    lil2 = torch.where(selected, True, lil)
    lpn2 = _masked_scatter(lpn2, new_of_leaf, node_of_leaf, selected)
    lil2 = _masked_scatter(lil2, new_of_leaf,
                           torch.zeros(L, dtype=torch.bool, device=dev),
                           selected)

    def upd2(arr, lv, rv):
        arr = _masked_scatter(arr, slots, lv, selected)
        return _masked_scatter(arr, new_of_leaf, rv, selected)

    tree2 = tree._replace(
        num_leaves=nl + n_sel,
        split_feature=w(tree.split_feature, best.feature),
        threshold_bin=w(tree.threshold_bin, best.threshold),
        default_left=w(tree.default_left, best.default_left),
        split_gain=w(tree.split_gain, best.gain),
        internal_value=w(tree.internal_value, tree.leaf_value),
        internal_count=w(tree.internal_count, tree.leaf_count),
        internal_weight=w(tree.internal_weight, tree.leaf_weight),
        left_child=lc, right_child=rc,
        leaf_value=upd2(tree.leaf_value, best.left_output,
                        best.right_output),
        leaf_count=upd2(tree.leaf_count, best.left_count, best.right_count),
        leaf_weight=upd2(tree.leaf_weight, best.left_sum_hess,
                         best.right_sum_hess),
        leaf_depth=upd2(tree.leaf_depth, new_depth, new_depth),
    )

    # ---- best splits of the fresh children; each child's own output is
    # the parent_output of its prospective children
    bs = best_numerical_split_cm(
        *fresh, meta.num_bin, meta.missing_type, meta.default_bin,
        feature_mask, params,
        torch.cat([best.left_output[sel], best.right_output[sel]]))
    def merge(a, v):
        a = a.clone()
        a[sel] = v[:n_sel]
        a[new] = v[n_sel:]
        return a
    return (tree2, row_leaf2, pool_g, pool_h, pool_c,
            map_split(merge, best, bs), lpn2, lil2)
