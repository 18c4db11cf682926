"""Frontier grower v2 — one fused route + histogram pass per tree level.

PyTorch counterpart of ``lightgbm_tpu/models/frontier2.py`` on the serial
path. Per level, one :func:`ops.fused_level.level_pass`
routes every row and histograms the smaller child of each split; the
sibling comes from the parent's pooled histogram by subtraction (ref:
serial_tree_learner.cpp:283-323, 423-425), and the split search runs only
on the 2*Sp fresh children. Level caps are the JAX package's (1, 2, 4, ...
capped at ``max_slot_cap``, then ``extra_levels`` passes), so both packages
grow the same trees.

Differences from the JAX grower, all of them PyTorch's idiom:

- the per-level ``lax.cond`` on device values (skip a level with nothing
  to split; switch to the route-only pass once the leaf budget is spent)
  is a host branch on ``n_sel``, read once per level — the one host sync
  per level (``host_syncs`` counts them);
- the [L, F, B] histogram pools are read and written by exact indexing
  (the JAX package used one-hot HIGHEST-precision matmuls only because TPU
  gathers are slow);
- ``num_leaves`` is a host int.

The histogram-plane cuts ride the same schedule (the JAX grower's
``quant_bits``, ``packed``, ``mask_onehot`` and ``gh_scales``): every level
histogram is decoded onto the padded logical layout in f32 before anything
reads it (``decode``), so split search, pools and subtraction are those of
the f32 padded path; route tables are built on that layout and re-indexed
onto the packed flat axis; the level caps stay derived from the padded
``f_oh * Bp``, so the packed layout grows the same tree.

Categorical features (``cat_idx``, the JAX grower's static ``has_cat``)
join the split search, and a categorical winner's ``cat_flag`` and left
bin set ``cat_mask`` go into the level's route table and the tree (the
JAX lines ``frontier2.py:430-450, 604-662, 724-753``); the kernels route
such a W row as any other. The smaller-child choice is unchanged.

Per-node feature masks (``node_masks``: interaction constraints and
``feature_fraction_bynode``) narrow the split search of the root and of
every fresh child, as the JAX grower's ``use_node_masks`` does: each leaf
carries the bitmask of the constraint groups its path still allows, and
each child draws its by-node sample from the Threefry key folded with its
creating node's id and side. The masks are device tensors; they add no host
read.

Exclusive feature bundling (``bundle_cols > 0``, the JAX lines
``frontier2.py:211-213, 281-284, 437-461, 498-502, 550-554``): ``bins_T``
holds EFB bundle columns of ``bundle_col_bins`` bins, and the kernels run
on that layout, while split search, pools and trees stay logical. Every
kernel histogram is decoded by ``bundle_plane_views`` (the FixHistogram
residual on each feature's most-frequent bin), route tables come from
``build_route_table_bundled``, and the level caps from the bundle layout's
flat width. The voting exchange (``frontier2.py:524-529``) waits for the
distributed learners.

Monotone constraints (``use_mono_bounds``, the JAX lines
``frontier2.py:298-320, 379, 625-668, 692-765``) carry per-leaf output
bounds ``leaf_lo``/``leaf_hi`` (-inf/+inf until a constraint binds) into
every split search, which clips candidate outputs into them. ``mono_mode``
picks how they grow: ``basic`` fences both children of a monotone split
at the mid of their outputs (``mono_child_bounds``); ``intermediate``
keeps each leaf's bin-space region (``reg_lo``/``reg_hi``, [L, F]) and
runs the level's splits one at a time in slot order
(``mono_inter_level_update``): each fresh child's output is clipped
against its region-adjacent leaves and the other leaves' bounds tighten.
A leaf whose bounds tightened without being split rescans its pooled
histogram under them. The JAX grower gates that rescan with a
``lax.cond`` on any such leaf; here it runs every intermediate level and
the result is merged where a leaf's bounds changed, which gives the same
splits with no second host read per level.

Distribution (the JAX lines ``frontier2.py:150-200`` are the contract):
``group`` takes the place of ``psum_axis`` (None = serial). Under
``parallel_mode`` "data" the root pass's histogram and every level's
packed ``[FB, nch*Sp]`` accumulator are summed over the group before the
decode (the hi/lo and int32 decodes are linear, so the sum keeps f32-grade
precision, and int32 sums are exact); routing stays rank-local, and the
level's ``n_sel`` host read sees the same global gains on every rank.
"voting" exchanges only the vote winners' columns of each level (the root
is a full exchange) and keeps an ``[L, f_oh]`` validity pool for the
sibling subtraction and later scans; a vote that covers every column is
the data path verbatim. "feature" keeps the rows replicated, scans only
``feature_shard_mask``'s columns and merges the best splits over the group
(offset 0: the fused layout is replicated, so local indices are global).
Under a group each rank passes its own ``num_rows``: its rows are its own
local layout, the padding columns of which sit at leaf -1 as in the
serial path (``num_rows=0``, every column real, with padding marked by
zero gh weight, holds as well).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..ops.collectives import record_psum
from ..ops.fused_level import (NCH_PRECISE, build_route_table,
                               build_route_table_bundled, bundle_plane_views,
                               hist_planes, level_pass, max_slot_cap,
                               pack_route_table, route_pass, table_lookup)
from ..ops.split import (BestSplit, SplitParams, best_split_cm,
                         calculate_leaf_output, map_split,
                         per_feature_gains_cm)
from .learner import (NEG_INF, FeatureMeta, NodeMaskCfg, _masked_gain,
                      _masked_scatter, merge_best_over_shards, meta_is_cat,
                      mono_child_bounds, mono_inter_level_update,
                      node_feature_mask, update_leaf_groups, vote_exchange)
from .tree import TreeArrays, empty_tree

# host reads of device values made by the grower since the last reset
host_syncs = {"count": 0}


def level_caps(num_leaves: int, max_depth: int, extra_levels: int,
               slot_cap: int = 128) -> Tuple[int, ...]:
    """Per-level split caps: 1, 2, 4, ... (<= slot_cap) until the
    cumulative cap covers num_leaves-1, then ``extra_levels`` passes of
    min(64, slot_cap) more; levels with nothing to split are skipped."""
    caps: List[int] = []
    cum = 0
    d = 0
    while cum < num_leaves - 1:
        if max_depth > 0 and d >= max_depth:
            break
        c = min(1 << d, slot_cap, num_leaves - 1)
        caps.append(c)
        cum += c
        d += 1
    caps.extend([min(64, slot_cap, num_leaves - 1)] * extra_levels)
    return tuple(caps)


def _merge_best_many(best: BestSplit, idx, vals: BestSplit,
                     mask) -> BestSplit:
    return map_split(lambda a, v: _masked_scatter(a, idx, v, mask), best,
                     vals)


def _pool_write(pool: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """pool[idx[k]] = vals[k] where mask[k] (in place; indices are unique
    among the masked-in slots)."""
    pool[idx[mask].long()] = vals[mask]
    return pool


def grow_tree_fused(bins_T: torch.Tensor, gh_T: torch.Tensor,
                    meta: FeatureMeta, feature_mask: torch.Tensor,
                    params: SplitParams, num_leaves: int, max_bins: int,
                    f_oh: int, num_rows: int = 0, nch: int = NCH_PRECISE,
                    max_depth: int = -1, extra_levels: int = 3,
                    root_hist: torch.Tensor = None,
                    defer_final_route: bool = False, quant_bits: int = 0,
                    packed=None, mask_onehot: bool = False,
                    gh_scales: torch.Tensor = None,
                    node_masks: NodeMaskCfg = None,
                    cat_idx: torch.Tensor = None, bundle_cols: int = 0,
                    bundle_col_bins: int = 0, bundle_cfg=None,
                    use_mono_bounds: bool = False,
                    mono_mode: str = "basic", group=None,
                    parallel_mode: str = "data", top_k: int = 20,
                    feature_shard_mask: torch.Tensor = None):
    """Grow one tree with fused level passes.

    Args:
      bins_T: [Fp, Rp] int8/int16 feature-major binned matrix; padded
        feature rows all-zero.
      gh_T: [8, Rp] bfloat16 from ops.fused_level.pack_gh (zeros in padding
        columns).
      meta: FeatureMeta sized f_oh (padding features carry num_bin=0 and
        feature_mask False).
      feature_mask: [f_oh] bool.
      max_bins: the padded pow2 bin count Bp.
      num_rows: real row count R (0 = all Rp rows are real); padding rows
        sit at leaf -1, so they never route, histogram or score.
      root_hist: the root histogram [F_oh*Bp, nch*8] in the root pass's
        layout (slot 0 live), as the previous iteration's
        ``epilogue_pass`` built it; the root ``level_pass`` is skipped.
      defer_final_route: the route-only pass (the one that spends the leaf
        budget, or the last scheduled one) records its splits in the tree
        but routes no rows; its tables are returned for ``epilogue_pass``.
      quant_bits: 8 or 16 when ``gh_T`` is the int8 block of
        ``pack_gh_quant`` (``nch`` = ``quantize.QNCH[quant_bits]``) and
        ``gh_scales`` its [2] scales; the int32 histograms are decoded
        through them.
      packed: the adaptive layout (``ops/layout.PackedLayout``); ``bins_T``'s
        rows are then in ``packed.feat_order``.
      mask_onehot: gain screening — the kernel zeroes the slabs of the
        features ``feature_mask`` leaves out (logical feature 0 and the
        first kernel row's feature stay live: the leaf totals and the root
        pass's every-row-left trick read them).
      node_masks: the per-node feature masks (``learner.NodeMaskCfg`` sized
        f_oh, its key already folded with the iteration), or None.
      cat_idx: the categorical features' indices (``meta.is_cat``'s set,
        known on the host), or None when there are none.
      bundle_cols, bundle_col_bins, bundle_cfg: the kernel layout when
        ``bins_T`` holds EFB bundle columns (0 = unbundled) and the
        ``learner.BundleCfg`` decode tables padded to f_oh x max_bins.
      use_mono_bounds: ``meta.monotone`` holds a constraint; every split
        search then runs under the leaves' output bounds.
      mono_mode: ``basic`` or ``intermediate`` (the bounds' bookkeeping).
      group, parallel_mode, top_k, feature_shard_mask: the distributed
        learner (module docstring); a ``root_hist`` under a group must
        already be summed over it.

    Returns (TreeArrays, row_leaf [Rp] int32; padding rows stay at -1).
    With ``defer_final_route``: (tree, row_leaf before the final route,
    W_last [Sp_max, FB], tbl_last [Sp_max, 128]), padded to the widest
    level; an all-inactive table (leaf_of_slot -2) routes nothing.
    """
    Fp, Rp = bins_T.shape
    dev = bins_T.device
    L = num_leaves
    B = max_bins
    # the kernel layout: bundle columns under bundles
    k_foh, k_B = (bundle_cols, bundle_col_bins) if bundle_cols else (f_oh, B)
    # caps from the PADDED flat width: the packed layout grows the same tree
    caps = level_caps(L, max_depth, extra_levels,
                      slot_cap=max_slot_cap(k_foh * k_B, nch))
    kern_fb = packed.fb if packed is not None else k_foh * k_B

    def decode(hist, Sp_):
        """Kernel histogram -> (g, h, c) f32 planes on the padded logical
        layout: the packed re-index (exact) and the int32 -> f32 rescale,
        before any split search; under bundles the logical views of the
        bundle planes."""
        g, h, c = hist_planes(hist, nch, Sp_, k_foh, k_B, packed=packed,
                              quant_bits=quant_bits, scales=gh_scales)
        if not bundle_cols:
            return g, h, c
        v = bundle_plane_views(torch.stack([g, h, c], -1),
                               bundle_cfg.flat_idx, bundle_cfg.valid,
                               bundle_cfg.default_bin)
        return v[..., 0], v[..., 1], v[..., 2]

    def route_table(feat_s, thr_s, dl_s, Sp, cat_flag, cat_mask):
        """The level's W on the kernel layout."""
        if bundle_cols:
            return build_route_table_bundled(
                feat_s, thr_s, dl_s, meta.num_bin, meta.missing_type,
                meta.default_bin, bundle_cfg.default_bin,
                bundle_cfg.col_of_feat, bundle_cfg.offset_of_feat,
                bundle_cols, bundle_col_bins, cat_flag=cat_flag,
                cat_mask=cat_mask)
        W = build_route_table(feat_s, thr_s, dl_s, meta.num_bin,
                              meta.missing_type, meta.default_bin, Sp, f_oh,
                              B, cat_flag=cat_flag, cat_mask=cat_mask)
        return pack_route_table(W, packed) if packed is not None else W

    kmask = None
    if mask_onehot:
        keep0 = packed.feat_order[0] if packed is not None else 0
        kmask = feature_mask.clone()
        kmask[0] = True
        kmask[keep0] = True
    R = num_rows or Rp
    leaf_T = torch.where(torch.arange(Rp, device=dev)[None, :] < R, 0, -1) \
        .to(torch.int32)

    tree = empty_tree(L, B, dev)
    pool_g = torch.zeros((L, f_oh, B), dtype=torch.float32, device=dev)
    pool_h = torch.zeros_like(pool_g)
    pool_c = torch.zeros_like(pool_g)

    # ---- root pass: slot 0 collects the full-data histogram (W0[0, the
    # first kernel row's slab] = 1 sends every row "left" on slot 0);
    # skipped when the previous iteration's epilogue already built it
    Sp0 = 8
    if root_hist is not None:
        hist0 = root_hist
    else:
        w0_span = packed.widths[0] if packed is not None else k_B
        W0 = torch.zeros((Sp0, kern_fb), dtype=torch.bfloat16, device=dev)
        W0[0, :w0_span] = 1
        tbl0 = torch.zeros((Sp0, 128), dtype=torch.int32, device=dev)
        tbl0[1:, 0] = -2
        tbl0[0, 2] = 1
        hist0, _ = level_pass(bins_T, leaf_T, gh_T, W0, tbl0, kmask,
                              num_bins=k_B, f_oh=k_foh, nch=nch,
                              quant_bits=quant_bits, packed=packed)
        # feature mode: rows are replicated, the local histogram is the
        # global one; voting: the root is a full exchange
        if group is not None and parallel_mode != "feature":
            hist0 = record_psum(hist0, group)
    g0, h0, c0 = decode(hist0, Sp0)
    pool_g[0] = g0[0]
    pool_h[0] = h0[0]
    pool_c[0] = c0[0]
    root_g = g0[0, 0, :].sum()
    root_h = h0[0, 0, :].sum()
    root_c = c0[0, 0, :].sum()
    root_out = calculate_leaf_output(root_g, root_h, params, root_c, 0.0)
    tree.leaf_value[0] = root_out
    tree.leaf_count[0] = root_c
    tree.leaf_weight[0] = root_h

    leaf_groups = torch.full((L,), -1, dtype=torch.int32, device=dev)
    mono = None
    if use_mono_bounds:
        # per-leaf output bounds, and the intermediate mode's bin-space
        # regions over the logical features; padded features (num_bin 0)
        # get a fake [0, 1) region so they always overlap
        mono = (torch.full((L,), float("-inf"), device=dev),
                torch.full((L,), float("inf"), device=dev),
                torch.zeros((L, f_oh), dtype=torch.int32, device=dev),
                torch.clamp(meta.num_bin, min=1).to(torch.int32)[None, :]
                .expand(L, f_oh).clone())
    feat_par = group is not None and parallel_mode == "feature"
    vote_live = (group is not None and parallel_mode == "voting"
                 and min(f_oh, 2 * top_k) < f_oh)
    if vote_live and (packed is not None or bundle_cols):
        raise ValueError("the fused voting exchange runs on the padded "
                         "unbundled layout (no packed layout, no bundles)")
    root_mask = feature_mask[None, :]
    if feat_par:
        root_mask = root_mask & feature_shard_mask[None, :]
    if node_masks is not None:
        root_mask = root_mask & node_feature_mask(
            node_masks, leaf_groups[:1],
            torch.zeros(1, dtype=torch.int32, device=dev))
    root_best = best_split_cm(
        g0[:1], h0[:1], c0[:1], meta.num_bin, meta.missing_type,
        meta.default_bin, root_mask, meta_is_cat(meta), params,
        tree.leaf_value[:1], cat_idx=cat_idx,
        **(_bounds_kw(meta, mono[0][:1], mono[1][:1], tree.leaf_depth[:1])
           if mono is not None else {}))
    if feat_par:
        root_best = merge_best_over_shards(root_best, group, 0)
    best = map_split(lambda a: torch.cat(
        [a[:1], torch.zeros((L - 1,) + a.shape[1:], dtype=a.dtype,
                            device=dev)]), root_best)
    best = best._replace(gain=torch.cat(
        [best.gain[:1], torch.full((L - 1,), NEG_INF, device=dev)]))

    lpn = torch.full((L,), -1, dtype=torch.int32, device=dev)  # leaf->parent
    lil = torch.zeros((L,), dtype=torch.bool, device=dev)      # is left child
    # deferred final-route tables, padded to the widest level. At most one
    # route-only pass fires per tree: after it no level selects a split
    Sp_max = max([8] + [max(8, c) for c in caps])
    deferred = ([torch.zeros((Sp_max, kern_fb), dtype=torch.bfloat16,
                             device=dev),
                 torch.zeros((Sp_max, 128), dtype=torch.int32, device=dev)]
                if defer_final_route else None)
    if deferred is not None:
        deferred[1][:, 0] = -2
    # voting: which (leaf, feature) pool entries hold global sums
    pool_valid = (torch.ones((L, f_oh), dtype=torch.bool, device=dev)
                  if vote_live else None)
    dist_kw = {"group": group, "vote_live": vote_live, "top_k": top_k,
               "feature_shard_mask": feature_shard_mask if feat_par
               else None}
    state = (tree, leaf_T, pool_g, pool_h, pool_c, best, lpn, lil,
             leaf_groups, mono, pool_valid)
    for li, S_d in enumerate(caps):
        state = _one_level(state, bins_T, gh_T, meta, feature_mask, params,
                           L, B, (k_foh, k_B), S_d, nch, max_depth,
                           li == len(caps) - 1, deferred, decode, kmask,
                           quant_bits, packed, node_masks, cat_idx,
                           route_table, mono_mode == "intermediate",
                           **dist_kw)
    tree, leaf_T = state[0], state[1]
    if deferred is not None:
        return tree, leaf_T[0], deferred[0], deferred[1]
    return tree, leaf_T[0]


def _bounds_kw(meta, lo, hi, depth):
    """The split search's monotone arguments for slots with bounds
    ``lo``/``hi`` and depths ``depth``."""
    return {"monotone": meta.monotone, "bound_lo": lo, "bound_hi": hi,
            "leaf_depth": depth}


def _one_level(state, bins_T, gh_T, meta, feature_mask, params, L, B,
               kernel, S_d, nch, max_depth, is_last, deferred, decode, kmask,
               quant_bits, packed, node_masks, cat_idx, route_table, inter,
               group=None, vote_live=False, top_k=20,
               feature_shard_mask=None):
    (tree, leaf_T, pool_g, pool_h, pool_c, best, lpn, lil,
     leaf_groups, mono, pool_valid) = state
    inter = inter and mono is not None
    dev = bins_T.device
    Sp = max(8, S_d)
    slots = torch.arange(L, dtype=torch.int32, device=dev)
    nl = tree.num_leaves

    gains = _masked_gain(best.gain, tree.leaf_depth, nl, max_depth, L)
    budget = L - nl
    # stable, like jnp.argsort: slot order on tied gains decides the tree
    order = torch.argsort(-gains, stable=True)
    rank = torch.empty(L, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(L, device=dev)
    selected = (gains > 0.0) & (rank < budget) & (rank < S_d)
    n_sel = int(selected.sum())          # the level's one host sync
    host_syncs["count"] += 1
    if n_sel == 0:
        return state
    # once the leaf budget is spent by this level's splits (or no pass
    # follows), no split search runs again: route rows, skip histograms
    route_only = is_last or budget - n_sel <= 0

    sel_i32 = selected.to(torch.int32)
    k_of_leaf = torch.cumsum(sel_i32, 0, dtype=torch.int32) - sel_i32
    new_of_leaf = torch.where(selected, nl + k_of_leaf, -1).to(torch.int32)
    node_of_leaf = torch.where(selected, nl - 1 + k_of_leaf, -1) \
        .to(torch.int32)

    # ---- slot tables (leaf_of_slot = -2 marks inactive slots so they can
    # never match the -1 of padding rows)
    lof = _masked_scatter(
        torch.full((Sp,), -2, dtype=torch.int32, device=dev),
        torch.clamp(k_of_leaf, max=Sp - 1), slots,
        selected & (k_of_leaf < Sp))
    lof_on = lof >= 0
    lof_safe = torch.clamp(lof, min=0).long()
    feat_s = torch.where(lof_on, best.feature[lof_safe], -1)
    thr_s = best.threshold[lof_safe]
    dl_s = best.default_left[lof_safe]
    small_left_s = best.left_count[lof_safe] <= best.right_count[lof_safe]
    new_s = torch.where(lof_on, nl + torch.arange(Sp, device=dev), 0)
    delta_s = torch.where(lof_on, new_s - lof_safe, 0)
    has_cat = cat_idx is not None
    W = route_table(feat_s, thr_s, dl_s, Sp,
                    best.cat_flag[lof_safe] & lof_on if has_cat else None,
                    best.cat_mask[lof_safe] if has_cat else None)
    k_foh, k_B = kernel
    tbl = torch.zeros((Sp, 128), dtype=torch.int32, device=dev)
    tbl[:, 0] = lof
    tbl[:, 1] = delta_s.to(torch.int32)
    tbl[:, 2] = small_left_s.to(torch.int32)

    if route_only and deferred is not None:
        # epilogue_pass applies this pass's routing; rows stay at the
        # assignment before it
        deferred[0][:Sp] = W
        deferred[1][:Sp] = tbl
        leaf_T2 = leaf_T
    elif route_only:
        leaf_T2 = route_pass(bins_T, leaf_T, W, tbl, num_bins=k_B,
                             f_oh=k_foh, packed=packed)
    else:
        hist, leaf_T2 = level_pass(bins_T, leaf_T, gh_T, W, tbl, kmask,
                                   num_bins=k_B, f_oh=k_foh, nch=nch,
                                   quant_bits=quant_bits, packed=packed)
        if vote_live:
            # the ranks rank their local per-feature gains on the smaller
            # children (each child's own output smooths them), and only
            # the winners' packed columns are summed, before the decode
            lg, lh, lc = decode(hist, Sp)
            zero = torch.zeros((), device=dev)
            sm_out = torch.where(
                small_left_s,
                torch.where(lof_on, best.left_output[lof_safe], zero),
                torch.where(lof_on, best.right_output[lof_safe], zero))
            vote_mask = feature_mask[None, :] & lof_on[:, None]
            gains = per_feature_gains_cm(
                lg, lh, lc, meta.num_bin, meta.missing_type,
                meta.default_bin, vote_mask, meta_is_cat(meta),
                meta.monotone, params, sm_out, cat_idx=cat_idx)
            hr, lvl_valid = vote_exchange(hist.reshape(k_foh, k_B, -1),
                                          gains, top_k, group, 0)
            hist = hr.reshape(k_foh * k_B, -1)
        elif group is not None and feature_shard_mask is None:
            hist = record_psum(hist, group)
        sm_g, sm_h, sm_c = decode(hist, Sp)
        # ---- sibling by subtraction from the parent pool
        par_g, par_h, par_c = pool_g[lof_safe], pool_h[lof_safe], \
            pool_c[lof_safe]
        sb_g, sb_h, sb_c = par_g - sm_g, par_h - sm_h, par_c - sm_c
        sl = small_left_s[:, None, None]
        left_g = torch.where(sl, sm_g, sb_g)
        left_h = torch.where(sl, sm_h, sb_h)
        left_c = torch.where(sl, sm_c, sb_c)
        right_g = torch.where(sl, sb_g, sm_g)
        right_h = torch.where(sl, sb_h, sm_h)
        right_c = torch.where(sl, sb_c, sm_c)
        for pool, lv, rv in ((pool_g, left_g, right_g),
                             (pool_h, left_h, right_h),
                             (pool_c, left_c, right_c)):
            _pool_write(pool, lof_safe, lv, lof_on)
            _pool_write(pool, new_s, rv, lof_on)
        if vote_live:
            # the exchanged side is valid where the vote summed it; the
            # subtracted side also needs a globally valid parent
            sm_v = lvl_valid[None, :].expand(Sp, -1)
            sb_v = pool_valid[lof_safe] & sm_v
            sl2 = small_left_s[:, None]
            left_v = torch.where(sl2, sm_v, sb_v)
            right_v = torch.where(sl2, sb_v, sm_v)
            pool_valid = _masked_scatter(pool_valid, lof_safe, left_v,
                                         lof_on)
            pool_valid = _masked_scatter(pool_valid, new_s, right_v, lof_on)

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

    mono_changed = None
    if inter:
        # the level's splits one at a time in slot order: clipped child
        # outputs replace the scan's, the bounds and regions follow
        (new_leaf_value, leaf_lo2, leaf_hi2, reg_lo2, reg_hi2,
         mono_changed) = mono_inter_level_update(
            tree.leaf_value, mono[0], mono[1], mono[2], mono[3], selected,
            k_of_leaf, best.feature, best.threshold, best.cat_flag,
            best.left_output, best.right_output, meta.monotone, nl, n_sel)
        mono2 = (leaf_lo2, leaf_hi2, reg_lo2, reg_hi2)
    else:
        new_leaf_value = upd2(tree.leaf_value, best.left_output,
                              best.right_output)
        mono2 = mono
        if mono is not None:
            # basic mode: both children fenced at the mid of their outputs
            # (a categorical split has no direction)
            mono_dir = torch.where(
                best.feature >= 0,
                meta.monotone[best.feature.clamp(min=0).long()], 0)
            if best.cat_flag is not None:
                mono_dir = torch.where(best.cat_flag, 0, mono_dir)
            mono2 = mono_child_bounds(
                mono[0], mono[1], selected, mono_dir, best.left_output,
                best.right_output, slots, new_of_leaf) + mono[2:]
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
        leaf_value=new_leaf_value,
        leaf_count=upd2(tree.leaf_count, best.left_count, best.right_count),
        leaf_weight=upd2(tree.leaf_weight, best.left_sum_hess,
                         best.right_sum_hess),
        leaf_depth=upd2(tree.leaf_depth, new_depth, new_depth),
    )
    if has_cat:
        tree2 = tree2._replace(cat_flag=w(tree.cat_flag, best.cat_flag),
                               cat_mask=w(tree.cat_mask, best.cat_mask))

    if node_masks is not None:
        leaf_groups2 = update_leaf_groups(node_masks, leaf_groups,
                                          best.feature, selected, slots,
                                          new_of_leaf)
    else:
        leaf_groups2 = leaf_groups

    if route_only:
        # no split search will ever run again; bar the fresh leaves (and
        # the reused parent slots) from re-selection
        neg = torch.full((L,), NEG_INF, device=dev)
        g2 = _masked_scatter(best.gain, slots, neg, selected)
        g2 = _masked_scatter(g2, new_of_leaf, neg, selected)
        return (tree2, leaf_T2, pool_g, pool_h, pool_c,
                best._replace(gain=g2), lpn2, lil2, leaf_groups2, mono2,
                pool_valid)

    # ---- best splits for the 2*Sp fresh children only; each child's own
    # post-split output is the parent_output of its prospective children
    # (ref: feature_histogram.hpp FindBestThreshold parent_output); the
    # intermediate mode reads the clipped outputs from the tree
    zero = torch.zeros((), device=dev)
    outs = ((tree2.leaf_value[lof_safe], tree2.leaf_value[new_s]) if inter
            else (best.left_output[lof_safe], best.right_output[lof_safe]))
    left_out = torch.where(lof_on, outs[0], zero)
    right_out = torch.where(lof_on, outs[1], zero)
    ch_mask = feature_mask[None, :]
    if vote_live:
        # the scans must not read local-only (unexchanged) columns
        ch_mask = ch_mask & torch.cat([left_v, right_v])
    if feature_shard_mask is not None:
        ch_mask = ch_mask & feature_shard_mask[None, :]
    if node_masks is not None:
        ch_groups = torch.cat([leaf_groups2[lof_safe], leaf_groups2[new_s]])
        # per-node sampling identity: the creating node's id and side bit
        node = node_of_leaf[lof_safe]
        ch_ids = torch.cat([2 * (node + 1) + 1, 2 * (node + 1)])
        ch_mask = ch_mask & node_feature_mask(node_masks, ch_groups, ch_ids)
    bounds = {}
    if mono2 is not None:
        ch = lambda a: torch.cat([a[lof_safe], a[new_s]])  # noqa: E731
        bounds = _bounds_kw(meta, ch(mono2[0]), ch(mono2[1]),
                            ch(tree2.leaf_depth))
    bs = best_split_cm(
        torch.cat([left_g, right_g]), torch.cat([left_h, right_h]),
        torch.cat([left_c, right_c]), meta.num_bin, meta.missing_type,
        meta.default_bin, ch_mask, meta_is_cat(meta), params,
        torch.cat([left_out, right_out]), cat_idx=cat_idx, **bounds)
    if feature_shard_mask is not None:
        # the level's SyncUpGlobalBestSplit over the column shards (ref:
        # parallel_tree_learner.h:191)
        bs = merge_best_over_shards(bs, group, 0)
    left_bs = map_split(lambda a: a[:Sp], bs)
    right_bs = map_split(lambda a: a[Sp:], bs)
    best2 = _merge_best_many(best, lof_safe, left_bs, lof_on)
    best2 = _merge_best_many(best2, new_s, right_bs, lof_on)
    if inter:
        # stale leaves: the leaves whose bounds the level tightened
        # without splitting them re-derive their best split from the pool
        # under the new bounds (ref: serial_tree_learner.cpp:706-714);
        # every leaf is rescanned and the changed ones take the result
        m = feature_mask[None, :]
        if node_masks is not None:
            m = m & node_feature_mask(node_masks, leaf_groups2,
                                      2 * (lpn2 + 1) + lil2.to(torch.int32))
        m = m.expand(L, -1)
        if pool_valid is not None:
            m = m & pool_valid
        if feature_shard_mask is not None:
            m = m & feature_shard_mask[None, :]
        bs_all = best_split_cm(
            pool_g, pool_h, pool_c, meta.num_bin, meta.missing_type,
            meta.default_bin, m, meta_is_cat(meta), params,
            tree2.leaf_value, cat_idx=cat_idx,
            **_bounds_kw(meta, mono2[0], mono2[1], tree2.leaf_depth))
        if feature_shard_mask is not None:
            bs_all = merge_best_over_shards(bs_all, group, 0)
        best2 = map_split(lambda old, new: torch.where(
            mono_changed if old.dim() == 1 else mono_changed[:, None], new,
            old), best2, bs_all)
    return (tree2, leaf_T2, pool_g, pool_h, pool_c, best2, lpn2, lil2,
            leaf_groups2, mono2, pool_valid)


def tree_score_delta(tree: TreeArrays, row_leaf: torch.Tensor, shrinkage,
                     num_rows: int = 0) -> torch.Tensor:
    """Per-row training-score delta of one freshly grown tree:
    ``shrinkage * leaf_value[row_leaf]`` through the lookup kernel; a
    dried-up tree (num_leaves <= 1) contributes 0 (the driver appends a
    constant tree for it instead, gbdt.cpp:421-437)."""
    n = num_rows or row_leaf.shape[0]
    if tree.num_leaves <= 1:
        return torch.zeros(n, dtype=torch.float32, device=row_leaf.device)
    shrink = torch.tensor(shrinkage, dtype=torch.float32)
    vals = table_lookup(row_leaf[None, :], tree.leaf_value * shrink)[0]
    return vals[:n]
