"""Tree learners of the XLA engine, and the helpers every grower shares.

PyTorch counterpart of ``lightgbm_tpu/models/learner.py``: the feature
metadata record, the collision-free masked scatter, the masked gain
vector, the per-node feature masks of interaction constraints and
``feature_fraction_bynode`` (``NodeMaskCfg``, whose by-node draws come
from the port's copy of ``jax.random``'s Threefry, ``utils/random.py``),
the monotone-constraint bookkeeping of the basic, intermediate and
advanced modes (``mono_child_bounds``, ``region_adjacency``,
``mono_inter_level_update``), CEGB's gain deltas (``cegb_delta_matrix``),
forced splits (``gather_split_info``), and the XLA engine's two growers:

- ``grow_tree_leafwise``: LightGBM's best-first growth (ref:
  serial_tree_learner.cpp:159-210): the root histogram, then ``L - 1``
  steps of argmax -> split -> partition the leaf's listed rows -> the
  smaller child's histogram from its list -> its sibling by subtraction
  -> the two children's scans. The rows are one index list grouped by
  leaf (``ops/data_partition.py``, the reference's ``DataPartition``), so
  a step reads only the split leaf's rows;
- ``grow_tree_depthwise``: frontier-batched growth: one histogram pass per
  level for every left child at once (``S = L`` slots), siblings by
  subtraction, the leaves ranked by gain (a stable sort) within the
  ``num_leaves`` budget.

The depth-wise grower, and the leaf-wise one's root, build their
histograms through ``ops/histogram.py`` (the unrounded f32 ``hist_pass``
on the card); the leaf-wise children through ``leaf_hist``. Neither
reads the device from the host
inside its loop: the JAX growers' ``lax.cond`` on ``do_split`` /
``n_sel > 0`` becomes a ``torch.where`` on every write (a step or level
with nothing to split leaves the state as it was, so the loops run a
fixed number of steps), and scalars live in one-element tensors. The
tree's leaf count is read once, after the loop.

The distributed branches take a process group (``group``) where the JAX
growers take ``psum_axis``; ``None`` is serial and makes no collective
call. Every rank runs the same loop and makes the same all-reduces, and every
branch (the split choice, ``do_split``, the smaller child) reads reduced
sums only:

- ``parallel_mode="data"``: rows sharded; each histogram (the root, the
  leaf-wise smaller child, the depth-wise level) is summed over the group
  (``ops/collectives.record_psum``) before anything reads it;
- ``"voting"``: rows sharded; the ranks rank their local per-feature
  gains, psum the int32 votes, and sum only the ``2 * top_k`` winners'
  columns (ties to the lower feature index, as ``jax.lax.top_k``); a
  per-leaf validity plane keeps later scans and the sibling subtraction
  off the columns that hold local sums only. The leaf-wise root is a full
  exchange, the depth-wise root a vote, as in the JAX package;
- ``"feature"`` (depth-wise): rows replicated, each rank histograms and
  scans its column slice, and the best splits are merged over the group
  (``merge_best_over_shards``); rows route on ``route_bins`` /
  ``route_meta``, the full matrix.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.collectives import record_pmax, record_pmin, record_psum
from ..ops.data_partition import leaf_hist, leaf_partition
from ..ops.histogram import hist_bins, histogram_planes, histogram_subtract
from ..ops.split import (BestSplit, SplitParams, best_split_cm,
                         calculate_leaf_output, leaf_gain, map_split,
                         per_feature_gains_cm)
from ..utils import random as ref_random
from .tree import TreeArrays, empty_tree

NEG_INF = float("-inf")


class FeatureMeta(NamedTuple):
    """Per-feature metadata tensors (on the training device)."""
    num_bin: torch.Tensor                  # int32 [F]
    missing_type: torch.Tensor             # int32 [F]
    default_bin: torch.Tensor              # int32 [F]
    monotone: torch.Tensor                 # int32 [F]
    is_cat: Optional[torch.Tensor] = None  # bool  [F] (None = all numerical)


def meta_is_cat(meta: FeatureMeta) -> torch.Tensor:
    if meta.is_cat is None:
        return torch.zeros(meta.num_bin.shape, dtype=torch.bool,
                           device=meta.num_bin.device)
    return meta.is_cat


class BundleCfg(NamedTuple):
    """Device tensors mapping logical features onto EFB bundle columns
    (from ops/efb.BundleLayout; lightgbm_tpu/models/learner.py:191-209).

    flat_idx: [F, B] int32 — index into the flattened [C*B_col] bundle
      histogram of each (feature, bin); invalid bins point at slot 0 and
      are masked by ``valid``.
    valid: [F, B] bool.
    default_bin: [F] int32 — each feature's most-frequent bin, which takes
      the FixHistogram residual mass.
    col_of_feat / offset_of_feat: [F] int32 — the routing decode.
    """
    flat_idx: torch.Tensor
    valid: torch.Tensor
    default_bin: torch.Tensor
    col_of_feat: torch.Tensor
    offset_of_feat: torch.Tensor


def bundle_views(bundle_hist: torch.Tensor, cfg: BundleCfg) -> torch.Tensor:
    """[S, C, Bc, ch] bundle histograms -> [S, F, B, ch] logical views with
    the FixHistogram default-bin residual (ref: dataset.cpp:1265), through
    ops/fused_level.bundle_plane_views. The JAX package's learner has the
    same entry (its tests hold the two equal); the port's grower calls
    bundle_plane_views on the flat plane directly."""
    from ..ops.fused_level import bundle_plane_views
    return bundle_plane_views(bundle_hist, cfg.flat_idx, cfg.valid,
                              cfg.default_bin)


def _masked_scatter(arr: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """``arr[idx[k]] = vals[k] where mask[k]``, out of place, without write
    collisions: masked-out writes are routed to a padding slot that is
    dropped, because a scatter with duplicate indices lands in an
    unspecified order (on CUDA as under XLA)."""
    pad = torch.zeros((1,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                      device=arr.device)
    ext = torch.cat([arr, pad])
    safe_idx = torch.where(mask, idx.long(),
                           torch.full_like(idx, arr.shape[0],
                                           dtype=torch.long))
    ext[safe_idx] = vals.to(arr.dtype)
    return ext[:-1]


def _masked_gain(gain: torch.Tensor, leaf_depth: torch.Tensor,
                 num_leaves: int, max_depth: int,
                 max_leaves: int) -> torch.Tensor:
    """Gain vector with inactive and over-deep leaves masked out."""
    slot = torch.arange(max_leaves, device=gain.device)
    g = torch.where(slot < num_leaves, gain, NEG_INF)
    if max_depth > 0:
        g = torch.where(leaf_depth >= max_depth, NEG_INF, g)
    return g


class NodeMaskCfg(NamedTuple):
    """Per-node feature-mask machinery (ref: col_sampler.hpp:20 ColSampler
    — interaction-constraint filtering and feature_fraction_bynode).

    group_feat: [G, F] bool — the constraint groups (one all-True row
      without interaction constraints).
    groups_with_f: [F] int32 — bitmask of the groups holding each feature.
    bynode_k: features sampled per node (0 = off).
    key: [2] int64 Threefry key of the by-node draws.
    """
    group_feat: torch.Tensor
    groups_with_f: torch.Tensor
    bynode_k: int
    key: torch.Tensor


def make_node_mask_cfg(num_features: int, interaction_constraints,
                       bynode_fraction: float, seed: int,
                       device=None) -> NodeMaskCfg:
    groups = [list(g) for g in (interaction_constraints or [])]
    if not groups:
        gf = np.ones((1, num_features), bool)
    else:
        if len(groups) > 31:
            raise ValueError("at most 31 interaction constraint groups are "
                             "supported")
        gf = np.zeros((len(groups), num_features), bool)
        for gi, g in enumerate(groups):
            for f in g:
                if 0 <= int(f) < num_features:
                    gf[gi, int(f)] = True
    gwf = np.zeros((num_features,), np.int32)
    for gi in range(gf.shape[0]):
        gwf |= np.where(gf[gi], np.int32(1 << gi), 0).astype(np.int32)
    k = 0
    if 0.0 < bynode_fraction < 1.0:
        k = max(1, int(round(num_features * bynode_fraction)))
    return NodeMaskCfg(
        group_feat=torch.as_tensor(gf, device=device),
        groups_with_f=torch.as_tensor(gwf, device=device),
        bynode_k=k,
        key=ref_random.prng_key(seed, device))


def node_feature_mask(cfg: NodeMaskCfg, leaf_groups: torch.Tensor,
                      node_ids: torch.Tensor) -> torch.Tensor:
    """[L, F] allowed-feature mask of each leaf: the union of the
    constraint groups still compatible with the leaf's path, intersected
    with a per-node random sample of ``bynode_k`` features when that is on
    (``node_ids`` [L] name the node each leaf was created by, so a leaf's
    sample holds for its whole life). The k-th smallest draw among the
    allowed features is found by a sort, as in the JAX package: every
    allowed feature whose draw is at most that value stays."""
    G, F = cfg.group_feat.shape
    L = leaf_groups.shape[0]
    shifts = torch.arange(G, dtype=torch.int32, device=leaf_groups.device)
    bits = ((leaf_groups[:, None] >> shifts) & 1).to(torch.float32)
    allowed = (bits @ cfg.group_feat.to(torch.float32)) > 0     # [L, F]
    k = cfg.bynode_k
    if k <= 0:
        return allowed
    keys = ref_random.fold_in(cfg.key, node_ids.to(torch.int64))
    r = ref_random.uniform(keys, F)
    r = torch.where(allowed, r, torch.inf)
    kth = torch.sort(r, dim=1).values[
        torch.arange(L, device=r.device), min(max(k - 1, 0), F - 1)]
    return allowed & (r <= kth[:, None])


def update_leaf_groups(cfg: NodeMaskCfg, leaf_groups: torch.Tensor,
                       split_feature: torch.Tensor, sel: torch.Tensor,
                       left_idx: torch.Tensor,
                       new_idx: torch.Tensor) -> torch.Tensor:
    """Children's group-compatibility bitmasks: the parent's, and the
    groups holding the split feature (both children take the same set)."""
    f_safe = torch.clamp(split_feature, min=0).long()
    child = leaf_groups & torch.where(split_feature >= 0,
                                      cfg.groups_with_f[f_safe], -1)
    out = _masked_scatter(leaf_groups, left_idx, child, sel)
    return _masked_scatter(out, new_idx, child, sel)


def mono_child_bounds(lo, hi, sel, mono_dir, left_output, right_output,
                      left_idx, new_idx):
    """Per-leaf output bounds after a level's splits, the reference's
    BASIC rule (ref: monotone_constraints.hpp:488-500
    BasicLeafConstraints::Update; lightgbm_tpu/models/learner.py:239-261):
    both children are fenced at mid = (left_out + right_out) / 2, so every
    later leaf of the left subtree stays <= mid <= every leaf of the right
    one (m < 0 mirrored); a split on a feature without a direction passes
    the parent's bounds on. All tensors [L]; ``sel`` marks the leaves split
    this level, ``left_idx``/``new_idx`` their children's slots."""
    par_lo = lo[left_idx.long()]
    par_hi = hi[left_idx.long()]
    mid = 0.5 * (left_output + right_output)
    l_hi = torch.where(mono_dir > 0, torch.minimum(par_hi, mid), par_hi)
    l_lo = torch.where(mono_dir < 0, torch.maximum(par_lo, mid), par_lo)
    r_lo = torch.where(mono_dir > 0, torch.maximum(par_lo, mid), par_lo)
    r_hi = torch.where(mono_dir < 0, torch.minimum(par_hi, mid), par_hi)
    lo2 = _masked_scatter(_masked_scatter(lo, left_idx, l_lo, sel),
                          new_idx, r_lo, sel)
    hi2 = _masked_scatter(_masked_scatter(hi, left_idx, l_hi, sel),
                          new_idx, r_hi, sel)
    return lo2, hi2


def region_adjacency(q_lo, q_hi, c_lo, c_hi, mask, monotone,
                     per_dim: bool = False):
    """Monotone region adjacency of every leaf box q against C child boxes
    (lightgbm_tpu/models/learner.py:263-294, the vectorized form of the
    reference's GoUp/GoDown contiguity walk): the boxes overlap on every
    feature but one monotone feature g, and q lies strictly beyond the
    child on g. q_lo/q_hi [L, F] bin-space boxes, c_lo/c_hi [C, F], mask
    [L] or [L, C] (which q count), monotone [F]. Returns (up, dn) [L, C]
    bool: q lies above (up) or below (dn) the child in its feature's
    direction; with ``per_dim`` [L, C, F] masks (the advanced mode builds
    its shadow planes from the adjacency feature)."""
    F = q_lo.shape[1]
    ql, qh = q_lo[:, None, :], q_hi[:, None, :]
    cl, ch = c_lo[None, :, :], c_hi[None, :, :]
    ov = (ql < ch) & (cl < qh)                              # [L, C, F]
    ov_i = ov.to(torch.int32)
    ov_except = (ov_i.sum(2, keepdim=True) - ov_i) == (F - 1)
    m = mask[:, None] if mask.dim() == 1 else mask
    gate = ov_except & m[:, :, None]
    above = gate & (ql >= ch)
    below = gate & (qh <= cl)
    d = monotone[None, None, :]
    up = ((d > 0) & above) | ((d < 0) & below)
    dn = ((d > 0) & below) | ((d < 0) & above)
    if per_dim:
        return up, dn
    return up.any(2), dn.any(2)


def mono_inter_level_update(leaf_value, leaf_lo, leaf_hi, reg_lo, reg_hi,
                            selected, k_of_leaf, feature, threshold,
                            cat_flag, left_out, right_out, monotone,
                            num_leaves_before, n_splits: int,
                            guard: bool = False):
    """The intermediate mode's bookkeeping for one level of simultaneous
    splits (ref: monotone_constraints.hpp:514 IntermediateLeafConstraints;
    lightgbm_tpu/models/learner.py:296-403): raw-output fences,
    region-aware clipping of each fresh child's output against the
    region-adjacent leaves, and the cross-tightening of the other leaves'
    bounds. The splits run one at a time in slot order (``k_of_leaf``, the
    gain rank), as the JAX package's ``fori_loop`` over the level's slots
    does; the loop here runs only over the level's ``n_splits`` (a host
    int), whose every step has a split, with no host read. With ``guard``
    (the XLA depth-wise grower, which reads no split count on the host)
    ``n_splits`` is a bound, ``num_leaves_before`` may be a device scalar,
    and a step without a split (the JAX package's ``has``) writes nothing.
    Every step is min/max/select, so the result is bit-equal to the JAX
    package's.

    All tensors are [L]-sized ([L, F] for the regions; ``cat_flag`` None
    when nothing is categorical); the k-th split's right child gets slot
    ``num_leaves_before + k``. Returns (leaf_value2, lo2, hi2, reg_lo2,
    reg_hi2, changed): ``changed`` marks the leaves that existed before
    the level, were not split by it, and whose bounds tightened (their
    cached best splits are stale)."""
    L, F = reg_lo.shape
    dev = reg_lo.device
    slots = torch.arange(L, device=dev)
    f_iota = torch.arange(F, device=dev)
    lv, lo, hi = leaf_value.clone(), leaf_lo.clone(), leaf_hi.clone()
    rlo, rhi = reg_lo.clone(), reg_hi.clone()
    changed = torch.zeros(L, dtype=torch.bool, device=dev)
    inf = torch.full((), float("inf"), device=dev)
    for k in range(n_splits):
        hit = selected & (k_of_leaf == k)
        l = torch.argmax(hit.to(torch.int32)).reshape(1)
        if guard:
            has = hit.any().reshape(1)
            new = torch.clamp(torch.as_tensor(num_leaves_before, device=dev)
                              .reshape(1).long() + k, max=L - 1)
        else:
            new = num_leaves_before + k

        def put(t, idx, val):
            """t[idx] = val (a [1]-row), skipped where the step has no
            split."""
            if not guard:
                t[idx] = val
                return
            t.index_copy_(0, idx, torch.where(
                has.reshape((1,) + (1,) * (t.dim() - 1)), val.reshape(
                    (1,) + tuple(t.shape[1:])), t[idx]))
        f = feature[l].clamp(min=0).long()
        is_num = (~cat_flag[l] if cat_flag is not None
                  else torch.ones(1, dtype=torch.bool, device=dev))
        mono_d = torch.where(is_num, monotone[f], 0)
        # regions: a numerical split cuts the parent's box at t + 1 on f
        parent_lo, parent_hi = rlo[l], rhi[l]                    # [1, F]
        cut = (f_iota[None, :] == f[:, None]) & is_num[:, None]
        t1 = threshold[l][:, None] + 1
        l_hi_r = torch.where(cut, t1, parent_hi).to(rhi.dtype)
        n_lo_r = torch.where(cut, t1, parent_lo).to(rlo.dtype)
        put(rlo, new, n_lo_r[0])
        put(rhi, new, parent_hi[0])
        put(rhi, l, l_hi_r)
        c_lo = torch.cat([parent_lo, n_lo_r])
        c_hi = torch.cat([l_hi_r, parent_hi])
        # adjacency against the current leaves (the level's earlier
        # children included) other than the parent. Rows l and new are
        # masked out, so the regions as updated above give the same
        # answer the JAX package's pre- and post-update regions give in
        # its clipping and cross-tightening steps
        other = (slots < new) & (slots != l)
        q_up, q_dn = region_adjacency(rlo, rhi, c_lo, c_hi, other, monotone)
        qv = lv[:, None]
        c_hi_b = torch.where(q_up, qv, inf).amin(0)               # [2]
        c_lo_b = torch.where(q_dn, qv, -inf).amax(0)
        o_l = torch.clamp(left_out[l], c_lo_b[0:1], c_hi_b[0:1])
        o_n = torch.clamp(right_out[l], c_lo_b[1:2], c_hi_b[1:2])
        # the siblings' order must survive the independent clips
        o_n = torch.where(mono_d > 0, torch.maximum(o_n, o_l), o_n)
        o_n = torch.where(mono_d < 0, torch.minimum(o_n, o_l), o_n)
        put(lv, l, o_l)
        put(lv, new, o_n[0])
        # inherited bounds and raw-output fences (looser than basic's
        # mid), then the adjacency clip bounds, with the clipped outputs
        p_lo, p_hi = lo[l], hi[l]
        l_hi = torch.where(mono_d > 0, torch.minimum(p_hi, o_n), p_hi)
        l_lo = torch.where(mono_d < 0, torch.maximum(p_lo, o_n), p_lo)
        n_lo = torch.where(mono_d > 0, torch.maximum(p_lo, o_l), p_lo)
        n_hi = torch.where(mono_d < 0, torch.minimum(p_hi, o_l), p_hi)
        put(lo, l, torch.maximum(l_lo, c_lo_b[0:1]))
        put(lo, new, torch.maximum(n_lo, c_lo_b[1:2])[0])
        put(hi, l, torch.minimum(l_hi, c_hi_b[0:1]))
        put(hi, new, torch.minimum(n_hi, c_hi_b[1:2])[0])
        # cross-tighten the other leaves by the new (clipped) outputs
        co = torch.cat([o_l, o_n])[None, :]
        lo3 = torch.maximum(lo, torch.where(q_up, co, -inf).amax(1))
        hi3 = torch.minimum(hi, torch.where(q_dn, co, inf).amin(1))
        if guard:
            lo3 = torch.where(has, lo3, lo)
            hi3 = torch.where(has, hi3, hi)
        changed |= (lo3 > lo) | (hi3 < hi)
        lo, hi = lo3, hi3
    # the fresh children are rescanned by the level anyway
    changed &= (slots < num_leaves_before) & ~selected
    return lv, lo, hi, rlo, rhi, changed


# ----------------------------------------------------------- shared pieces
def best_split(hist: torch.Tensor, meta: FeatureMeta,
               feature_mask: torch.Tensor, params: SplitParams,
               parent_output: torch.Tensor, cat_idx=None,
               use_bounds: bool = False, bound_lo=None, bound_hi=None,
               leaf_depth=None, cegb_delta=None, bound_lo_plane=None,
               bound_hi_plane=None) -> BestSplit:
    """Channel-minor wrapper over the combined numerical + categorical
    scan (lightgbm_tpu/models/learner.py:54-68): ``hist`` [S, F, B, 3]."""
    return _best_planes(hist.permute(0, 3, 1, 2), meta, feature_mask,
                        params, parent_output, cat_idx, use_bounds,
                        bound_lo, bound_hi, leaf_depth, cegb_delta,
                        bound_lo_plane, bound_hi_plane, meta.monotone)


def _best_planes(planes, meta, feature_mask, params, parent_output,
                 cat_idx=None, use_bounds=False, bound_lo=None,
                 bound_hi=None, leaf_depth=None, cegb_delta=None,
                 bound_lo_plane=None, bound_hi_plane=None,
                 mono=None) -> BestSplit:
    """:func:`best_split` on the growers' pools, [S, 3, F, B]. The growers
    pass the monotone directions only where they hold constraints (an
    all-zero direction vector changes nothing)."""
    g, h, c = planes[:, 0], planes[:, 1], planes[:, 2]
    return best_split_cm(
        g, h, c, meta.num_bin, meta.missing_type, meta.default_bin,
        feature_mask, meta_is_cat(meta), params, parent_output,
        cat_idx=cat_idx, monotone=mono,
        bound_lo=bound_lo if use_bounds else None,
        bound_hi=bound_hi if use_bounds else None,
        leaf_depth=leaf_depth, cegb_delta=cegb_delta,
        bound_lo_plane=bound_lo_plane, bound_hi_plane=bound_hi_plane)


def gather_split_info(pool_leaf: torch.Tensor, f, t, meta: FeatureMeta,
                      params: SplitParams, parent_output) -> BestSplit:
    """The split record of a GIVEN (feature, threshold) from one leaf's
    histogram [F, B, 3] (lightgbm_tpu/models/learner.py:156-188; ref:
    feature_histogram.hpp GatherInfoForThresholdNumerical, used by forced
    splits): default_left False, so the missing bins ride right and stay
    out of the left sums. Fields are [1]-shaped (``f`` and ``t`` host ints
    or [1] tensors on the histogram's device); ``cat_mask`` is [1, B]."""
    dev = pool_leaf.device
    f = torch.as_tensor(f, device=dev).reshape(1).long()
    t = torch.as_tensor(t, device=dev).reshape(1).to(torch.int32)
    h = pool_leaf[f][0]                                         # [B, 3]
    B = h.shape[0]
    b_iota = torch.arange(B, dtype=torch.int32, device=dev)
    nb, mt, db = meta.num_bin[f], meta.missing_type[f], meta.default_bin[f]
    is_missing = (((mt == 1) & (b_iota == db))
                  | ((mt == 2) & (b_iota == nb - 1)))
    left_m = ((b_iota <= t) & ~is_missing)[:, None]
    tot = h.sum(0)
    lsum = torch.where(left_m, h, torch.zeros((), device=dev)).sum(0)
    lg, lh, lc = lsum[0:1], lsum[1:2] + 1e-15, lsum[2:3]
    rg = tot[0:1] - lg
    rh = tot[1:2] - lsum[1:2] + 1e-15
    rc = tot[2:3] - lc
    po = torch.as_tensor(parent_output, device=dev).reshape(1)
    lo = calculate_leaf_output(lg, lh, params, lc, po)
    ro = calculate_leaf_output(rg, rh, params, rc, po)
    shift = leaf_gain(tot[0:1], tot[1:2] + 2e-15, params, tot[2:3], po) \
        + params.min_gain_to_split
    gain = (leaf_gain(lg, lh, params, lc, po)
            + leaf_gain(rg, rh, params, rc, po) - shift)
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    return BestSplit(
        feature=f.to(torch.int32), threshold=t, default_left=no,
        gain=gain, left_output=lo, right_output=ro,
        left_sum_grad=lg, left_sum_hess=lh - 1e-15, left_count=lc,
        right_sum_grad=rg, right_sum_hess=rh - 1e-15, right_count=rc,
        cat_flag=no, cat_mask=torch.zeros((1, B), dtype=torch.bool,
                                          device=dev))


def cegb_delta_matrix(params: SplitParams, coupled_penalty, used_features,
                      leaf_counts, lazy_penalty=None, unused_cnt=None):
    """[S, F] CEGB gain delta (lightgbm_tpu/models/learner.py:220-236; ref:
    cost_effective_gradient_boosting.hpp:66 DetlaGain): tradeoff *
    penalty_split * the leaf's count, plus the one-time coupled cost of a
    feature no split has used yet, plus the lazy cost per row of the leaf
    whose path has not used the feature (``unused_cnt`` [S, F])."""
    split_pen = (params.cegb_tradeoff * params.cegb_penalty_split
                 * leaf_counts[:, None])
    feat_pen = params.cegb_tradeoff * torch.where(
        used_features, torch.zeros((), device=coupled_penalty.device),
        coupled_penalty)[None, :]
    delta = split_pen + feat_pen
    if lazy_penalty is not None:
        delta = delta + (params.cegb_tradeoff * lazy_penalty[None, :]
                         * unused_cnt)
    return delta


def _route_left(bins_col: torch.Tensor, t, default_left, nb, mt,
                db) -> torch.Tensor:
    """Binned split decision with missing routing (ref: dense_bin.hpp Split
    — the NaN bin and the zero bin follow default_left)."""
    b = bins_col.to(torch.int32)
    missing = ((mt == 1) & (b == db)) | ((mt == 2) & (b == nb - 1))
    return torch.where(missing, default_left, b <= t)


def merge_best_over_shards(bs: BestSplit, group, f_offset) -> BestSplit:
    """Global best split per slot across feature-parallel ranks
    (lightgbm_tpu/models/learner.py:415-440; ref: parallel_tree_learner.h:
    191 SyncUpGlobalBestSplit): MAX of the gain, MIN of the rank holding
    it (the earliest rank wins ties), then the SUM of the records masked
    to the winner's, its feature index made global with ``f_offset``."""
    import torch.distributed as dist
    g = bs.gain
    gmax = record_pmax(g, group)
    rank = dist.get_rank(group)
    big = torch.full_like(g, 1 << 30, dtype=torch.int32)
    winner = record_pmin(torch.where(g >= gmax, torch.full_like(big, rank),
                                     big), group)
    mine = winner == rank

    def pick(a):
        if a is None:
            return None
        m = mine.reshape((-1,) + (1,) * (a.dim() - 1))
        return record_psum(torch.where(m, a, torch.zeros_like(a)), group)

    feat_g = torch.where(bs.feature >= 0, bs.feature + int(f_offset),
                         torch.full_like(bs.feature, -1))
    return bs._replace(
        feature=pick(feat_g), gain=gmax,
        **{f: pick(getattr(bs, f)) for f in bs._fields
           if f not in ("gain", "feature")})


def _top_lower_first(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries of ``score``, the lower index
    first on ties (``jax.lax.top_k``'s order; ``torch.topk`` promises
    none)."""
    return torch.sort(-score.to(torch.int64), stable=True).indices[:k]


def vote_exchange(planes: torch.Tensor, gains: torch.Tensor, top_k: int,
                  group, fdim: int):
    """The voting exchange (ref: voting_parallel_tree_learner.cpp:151-184
    GlobalVoting + CopyLocalHistogram; lightgbm_tpu/models/learner.py:
    1057-1082): each slot's local top-``top_k`` features by ``gains``
    [S, F] vote, the int32 votes are summed over ``group``, and the
    ``min(F, 2 * top_k)`` winners' columns (axis ``fdim`` of ``planes``)
    are summed; the other columns come back zero. Returns (planes,
    valid [F] bool)."""
    F = gains.shape[1]
    k = min(top_k, F)
    kth = torch.sort(gains, 1).values[:, F - k][:, None]
    votes = (gains >= kth) & torch.isfinite(gains)
    votes = record_psum(votes.to(torch.int32), group)
    w_idx = _top_lower_first(votes.sum(0), min(F, 2 * top_k))
    sub = record_psum(planes.index_select(fdim, w_idx), group)
    out = torch.zeros_like(planes).index_copy_(fdim, w_idx, sub)
    valid = torch.zeros(F, dtype=torch.bool, device=planes.device)
    valid[w_idx] = True
    return out, valid


def _merge_best(best: BestSplit, idx: torch.Tensor, new: BestSplit,
                on: torch.Tensor) -> BestSplit:
    """``best`` with rows ``idx`` [k] replaced by ``new``'s k rows where
    ``on`` ([1] bool) holds (lightgbm_tpu/models/learner.py:443-446), in
    place."""
    def put(a, v):
        m = on.reshape((1,) + (1,) * (a.dim() - 1))
        a[idx] = torch.where(m, v.to(a.dtype), a[idx])
        return a
    return map_split(put, best, new)


def _views(planes: torch.Tensor, cfg: BundleCfg, F: int,
           B: int) -> torch.Tensor:
    """[3, S, C, Bc] bundle-column planes -> [3, S, F, B] logical ones
    (every (channel, slot) row decoded alone)."""
    _, S, C, Bc = planes.shape
    return bundle_views(planes.reshape(3 * S, C, Bc), cfg).reshape(3, S, F,
                                                                   B)


class _Hist:
    """The growers' histogram pass: ``[S, 3, F, B]`` planes of the rows of
    each slot, from the kernel's int32 bin copy; bundle columns decoded
    into logical features."""

    def __init__(self, bins, gh, F, B, impl, hist_bins_i32, bundle_cfg,
                 bundle_col_bins):
        if impl not in ("auto", "segment", "onehot"):
            raise ValueError(f"hist_impl must be auto, segment or onehot; "
                             f"got {impl!r}")
        self.cfg = bundle_cfg
        self.Bk = bundle_col_bins if bundle_cfg is not None else B
        self.Fk = bins.shape[1]
        self.kbins = (hist_bins_i32 if hist_bins_i32 is not None
                      else hist_bins(bins, self.Bk))
        self.gh = gh.to(torch.float32).contiguous()
        self.F, self.B = F, B

    def __call__(self, row_slot: torch.Tensor, S: int) -> torch.Tensor:
        h = histogram_planes(self.kbins, self.gh, row_slot.to(torch.int32),
                             num_slots=S, num_bins=self.Bk,
                             num_features=self.Fk)
        if self.cfg is not None:
            h = _views(h, self.cfg, self.F, self.B)
        return h.permute(1, 0, 2, 3)

    def leaf(self, order, leaf_begin, leaf_rows, leaf,
             ds) -> torch.Tensor:
        """[3, F, B] planes of the rows listed in ``leaf``'s segment of
        ``order`` (``ops/data_partition.leaf_hist``); zeros where ``ds``
        is false."""
        h = leaf_hist(self.kbins, self.gh, order, leaf_begin, leaf_rows,
                      leaf, ds, num_bins=self.Bk)[:, :self.Fk]
        if self.cfg is not None:
            h = _views(h[:, None], self.cfg, self.F, self.B)[:, 0]
        return h


def _window(raw, f_idx, meta: FeatureMeta, bundle_cfg):
    """Bundle-column values -> feature ``f_idx``'s bins: its window
    shifted to 0, every value outside it the feature's most-frequent bin
    (lightgbm_tpu/models/learner.py:719-728)."""
    off = bundle_cfg.offset_of_feat[f_idx]
    in_win = (raw >= off) & (raw < off + meta.num_bin[f_idx])
    return torch.where(in_win, raw - off, bundle_cfg.default_bin[f_idx])


def _route_bins(bins, f_idx, meta: FeatureMeta, bundle_cfg):
    """Each row's bin of feature ``f_idx`` ([1] for one split, or [R] per
    row): a gather from the logical bins, or from the bundle columns with
    the window decode."""
    R = bins.shape[0]
    if bundle_cfg is None:
        return bins.gather(1, f_idx.expand(R)[:, None].long())[:, 0] \
            .to(torch.int32)
    col = bundle_cfg.col_of_feat[f_idx].long()
    raw = bins.gather(1, col.expand(R)[:, None])[:, 0].to(torch.int32)
    return _window(raw, f_idx, meta, bundle_cfg)


def _left_table(kvals, fs, t, dl, cf, cm, meta: FeatureMeta, bundle_cfg,
                B: int) -> torch.Tensor:
    """[Bk] bool: whether a row whose kernel bin column holds each value of
    ``kvals`` (``arange(Bk)``) goes left under the split (feature ``fs``,
    threshold ``t``, default-left ``dl``, categorical flag ``cf`` and set
    ``cm``): the routing of ``_route_bins`` and ``_route_left`` with the
    category lookup, run over the Bk possible values instead of the R
    rows."""
    b = kvals if bundle_cfg is None else _window(kvals, fs, meta,
                                                 bundle_cfg)
    go_left = _route_left(b, t, dl, meta.num_bin[fs], meta.missing_type[fs],
                          meta.default_bin[fs])
    if cf is not None:
        go_left = torch.where(cf, cm[0][b.long().clamp(0, B - 1)], go_left)
    return go_left


def _rows_to_leaves(order, leaf_begin, leaf_rows) -> torch.Tensor:
    """row_leaf [R] int32 from the leaves' segments of ``order``: each
    position takes the leaf whose non-empty segment starts at or before
    it (the non-empty segments tile [0, R)), scattered to its row. On the
    device, with no host read."""
    R, L = order.shape[0], leaf_begin.shape[0]
    dev = order.device
    owner = torch.full((R + 1,), -1, dtype=torch.int32, device=dev)
    # empty leaves write at the dropped slot R (their begins may collide)
    start = torch.where(leaf_rows > 0, leaf_begin, R).long()
    owner[start] = torch.arange(L, dtype=torch.int32, device=dev)
    pos = torch.arange(R, device=dev)
    first = torch.cummax(torch.where(owner[:R] >= 0, pos, 0), 0).values
    row_leaf = torch.empty(R, dtype=torch.int32, device=dev)
    row_leaf[order.long()] = owner[first]
    return row_leaf


def _scan_mask(feature_mask, node_masks, lg_rows, node_ids):
    """[S, F] allowed features: the tree's mask, narrowed per node by the
    interaction groups and the by-node sample."""
    m = feature_mask[None, :]
    if node_masks is not None:
        m = m & node_feature_mask(node_masks, lg_rows, node_ids)
    return m.expand(lg_rows.shape[0], feature_mask.shape[0])


def _root(hist, tree, params, exchange=None):
    """The root's histogram [3, F, B] into the tree's leaf 0, through the
    grower's ``exchange`` under a group; returns it and its valid [F]
    columns (None where every column holds global sums)."""
    R = hist.gh.shape[0]
    root = hist(torch.zeros(R, dtype=torch.int32, device=hist.gh.device),
                1)
    valid = None
    if exchange is not None:
        root, valid = exchange(root, torch.zeros(1, device=root.device))
    root = root[0]
    rg, rh, rc = root[0, 0].sum(), root[1, 0].sum(), root[2, 0].sum()
    tree.leaf_value[0] = calculate_leaf_output(rg, rh, params, rc, 0.0)
    tree.leaf_count[0] = rc
    tree.leaf_weight[0] = rh
    return root, valid


def _finish(tree: TreeArrays, nl: torch.Tensor) -> TreeArrays:
    """The grown tree with its leaf count on the host: the tree's one host
    read, after the loop (counted in ``frontier2.host_syncs``)."""
    from .frontier2 import host_syncs    # frontier2 imports this module
    host_syncs["count"] += 1
    return tree._replace(num_leaves=int(nl))


# ------------------------------------------------------- leaf-wise grower
def grow_tree_leafwise(bins: torch.Tensor, gh: torch.Tensor,
                       meta: FeatureMeta, feature_mask: torch.Tensor,
                       params: SplitParams, num_leaves: int, max_bins: int,
                       max_depth: int = -1, hist_impl: str = "auto",
                       cat_idx=None, use_mono_bounds: bool = False,
                       node_masks: NodeMaskCfg = None,
                       forced_leaf=None, forced_feat=None, forced_thr=None,
                       bundle_cfg: BundleCfg = None,
                       bundle_col_bins: int = 0, mono_mode: str = "basic",
                       hist_bins_i32: torch.Tensor = None, group=None,
                       parallel_mode: str = "data", top_k: int = 20):
    """Grow one tree best-first (lightgbm_tpu/models/learner.py:479-986).

    Args:
      bins: [R, F] binned rows (uint8/uint16), or [R, C] int16 bundle
        columns with ``bundle_cfg`` (then F is the logical count of
        ``bundle_cfg.flat_idx``).
      gh: [R, 3] float32 (grad, hess, count weight).
      meta: FeatureMeta of the F logical features.
      feature_mask: [F] bool.
      num_leaves, max_bins, max_depth: L, B and the depth limit.
      hist_impl: "auto", "segment" or "onehot" (the same sums).
      cat_idx: the categorical features' indices (None: all numerical).
      use_mono_bounds, mono_mode: monotone bounds, "basic",
        "intermediate" or "advanced".
      node_masks: NodeMaskCfg with the iteration's key folded, or None.
      forced_leaf/forced_feat/forced_thr: the forced-split schedule (int64
        tensors on the device, BFS order), or None.
      hist_bins_i32: the kernel's int32 copy of ``bins``
        (``ops.histogram.hist_bins``), kept per dataset; made here if None.
      group, parallel_mode, top_k: the distributed learner (module
        docstring): rows sharded over ``group`` under "data" or "voting";
        None is serial.

    State on the device, per tree (``ops/data_partition.py``): ``order``
    int32 [R], the row ids grouped by leaf, in row order within a leaf;
    ``leaf_begin`` and ``leaf_rows`` int32 [L], each leaf's segment of it
    (zero-weight rows included); and an int32 [R] scratch list. The root's
    segment is ``arange(R)``. Each step splits leaf l1's segment stably
    (``leaf_partition``, from the split's decision per kernel bin value,
    ``_left_table``) and histograms the smaller child, chosen on the
    weighted counts, from its segment (``leaf_hist``); a step that does not
    split leaves the lists as they were. The loop reads nothing on the
    host.

    Returns (TreeArrays, row_leaf [R] int32): row_leaf is built once after
    the loop from the lists (``_rows_to_leaves``), equal element for
    element to the per-row leaf vector the JAX grower rewrites each step.
    """
    R = bins.shape[0]
    dev = bins.device
    F = bundle_cfg.flat_idx.shape[0] if bundle_cfg is not None \
        else bins.shape[1]
    L, B = num_leaves, max_bins
    hist = _Hist(bins, gh, F, B, hist_impl, hist_bins_i32, bundle_cfg,
                 bundle_col_bins)
    n_forced = 0 if forced_leaf is None else len(forced_leaf)
    inter = use_mono_bounds and mono_mode in ("intermediate", "advanced")
    adv = use_mono_bounds and mono_mode == "advanced"
    slots = torch.arange(L, device=dev)
    f_iota = torch.arange(F, device=dev)
    inf = torch.full((), float("inf"), device=dev)
    mono = meta.monotone if use_mono_bounds else None
    # the per-step constants, made on the device before the loop (a tensor
    # copied from the host inside it would wait for the device): the
    # children's is-left flags and by-node sampling ids (2 (i + 1) + 1 and
    # 2 (i + 1))
    left_right = torch.arange(2, device=dev) == 0
    child_ids = 2 * torch.arange(1, L, device=dev)[:, None] \
        + left_right.long()[None, :]

    tree = empty_tree(L, B, dev)
    # the rows as one list grouped by leaf (ops/data_partition.py; ref:
    # data_partition.hpp): the root's segment is every row, in row order
    order = torch.arange(R, dtype=torch.int32, device=dev)
    scratch = torch.empty(R, dtype=torch.int32, device=dev)
    leaf_begin = torch.zeros(L, dtype=torch.int32, device=dev)
    leaf_rows = torch.zeros(L, dtype=torch.int32, device=dev)
    leaf_rows[:1].fill_(R)       # fill_: no copy from the host
    kvals = torch.arange(hist.Bk, dtype=torch.int32, device=dev)
    pool = torch.zeros((L, 3, F, B), dtype=torch.float32, device=dev)
    # the root is a full exchange under every mode
    pool[0] = _root(hist, tree, params, None if group is None else (
        lambda planes, _: (record_psum(planes, group), None)))[0]
    # voting: which pool columns hold global sums (the root's all do)
    voting = group is not None and parallel_mode == "voting"
    pool_valid = (torch.ones((L, F), dtype=torch.bool, device=dev)
                  if voting else None)
    nl = torch.ones(1, dtype=torch.int64, device=dev)
    leaf_lo = torch.full((L,), -float("inf"), device=dev)
    leaf_hi = torch.full((L,), float("inf"), device=dev)
    leaf_groups = torch.full((L,), -1, dtype=torch.int32, device=dev)
    reg_lo = torch.zeros((L, F), dtype=torch.int32, device=dev)
    reg_hi = meta.num_bin[None, :].expand(L, F).to(torch.int32).clone()
    lpn = torch.full((L,), -1, dtype=torch.int32, device=dev)
    lil = torch.zeros(L, dtype=torch.bool, device=dev)

    def scan(planes, lg, node_ids, parent, lo, hi, depth, lo_pl=None,
             hi_pl=None, bounds=use_mono_bounds, valid=None):
        m = _scan_mask(feature_mask, node_masks, lg, node_ids)
        if valid is not None:
            m = m & valid
        return _best_planes(planes, meta, m, params, parent, cat_idx,
                            bounds, lo, hi, depth, None, lo_pl, hi_pl, mono)

    root_best = scan(pool[:1], leaf_groups[:1],
                     torch.zeros(1, dtype=torch.int64, device=dev),
                     tree.leaf_value[:1], leaf_lo[:1], leaf_hi[:1],
                     tree.leaf_depth[:1])
    best = map_split(lambda a: torch.cat(
        [a, torch.zeros((L - 1,) + tuple(a.shape[1:]), dtype=a.dtype,
                        device=dev)]), root_best)
    best.gain[1:] = NEG_INF

    for i in range(L - 1):
        gains = _masked_gain(best.gain, tree.leaf_depth, nl, max_depth, L)
        gains = torch.where(torch.isnan(gains), NEG_INF, gains)
        l1 = torch.argmax(gains).reshape(1)
        ds = gains[l1] > 0.0                                       # [1]
        bsl = map_split(lambda a: a[l1], best)
        cm = bsl.cat_mask
        if i < n_forced:
            # forced top-of-tree splits (ref: serial_tree_learner.cpp:455
            # ForceSplits): the BFS schedule bypasses the gain choice; a
            # forced split with an empty child is skipped
            fl = forced_leaf[i:i + 1]
            finfo = gather_split_info(pool[fl][0].permute(1, 2, 0),
                                      forced_feat[i:i + 1],
                                      forced_thr[i:i + 1], meta, params,
                                      tree.leaf_value[fl])
            forced_ok = (finfo.left_count >= 1) & (finfo.right_count >= 1)
            l1 = torch.where(forced_ok, fl, l1)
            ds = ds | forced_ok
            bsl = BestSplit(*[b if b is None else torch.where(
                forced_ok.reshape((1,) + (1,) * (b.dim() - 1)), a, b)
                for a, b in zip(finfo, bsl)])
        f, t, dl, cf = (bsl.feature, bsl.threshold, bsl.default_left,
                        bsl.cat_flag)
        new1 = nl.clone()
        both = torch.cat([l1, new1])

        def put(a, idx, v):
            """a[idx] = v where this step splits (the JAX grower's
            ``lax.cond``); a write of the old value otherwise."""
            m = ds.reshape((1,) + (1,) * (a.dim() - 1))
            a[idx] = torch.where(m, v.to(a.dtype), a[idx])

        # ---- node bookkeeping (ref: tree.h:62 Tree::Split)
        p_node = lpn[l1]
        pn_safe = p_node.clamp(min=0).long()
        wl = ds & (p_node >= 0) & lil[l1]
        wr = ds & (p_node >= 0) & ~lil[l1]
        node = torch.full((1,), i, dtype=torch.int32, device=dev)
        tree.left_child[pn_safe] = torch.where(wl, node,
                                               tree.left_child[pn_safe])
        tree.right_child[pn_safe] = torch.where(wr, node,
                                                tree.right_child[pn_safe])
        put(tree.left_child, i, -l1 - 1)
        put(tree.right_child, i, -new1 - 1)
        put(tree.split_feature, i, f)
        put(tree.threshold_bin, i, t)
        put(tree.default_left, i, dl)
        if cf is not None:
            put(tree.cat_flag, i, cf)
            put(tree.cat_mask, i, cm)
        put(tree.split_gain, i, bsl.gain)
        put(tree.internal_value, i, tree.leaf_value[l1])
        put(tree.internal_count, i, tree.leaf_count[l1])
        put(tree.internal_weight, i, tree.leaf_weight[l1])
        new_depth = tree.leaf_depth[l1] + 1
        put(tree.leaf_value, both, torch.cat([bsl.left_output,
                                              bsl.right_output]))
        put(tree.leaf_count, both, torch.cat([bsl.left_count,
                                              bsl.right_count]))
        put(tree.leaf_weight, both, torch.cat([bsl.left_sum_hess,
                                               bsl.right_sum_hess]))
        put(tree.leaf_depth, both, torch.cat([new_depth, new_depth]))
        put(lpn, both, node.expand(2))
        put(lil, both, left_right)

        # ---- partition update (ref: data_partition.hpp Split): l1's
        # segment of the list, left rows first, from the split's decision
        # for each value of its kernel bin column
        fs = f.clamp(min=0).long()
        table = _left_table(kvals, fs, t, dl, cf, cm, meta, bundle_cfg, B)
        col = fs if bundle_cfg is None \
            else bundle_cfg.col_of_feat[fs].long()
        leaf_partition(order, scratch, leaf_begin, leaf_rows, l1, new1, ds,
                       hist.kbins, col, table)

        # ---- the smaller child's histogram from its listed rows; the
        # sibling by subtraction
        target_is_left = bsl.left_count <= bsl.right_count
        target = torch.where(target_is_left, l1, new1)
        hist_t = hist.leaf(order, leaf_begin, leaf_rows, target, ds)
        if voting:
            # the ranks vote on the smaller child's local gains (its
            # parent's output smooths them); only the winners are summed
            gains_t = per_feature_gains_cm(
                hist_t[0][None], hist_t[1][None], hist_t[2][None],
                meta.num_bin, meta.missing_type, meta.default_bin,
                feature_mask[None, :], meta_is_cat(meta), meta.monotone,
                params, tree.leaf_value[l1], cat_idx=cat_idx)
            hist_t, valid_t = vote_exchange(hist_t, gains_t, top_k, group,
                                            1)
            v_sib = pool_valid[l1][0] & valid_t
            put(pool_valid, l1,
                torch.where(target_is_left, valid_t, v_sib)[None])
            put(pool_valid, new1,
                torch.where(target_is_left, v_sib, valid_t)[None])
        elif group is not None:
            hist_t = record_psum(hist_t, group)
        hist_sib = histogram_subtract(pool[l1][0], hist_t)
        put(pool, l1, torch.where(target_is_left, hist_t, hist_sib)[None])
        put(pool, new1, torch.where(target_is_left, hist_sib, hist_t)[None])

        # ---- monotone bounds of the two children: basic fences both at
        # mid (ref: BasicLeafConstraints::Update, monotone_constraints.hpp:
        # 488); intermediate and advanced at the raw opposite outputs
        # (:544), numerical splits only
        if use_mono_bounds:
            mono_d = torch.where(f >= 0, meta.monotone[fs], 0)
            if cf is not None:
                mono_d = torch.where(cf, 0, mono_d)
            p_lo, p_hi = leaf_lo[l1], leaf_hi[l1]
            if inter:
                fence_l, fence_r = bsl.right_output, bsl.left_output
            else:
                fence_l = fence_r = 0.5 * (bsl.left_output
                                           + bsl.right_output)
            l_hi = torch.where(mono_d > 0, torch.minimum(p_hi, fence_l), p_hi)
            l_lo = torch.where(mono_d < 0, torch.maximum(p_lo, fence_l), p_lo)
            r_lo = torch.where(mono_d > 0, torch.maximum(p_lo, fence_r), p_lo)
            r_hi = torch.where(mono_d < 0, torch.minimum(p_hi, fence_r), p_hi)
            put(leaf_lo, both, torch.cat([l_lo, r_lo]))
            put(leaf_hi, both, torch.cat([l_hi, r_hi]))

        # ---- interaction groups of the two children
        if node_masks is not None:
            child_g = leaf_groups[l1] & torch.where(
                f >= 0, node_masks.groups_with_f[fs], -1)
            put(leaf_groups, both, child_g.expand(2))

        # ---- the two children's best splits
        child_hist = pool[both]
        bs2 = scan(child_hist, leaf_groups[both], child_ids[i],
                   tree.leaf_value[both], leaf_lo[both], leaf_hi[both],
                   tree.leaf_depth[both],
                   valid=None if pool_valid is None else pool_valid[both])
        _merge_best(best, both, bs2, ds)

        if inter:
            _inter_step(tree, best, pool, leaf_lo, leaf_hi, leaf_groups,
                        reg_lo, reg_hi, lpn, lil, l1, new1, both, nl, ds,
                        bsl, f, t, cf, child_hist, child_ids[i], meta, scan,
                        slots, f_iota, inf, L, B, adv, pool_valid)
        nl = nl + ds.long()
    return _finish(tree, nl), _rows_to_leaves(order, leaf_begin, leaf_rows)


def _inter_step(tree, best, pool, leaf_lo, leaf_hi, leaf_groups, reg_lo,
                reg_hi, lpn, lil, l1, new1, both, nl, ds, bsl, f, t, cf,
                child_hist, child_ids, meta, scan, slots, f_iota, inf, L, B,
                adv, pool_valid=None):
    """One leaf-wise step's intermediate (and advanced) monotone
    bookkeeping, in place (lightgbm_tpu/models/learner.py:816-967; ref:
    monotone_constraints.hpp:514-720 and :856): the parent's region cut
    at t + 1, the two children's outputs clipped against the region-
    adjacent leaves, the cross-tree tightening of the other leaves, the
    stale leaves' best splits rescanned (merged where their bounds
    changed), and under advanced the two children rescanned with the
    segment bound planes of every current leaf."""
    def put(a, idx, v):
        m = ds.reshape((1,) + (1,) * (a.dim() - 1))
        a[idx] = torch.where(m, v.to(a.dtype), a[idx])

    is_num = ~cf if cf is not None else torch.ones_like(ds)
    fs = f.clamp(min=0).long()
    parent_lo, parent_hi = reg_lo[l1], reg_hi[l1]                 # [1, F]
    cut = (f_iota[None, :] == fs[:, None]) & is_num[:, None]
    l_hi_r = torch.where(cut, t[:, None] + 1, parent_hi).to(torch.int32)
    n_lo_r = torch.where(cut, t[:, None] + 1, parent_lo).to(torch.int32)
    put(reg_lo, new1, n_lo_r)
    put(reg_hi, new1, parent_hi)
    put(reg_hi, l1, l_hi_r)
    c_lo = torch.cat([parent_lo, n_lo_r])                           # [2, F]
    c_hi = torch.cat([l_hi_r, parent_hi])
    active = slots < nl
    lo_before, hi_before = leaf_lo.clone(), leaf_hi.clone()

    # region-aware clipping of the children against the existing leaves.
    # Rows l and new are masked out of ``exist`` (new is not active yet),
    # so the regions and outputs as updated above give the JAX grower's
    # answer on its pre-step ones
    exist = active & (slots != l1)
    q_up, q_dn = region_adjacency(reg_lo, reg_hi, c_lo, c_hi, exist,
                                  meta.monotone)
    qv = tree.leaf_value[:, None]
    c_hi_b = torch.where(q_up, qv, inf).amin(0)                     # [2]
    c_lo_b = torch.where(q_dn, qv, -inf).amax(0)
    o_l = torch.minimum(torch.maximum(bsl.left_output, c_lo_b[0:1]),
                        c_hi_b[0:1])
    o_n = torch.minimum(torch.maximum(bsl.right_output, c_lo_b[1:2]),
                        c_hi_b[1:2])
    mono_d2 = torch.where(f >= 0, meta.monotone[fs], 0)
    num_mono = is_num & (mono_d2 != 0)
    o_n = torch.where(num_mono & (mono_d2 > 0), torch.maximum(o_n, o_l), o_n)
    o_n = torch.where(num_mono & (mono_d2 < 0), torch.minimum(o_n, o_l), o_n)
    put(tree.leaf_value, both, torch.cat([o_l, o_n]))
    lo2 = torch.maximum(leaf_lo[both], c_lo_b)
    hi2 = torch.minimum(leaf_hi[both], c_hi_b)
    # the sibling fences again, with the clipped outputs
    up_m, dn_m = num_mono & (mono_d2 > 0), num_mono & (mono_d2 < 0)
    hi2 = torch.minimum(hi2, torch.cat([torch.where(up_m, o_n, inf),
                                        torch.where(dn_m, o_l, inf)]))
    lo2 = torch.maximum(lo2, torch.cat([torch.where(dn_m, o_n, -inf),
                                        torch.where(up_m, o_l, -inf)]))
    put(leaf_lo, both, lo2)
    put(leaf_hi, both, hi2)

    # cross-tree tightening of the other leaves by the clipped outputs
    other = active & (slots != l1) & (slots != new1)
    q_up2, q_dn2 = region_adjacency(reg_lo, reg_hi, c_lo, c_hi, other,
                                    meta.monotone)
    co = torch.cat([o_l, o_n])[None, :]
    lo3 = torch.maximum(leaf_lo, torch.where(q_up2, co, -inf).amax(1))
    hi3 = torch.minimum(leaf_hi, torch.where(q_dn2, co, inf).amin(1))
    leaf_lo.copy_(torch.where(ds, lo3, leaf_lo))
    leaf_hi.copy_(torch.where(ds, hi3, leaf_hi))
    changed = ds & ((leaf_lo > lo_before) | (leaf_hi < hi_before))

    # the stale leaves' best splits, rescanned with their new bounds
    node_ids = 2 * (lpn.long() + 1) + lil.long()
    bs_all = scan(pool, leaf_groups, node_ids, tree.leaf_value, leaf_lo,
                  leaf_hi, tree.leaf_depth, bounds=True, valid=pool_valid)
    for a, v in zip(best, bs_all):
        if a is not None:
            m = changed.reshape((L,) + (1,) * (a.dim() - 1))
            a.copy_(torch.where(m, v.to(a.dtype), a))
    if not adv:
        return
    # ADVANCED: the two children rescanned with per-(feature, bin) bound
    # planes from every current leaf's shadow (ref: :856)
    act2 = slots < nl + 1
    excl = (slots[:, None] != both[None, :]) & act2[:, None]       # [L, 2]
    up_d, dn_d = region_adjacency(reg_lo, reg_hi, reg_lo[both],
                                  reg_hi[both], excl, meta.monotone,
                                  per_dim=True)
    any_up, any_dn = up_d.any(2), dn_d.any(2)                      # [L, 2]
    b_i3 = torch.arange(B, dtype=torch.int32, device=reg_lo.device)[
        None, None, :]
    inr = (reg_lo[:, :, None] <= b_i3) & (b_i3 < reg_hi[:, :, None])
    ap_up = up_d[..., None] | (inr[:, None] & any_up[:, :, None, None])
    ap_dn = dn_d[..., None] | (inr[:, None] & any_dn[:, :, None, None])
    vq4 = tree.leaf_value[:, None, None, None]
    hi_pl = torch.where(ap_up, vq4, inf).amin(0)                  # [2, F, B]
    lo_pl = torch.where(ap_dn, vq4, -inf).amax(0)
    bs_adv = scan(child_hist, leaf_groups[both], child_ids,
                  tree.leaf_value[both], leaf_lo[both], leaf_hi[both],
                  tree.leaf_depth[both], lo_pl=lo_pl, hi_pl=hi_pl,
                  bounds=True,
                  valid=None if pool_valid is None else pool_valid[both])
    _merge_best(best, both, bs_adv, ds)


# ------------------------------------------------------ depth-wise grower
def grow_tree_depthwise(bins: torch.Tensor, gh: torch.Tensor,
                        meta: FeatureMeta, feature_mask: torch.Tensor,
                        params: SplitParams, num_leaves: int, max_bins: int,
                        max_depth: int = -1, hist_impl: str = "segment",
                        cat_idx=None, use_mono_bounds: bool = False,
                        node_masks: NodeMaskCfg = None,
                        use_cegb: bool = False, cegb_coupled=None,
                        cegb_used=None, bundle_cfg: BundleCfg = None,
                        bundle_col_bins: int = 0, mono_mode: str = "basic",
                        use_cegb_lazy: bool = False, cegb_lazy=None,
                        cegb_used_rf=None,
                        hist_bins_i32: torch.Tensor = None, group=None,
                        parallel_mode: str = "data", top_k: int = 20,
                        route_bins: torch.Tensor = None,
                        route_meta: FeatureMeta = None,
                        feature_offset: int = 0):
    """Grow one tree level by level (lightgbm_tpu/models/learner.py:
    996-1384): per level, the leaves with a positive gain ranked within the
    ``num_leaves`` budget (a stable sort, as ``jnp.argsort``), one
    histogram pass of every selected leaf's left child at ``S = L`` slots,
    the right children by subtraction, and every leaf rescanned.

    Arguments as :func:`grow_tree_leafwise`, and CEGB's: ``use_cegb`` with
    ``cegb_coupled`` [F] f32 and ``cegb_used`` [F] bool (the features used
    by earlier trees; this tree's splits add theirs as it grows), and
    under ``use_cegb_lazy`` ``cegb_lazy`` [F] f32 and ``cegb_used_rf``
    [R, F] bool, the rows' used-feature bitmap, which persists across
    trees. The intermediate monotone mode runs
    ``mono_inter_level_update`` over a static bound of each level's
    splits, guarded; ``advanced`` is the leaf-wise grower's.

    Distributed (module docstring): ``group`` with ``parallel_mode``
    "data" or "voting" (rows sharded; ``top_k``), or "feature", where
    ``bins``/``meta``/``feature_mask`` are this rank's column slice
    starting at global column ``feature_offset`` and ``route_bins`` /
    ``route_meta`` the full replicated matrix the rows route on; the
    tree's split features are then global.

    Returns (TreeArrays, row_leaf [R] int32), and the updated
    ``cegb_used_rf`` third under ``use_cegb_lazy``.
    """
    R = bins.shape[0]
    dev = bins.device
    F = bundle_cfg.flat_idx.shape[0] if bundle_cfg is not None \
        else bins.shape[1]
    L, B = num_leaves, max_bins
    n_levels = max_depth if max_depth > 0 else max(1, (L - 1).bit_length()
                                                   + 1)
    n_levels = min(n_levels, L - 1)
    hist = _Hist(bins, gh, F, B, hist_impl, hist_bins_i32, bundle_cfg,
                 bundle_col_bins)
    inter = use_mono_bounds and mono_mode == "intermediate"
    mono = meta.monotone if use_mono_bounds else None
    slots = torch.arange(L, device=dev)
    i32 = torch.int32
    voting = group is not None and parallel_mode == "voting"
    feat_par = group is not None and parallel_mode == "feature"
    r_bins = bins if route_bins is None else route_bins
    r_meta = meta if route_meta is None else route_meta

    def exchange(planes, parent_out):
        """Level planes [S, 3, F, B] -> (globally valid planes, valid [F]
        or None) (lightgbm_tpu/models/learner.py:1057-1082)."""
        if group is None or feat_par:
            return planes, None          # feature: local columns complete
        if not voting:
            return record_psum(planes, group), None
        gains = per_feature_gains_cm(
            planes[:, 0], planes[:, 1], planes[:, 2], meta.num_bin,
            meta.missing_type, meta.default_bin, feature_mask,
            meta_is_cat(meta), meta.monotone, params, parent_out,
            cat_idx=cat_idx)
        return vote_exchange(planes, gains, top_k, group, 2)

    tree = empty_tree(L, B, dev)
    row_leaf = torch.zeros(R, dtype=i32, device=dev)
    pool = torch.zeros((L, 3, F, B), dtype=torch.float32, device=dev)
    pool[0], root_valid = _root(hist, tree, params,
                                exchange if group is not None else None)
    pool_valid = None
    if voting:
        pool_valid = torch.zeros((L, F), dtype=torch.bool, device=dev)
        pool_valid[0] = root_valid
    nl = torch.ones((), dtype=torch.int64, device=dev)
    num_nodes = torch.zeros((), dtype=torch.int64, device=dev)
    lpn = torch.full((L,), -1, dtype=i32, device=dev)
    lil = torch.zeros(L, dtype=torch.bool, device=dev)
    leaf_lo = torch.full((L,), -float("inf"), device=dev)
    leaf_hi = torch.full((L,), float("inf"), device=dev)
    leaf_groups = torch.full((L,), -1, dtype=i32, device=dev)
    used_f = (cegb_used.clone() if use_cegb and cegb_used is not None
              else torch.zeros(F, dtype=torch.bool, device=dev))
    reg_lo = torch.zeros((L, F), dtype=i32, device=dev)
    reg_hi = meta.num_bin[None, :].expand(L, F).to(i32).clone()
    used_rf = cegb_used_rf if use_cegb_lazy else None

    def all_best(tree, leaf_lo, leaf_hi, leaf_groups, node_ids, used_f,
                 row_leaf, used_rf):
        delta = None
        if use_cegb:
            lazy = {}
            if use_cegb_lazy:
                # per-(leaf, feature) rows whose path has not used the
                # feature (ref: the lazy bitmap of cost_effective_gradient_
                # boosting.hpp:22); 0/1 sums, exact in f32
                unused = torch.zeros((L, F), dtype=torch.float32,
                                     device=dev).index_add_(
                    0, row_leaf.long(), (~used_rf).to(torch.float32))
                lazy = dict(lazy_penalty=cegb_lazy, unused_cnt=unused)
            delta = cegb_delta_matrix(params, cegb_coupled, used_f,
                                      tree.leaf_count, **lazy)
        m = _scan_mask(feature_mask, node_masks, leaf_groups, node_ids)
        if pool_valid is not None:
            m = m & pool_valid
        bs = _best_planes(
            pool, meta, m, params, tree.leaf_value, cat_idx, use_mono_bounds,
            leaf_lo, leaf_hi, tree.leaf_depth, delta, mono=mono)
        if feat_par:
            if bs.cat_flag is None:
                # a slice without categorical columns still takes part in
                # the merge of the categorical fields
                bs = bs._replace(
                    cat_flag=torch.zeros(L, dtype=torch.bool, device=dev),
                    cat_mask=torch.zeros((L, B), dtype=torch.bool,
                                         device=dev))
            bs = merge_best_over_shards(bs, group, feature_offset)
        return bs

    best = all_best(tree, leaf_lo, leaf_hi, leaf_groups,
                    torch.zeros(L, dtype=torch.int64, device=dev), used_f,
                    row_leaf, used_rf)
    best = best._replace(gain=torch.where(slots == 0, best.gain, NEG_INF))

    for level in range(n_levels):
        gains = _masked_gain(best.gain, tree.leaf_depth, nl, max_depth, L)
        order = torch.argsort(-gains, stable=True)
        rank = torch.empty(L, dtype=torch.int64, device=dev)
        rank[order] = slots
        selected = (gains > 0.0) & (rank < L - nl)
        sel_i32 = selected.to(i32)
        n_sel = sel_i32.sum()
        # a level with nothing selected leaves every tensor as it was (the
        # JAX grower's lax.cond(n_sel > 0)): no host read
        k_of_leaf = torch.cumsum(sel_i32, 0, dtype=i32) - sel_i32
        new_of_leaf = torch.where(selected, nl + k_of_leaf, -1).to(i32)
        node_of_leaf = torch.where(selected, num_nodes + k_of_leaf,
                                   -1).to(i32)
        f_l, t_l, dl_l = best.feature, best.threshold, best.default_left
        cf_l, cm_l = best.cat_flag, best.cat_mask

        # ---- node records of the level's splits
        def w(arr, vals):
            return _masked_scatter(arr, node_of_leaf, vals, selected)
        lc = w(tree.left_child, -slots.to(i32) - 1)
        rc = w(tree.right_child, -new_of_leaf - 1)
        lc = _masked_scatter(lc, lpn, node_of_leaf, selected & (lpn >= 0)
                             & lil)
        rc = _masked_scatter(rc, lpn, node_of_leaf, selected & (lpn >= 0)
                             & ~lil)
        lpn2 = torch.where(selected, node_of_leaf, lpn)
        lil2 = torch.where(selected, True, lil)
        lpn2 = _masked_scatter(lpn2, new_of_leaf, node_of_leaf, selected)
        lil2 = _masked_scatter(lil2, new_of_leaf, torch.zeros_like(lil),
                               selected)
        tree = tree._replace(
            split_feature=w(tree.split_feature, f_l),
            threshold_bin=w(tree.threshold_bin, t_l),
            default_left=w(tree.default_left, dl_l),
            cat_flag=(w(tree.cat_flag, cf_l) if cf_l is not None
                      else tree.cat_flag),
            cat_mask=(w(tree.cat_mask, cm_l) if cm_l is not None
                      else tree.cat_mask),
            split_gain=w(tree.split_gain, best.gain),
            internal_value=w(tree.internal_value, tree.leaf_value),
            internal_count=w(tree.internal_count, tree.leaf_count),
            internal_weight=w(tree.internal_weight, tree.leaf_weight),
            left_child=lc, right_child=rc)

        # ---- partition: one gather of each row's split-feature bin
        l_row = row_leaf.long()
        sel_row = selected[l_row]
        f_row = f_l.clamp(min=0)[l_row]
        bins_row = _route_bins(r_bins, f_row, r_meta, bundle_cfg)
        go_left = _route_left(bins_row, t_l[l_row], dl_l[l_row],
                              r_meta.num_bin[f_row],
                              r_meta.missing_type[f_row],
                              r_meta.default_bin[f_row])
        if cf_l is not None:
            go_left = torch.where(cf_l[l_row],
                                  cm_l[l_row, bins_row.long().clamp(0, B - 1)],
                                  go_left)
        row_leaf2 = torch.where(sel_row & ~go_left, new_of_leaf[l_row],
                                row_leaf)
        if use_cegb_lazy:
            # rows of a split leaf mark its feature used on their path
            # (ref: CostEfficientGradientBoosting::UpdateUsedFeature)
            used_rf = used_rf | ((sel_row & (f_l[l_row] >= 0))[:, None]
                                 & (torch.arange(F, device=dev)[None, :]
                                    == f_row[:, None]))

        # ---- one histogram pass for every left child (the kept ids)
        leaf_to_slot = torch.where(selected, k_of_leaf, -1)
        row_slot = torch.where(sel_row & (row_leaf2 == row_leaf),
                               leaf_to_slot[l_row], -1)
        hist_left, lvl_valid = exchange(hist(row_slot, L), tree.leaf_value)
        left = hist_left[torch.where(selected, k_of_leaf, 0).long()]
        pool2 = _masked_scatter(pool, slots, left, selected)
        pool = _masked_scatter(pool2, new_of_leaf,
                               histogram_subtract(pool, left), selected)
        if voting:
            # the subtracted sibling is global where its parent and this
            # level's exchange both are
            lvl_rows = lvl_valid[None, :].expand(L, -1)
            pv2 = _masked_scatter(pool_valid, slots, lvl_rows, selected)
            pool_valid = _masked_scatter(pv2, new_of_leaf,
                                         pool_valid & lvl_rows, selected)

        # ---- leaf statistics
        def upd2(arr, lv, rv):
            arr = _masked_scatter(arr, slots, lv, selected)
            return _masked_scatter(arr, new_of_leaf, rv, selected)
        if inter:
            # the level's splits one at a time in slot order, guarded,
            # over a static bound of their count (a level at most doubles
            # the leaves); the clipped outputs replace the raw ones
            (new_value, leaf_lo2, leaf_hi2, reg_lo, reg_hi,
             _) = mono_inter_level_update(
                tree.leaf_value, leaf_lo, leaf_hi, reg_lo, reg_hi, selected,
                k_of_leaf, f_l, t_l, cf_l, best.left_output,
                best.right_output, meta.monotone, nl,
                min(1 << level, L - 1), guard=True)
        else:
            new_value = upd2(tree.leaf_value, best.left_output,
                             best.right_output)
        new_depth = tree.leaf_depth + 1
        tree = tree._replace(
            leaf_value=new_value,
            leaf_count=upd2(tree.leaf_count, best.left_count,
                            best.right_count),
            leaf_weight=upd2(tree.leaf_weight, best.left_sum_hess,
                             best.right_sum_hess),
            leaf_depth=upd2(tree.leaf_depth, new_depth, new_depth))
        nl = nl + n_sel
        num_nodes = num_nodes + n_sel
        if use_mono_bounds and not inter:
            mono_dir = torch.where(f_l >= 0,
                                   r_meta.monotone[f_l.clamp(min=0)], 0)
            if cf_l is not None:
                mono_dir = torch.where(cf_l, 0, mono_dir)
            leaf_lo2, leaf_hi2 = mono_child_bounds(
                leaf_lo, leaf_hi, selected, mono_dir, best.left_output,
                best.right_output, slots, new_of_leaf)
        elif not use_mono_bounds:
            leaf_lo2, leaf_hi2 = leaf_lo, leaf_hi
        leaf_lo, leaf_hi = leaf_lo2, leaf_hi2
        if node_masks is not None:
            leaf_groups = update_leaf_groups(node_masks, leaf_groups, f_l,
                                             selected, slots, new_of_leaf)
        if use_cegb:
            chosen = _masked_scatter(
                torch.zeros(F, dtype=torch.bool, device=dev),
                f_l.clamp(min=0), torch.ones(L, dtype=torch.bool,
                                             device=dev),
                selected & (f_l >= 0))
            used_f = used_f | chosen
        lpn, lil, row_leaf = lpn2, lil2, row_leaf2
        # a leaf's sampling identity: its creating node and side
        node_ids = 2 * (lpn.long() + 1) + lil.long()
        best = all_best(tree, leaf_lo, leaf_hi, leaf_groups, node_ids,
                        used_f, row_leaf, used_rf)
        best = best._replace(gain=torch.where(slots < nl, best.gain,
                                              NEG_INF))
    tree = _finish(tree, nl)
    if use_cegb_lazy:
        return tree, row_leaf, used_rf
    return tree, row_leaf
