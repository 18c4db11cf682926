"""Learner helpers shared by the growers.

PyTorch counterpart of the parts of ``lightgbm_tpu/models/learner.py`` the
fused grower uses: the feature metadata record, the collision-free masked
scatter, the masked gain vector, the per-node feature masks of
interaction constraints and ``feature_fraction_bynode`` (``NodeMaskCfg``,
whose by-node draws come from the port's copy of ``jax.random``'s
Threefry, ``utils/random.py``), and the monotone-constraint bookkeeping of
the basic and intermediate modes (``mono_child_bounds``,
``region_adjacency``, ``mono_inter_level_update``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils import random as ref_random

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


def region_adjacency(q_lo, q_hi, c_lo, c_hi, mask, monotone):
    """Monotone region adjacency of every leaf box q against C child boxes
    (lightgbm_tpu/models/learner.py:263-294, the vectorized form of the
    reference's GoUp/GoDown contiguity walk): the boxes overlap on every
    feature but one monotone feature g, and q lies strictly beyond the
    child on g. q_lo/q_hi [L, F] bin-space boxes, c_lo/c_hi [C, F], mask
    [L] (which q count), monotone [F]. Returns (up, dn) [L, C] bool: q
    lies above (up) or below (dn) the child in its feature's direction."""
    F = q_lo.shape[1]
    ql, qh = q_lo[:, None, :], q_hi[:, None, :]
    cl, ch = c_lo[None, :, :], c_hi[None, :, :]
    ov = (ql < ch) & (cl < qh)                              # [L, C, F]
    ov_i = ov.to(torch.int32)
    ov_except = (ov_i.sum(2, keepdim=True) - ov_i) == (F - 1)
    gate = ov_except & mask[:, None, None]
    above = gate & (ql >= ch)
    below = gate & (qh <= cl)
    d = monotone[None, None, :]
    up = ((d > 0) & above) | ((d < 0) & below)
    dn = ((d > 0) & below) | ((d < 0) & above)
    return up.any(2), dn.any(2)


def mono_inter_level_update(leaf_value, leaf_lo, leaf_hi, reg_lo, reg_hi,
                            selected, k_of_leaf, feature, threshold,
                            cat_flag, left_out, right_out, monotone,
                            num_leaves_before: int, n_splits: int):
    """The intermediate mode's bookkeeping for one level of simultaneous
    splits (ref: monotone_constraints.hpp:514 IntermediateLeafConstraints;
    lightgbm_tpu/models/learner.py:296-403): raw-output fences,
    region-aware clipping of each fresh child's output against the
    region-adjacent leaves, and the cross-tightening of the other leaves'
    bounds. The splits run one at a time in slot order (``k_of_leaf``, the
    gain rank), as the JAX package's ``fori_loop`` over the level's slots
    does; the loop here runs only over the level's ``n_splits`` (a host
    int), whose every step has a split, with no host read. Every step is
    min/max/select, so the result is bit-equal to the JAX package's.

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
    inf = torch.tensor(float("inf"), device=dev)
    for k in range(n_splits):
        new = num_leaves_before + k
        l = torch.argmax((selected & (k_of_leaf == k)).to(torch.int32)) \
            .reshape(1)
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
        rlo[new] = n_lo_r[0]
        rhi[new] = parent_hi[0]
        rhi.index_copy_(0, l, l_hi_r)
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
        lv.index_copy_(0, l, o_l)
        lv[new] = o_n[0]
        # inherited bounds and raw-output fences (looser than basic's
        # mid), then the adjacency clip bounds, with the clipped outputs
        p_lo, p_hi = lo[l], hi[l]
        l_hi = torch.where(mono_d > 0, torch.minimum(p_hi, o_n), p_hi)
        l_lo = torch.where(mono_d < 0, torch.maximum(p_lo, o_n), p_lo)
        n_lo = torch.where(mono_d > 0, torch.maximum(p_lo, o_l), p_lo)
        n_hi = torch.where(mono_d < 0, torch.minimum(p_hi, o_l), p_hi)
        lo.index_copy_(0, l, torch.maximum(l_lo, c_lo_b[0:1]))
        lo[new] = torch.maximum(n_lo, c_lo_b[1:2])[0]
        hi.index_copy_(0, l, torch.minimum(l_hi, c_hi_b[0:1]))
        hi[new] = torch.minimum(n_hi, c_hi_b[1:2])[0]
        # cross-tighten the other leaves by the new (clipped) outputs
        co = torch.cat([o_l, o_n])[None, :]
        lo3 = torch.maximum(lo, torch.where(q_up, co, -inf).amax(1))
        hi3 = torch.minimum(hi, torch.where(q_dn, co, inf).amin(1))
        changed |= (lo3 > lo) | (hi3 < hi)
        lo, hi = lo3, hi3
    # the fresh children are rescanned by the level anyway
    changed &= (slots < num_leaves_before) & ~selected
    return lv, lo, hi, rlo, rhi, changed
