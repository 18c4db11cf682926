"""Learner helpers shared by the growers.

PyTorch counterpart of the parts of ``lightgbm_tpu/models/learner.py`` the
fused grower uses: the feature metadata record, the collision-free masked
scatter, the masked gain vector, and the per-node feature masks of
interaction constraints and ``feature_fraction_bynode`` (``NodeMaskCfg``,
whose by-node draws come from the port's copy of ``jax.random``'s
Threefry, ``utils/random.py``).
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
