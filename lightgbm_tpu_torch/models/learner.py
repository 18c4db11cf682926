"""Learner helpers shared by the growers.

PyTorch counterpart of the parts of ``lightgbm_tpu/models/learner.py`` the
fused grower uses: the feature metadata record, the collision-free masked
scatter and the masked gain vector.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

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
