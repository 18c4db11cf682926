"""Tree representation.

PyTorch counterpart of ``lightgbm_tpu/models/tree.py`` (ref:
include/LightGBM/tree.h:25, src/io/tree.cpp).  Two forms:

- ``TreeArrays``: a NamedTuple of fixed-size tensors (struct-of-arrays,
  static ``max_leaves`` slots) produced by the grower on the training
  device.  Child pointers follow the reference convention: ``>= 0`` is an
  internal node index, negative is ``~leaf_index`` (ref: tree.h
  left_child_/right_child_).  ``num_leaves`` is a host int: the grower
  reads the per-level split count on the host anyway.  A categorical node
  (``cat_flag``) sends left the bins of its ``cat_mask`` row.
- ``HostTree``: the host-side object used for model text IO (a numpy copy
  of the JAX package's class, without its host prediction walk —
  ``ops/predict.py`` routes on the device, and ``ops/linear.py`` gives a
  linear tree's per-row outputs).  Thresholds are
  converted from bin indices to real values with the dataset's BinMapper
  upper bounds (ref: tree.h RealThreshold); a categorical node's threshold
  indexes ``cat_boundaries``, whose range of ``cat_threshold`` holds the
  bitset of the category values that go left (ref: tree.h
  CategoricalDecision, Common::FindInBitset).
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch


class TreeArrays(NamedTuple):
    """Tree under construction/training (static shapes, on the device)."""
    num_leaves: int                   # actual leaf count (host int)
    split_feature: torch.Tensor       # int32 [L-1] inner feature index
    threshold_bin: torch.Tensor       # int32 [L-1]
    default_left: torch.Tensor        # bool  [L-1]
    cat_flag: torch.Tensor            # bool  [L-1] categorical split?
    cat_mask: torch.Tensor            # bool  [L-1, B] bins routed left
    left_child: torch.Tensor          # int32 [L-1]
    right_child: torch.Tensor         # int32 [L-1]
    split_gain: torch.Tensor          # f32   [L-1]
    internal_value: torch.Tensor      # f32   [L-1]
    internal_count: torch.Tensor      # f32   [L-1]
    internal_weight: torch.Tensor     # f32   [L-1] (sum_hessian)
    leaf_value: torch.Tensor          # f32   [L]
    leaf_count: torch.Tensor          # f32   [L]
    leaf_weight: torch.Tensor         # f32   [L] (sum_hessian)
    leaf_depth: torch.Tensor          # int32 [L]


def empty_tree(max_leaves: int, max_bins: int, device) -> TreeArrays:
    L = max_leaves
    i32, f32 = torch.int32, torch.float32

    def z(n, dt):
        return torch.zeros(n, dtype=dt, device=device)
    return TreeArrays(
        num_leaves=1,
        split_feature=torch.full((L - 1,), -1, dtype=i32, device=device),
        threshold_bin=z(L - 1, i32),
        default_left=z(L - 1, torch.bool),
        cat_flag=z(L - 1, torch.bool),
        cat_mask=z((L - 1, max_bins), torch.bool),
        left_child=z(L - 1, i32),
        right_child=z(L - 1, i32),
        split_gain=z(L - 1, f32),
        internal_value=z(L - 1, f32),
        internal_count=z(L - 1, f32),
        internal_weight=z(L - 1, f32),
        leaf_value=z(L, f32),
        leaf_count=z(L, f32),
        leaf_weight=z(L, f32),
        leaf_depth=z(L, i32),
    )


class HostTree:
    """Host-side tree mirroring the reference text-model block
    (ref: src/io/tree.cpp:336 Tree::ToString)."""

    def __init__(self, num_leaves: int, shrinkage: float = 1.0):
        self.num_leaves = num_leaves
        self.shrinkage = shrinkage
        self.split_feature: np.ndarray = np.zeros(0, np.int32)   # real indices
        self.threshold: np.ndarray = np.zeros(0, np.float64)     # real values
        self.threshold_bin: np.ndarray = np.zeros(0, np.int32)
        self.decision_type: np.ndarray = np.zeros(0, np.int32)
        self.left_child: np.ndarray = np.zeros(0, np.int32)
        self.right_child: np.ndarray = np.zeros(0, np.int32)
        self.split_gain: np.ndarray = np.zeros(0, np.float64)
        self.internal_value: np.ndarray = np.zeros(0, np.float64)
        self.internal_weight: np.ndarray = np.zeros(0, np.float64)
        self.internal_count: np.ndarray = np.zeros(0, np.int64)
        self.leaf_value: np.ndarray = np.zeros(1, np.float64)
        self.leaf_weight: np.ndarray = np.zeros(1, np.float64)
        self.leaf_count: np.ndarray = np.zeros(1, np.int64)
        self.cat_boundaries: List[int] = [0]
        self.cat_threshold: List[int] = []
        self.leaf_depth: np.ndarray = np.zeros(1, np.int32)
        # linear trees (ref: tree.h is_linear_/leaf_const_/leaf_coeff_)
        self.is_linear = False
        self.leaf_const: np.ndarray = np.zeros(1, np.float64)
        self.leaf_features: List[List[int]] = []
        self.leaf_coeff: List[List[float]] = []

    # decision_type bitfield (ref: tree.h:166-186): bit0 categorical,
    # bit1 default_left, bits 2-3 missing type (0 none, 1 zero, 2 nan)
    @staticmethod
    def make_decision_type(categorical: bool, default_left: bool,
                           missing_type: int) -> int:
        d = 0
        if categorical:
            d |= 1
        if default_left:
            d |= 2
        d |= (missing_type & 3) << 2
        return d

    def cat_bitset(self, node: int) -> List[int]:
        """The 32-bit words of categorical ``node``'s left set: category c
        goes left iff bit c % 32 of word c // 32 is set."""
        ci = int(self.threshold[node])
        return self.cat_threshold[self.cat_boundaries[ci]:
                                  self.cat_boundaries[ci + 1]]

    @property
    def num_internal(self) -> int:
        return max(0, self.num_leaves - 1)

    # ------------------------------------------------------------------
    def apply_shrinkage(self, rate: float) -> None:
        """ref: tree.h:188 Shrinkage — scales leaf and internal values
        (and the linear models when present)."""
        self.shrinkage *= rate
        self.leaf_value = self.leaf_value * rate
        self.internal_value = self.internal_value * rate
        if self.is_linear:
            self.leaf_const = self.leaf_const * rate
            self.leaf_coeff = [[c * rate for c in cs]
                               for cs in self.leaf_coeff]

    def add_bias(self, val: float) -> None:
        self.leaf_value = self.leaf_value + val
        self.internal_value = self.internal_value + val
        if self.is_linear:
            self.leaf_const = self.leaf_const + val
        self.shrinkage = 1.0

    def branch_features(self) -> List[List[int]]:
        """Per leaf, the sorted unique features (real indices) its root
        path splits on (ref: tree.h branch_features_)."""
        paths: List[List[int]] = [[] for _ in range(self.num_leaves)]
        stack = [(0, ())] if self.num_internal else []
        while stack:
            node, feats = stack.pop()
            feats = feats + (int(self.split_feature[node]),)
            for child in (int(self.left_child[node]),
                          int(self.right_child[node])):
                if child < 0:
                    paths[~child] = sorted(set(feats))
                else:
                    stack.append((child, feats))
        return paths
