"""Tree routing on raw feature values, on the device.

PyTorch counterpart of ``route_raw_rows_to_leaves`` in
``lightgbm_tpu/ops/predict.py``: one tree level per step for every row at
once, with the reference's numerical decision (ref: tree.h
NumericalDecision) — ``missing_type`` per node from the decision_type
bitfield, NaN treated as 0.0 unless the node's missing type is NaN, and the
zero band ``|v| <= 1e-35`` missing for missing type Zero. Values and
thresholds are float64, so routing is bit-identical to the host walk
(``HostTree.predict_rows``). Categorical nodes are not ported yet.

:func:`route_binned_rows_to_leaves` is the same walk on the training bins
(``route_rows_to_leaves`` of the JAX package), which ``rollback_one_iter``
uses to subtract a tree from the training scores.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

K_ZERO_THRESHOLD = 1e-35


def route_raw_rows_to_leaves(values: torch.Tensor,
                             split_feature: torch.Tensor,
                             threshold: torch.Tensor,
                             default_left: torch.Tensor,
                             missing_type: torch.Tensor,
                             left_child: torch.Tensor,
                             right_child: torch.Tensor,
                             max_steps: int) -> torch.Tensor:
    """Leaf index per row for one tree (child >= 0 internal node, < 0 is
    ~leaf). ``values`` [R, F] float64; per-node arrays [N]; ``max_steps``
    must be >= the tree's depth."""
    R = values.shape[0]
    node = torch.zeros(R, dtype=torch.int64, device=values.device)
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    for _ in range(max_steps):
        is_internal = node >= 0
        nd = node.clamp(min=0)
        f = split_feature[nd]
        v = torch.gather(values, 1, f[:, None])[:, 0]
        mt = missing_type[nd]
        nan_mask = torch.isnan(v)
        zero_mask = torch.abs(v) <= K_ZERO_THRESHOLD
        is_missing = torch.where(mt == 2, nan_mask,
                                 (mt == 1) & (zero_mask | nan_mask))
        v_eff = torch.where(nan_mask & (mt != 2), zero, v)
        go_left = torch.where(is_missing, default_left[nd],
                              v_eff <= threshold[nd])
        nxt = torch.where(go_left, left_child[nd], right_child[nd])
        node = torch.where(is_internal, nxt, node)
    return torch.where(node < 0, ~node, torch.zeros_like(node))


def route_binned_rows_to_leaves(bins: torch.Tensor,
                                split_feature: torch.Tensor,
                                threshold_bin: torch.Tensor,
                                default_left: torch.Tensor,
                                left_child: torch.Tensor,
                                right_child: torch.Tensor,
                                num_bin: torch.Tensor,
                                missing_type: torch.Tensor,
                                default_bin: torch.Tensor,
                                max_steps: int) -> torch.Tensor:
    """Leaf index per row for one tree on binned rows ``bins`` [R, F]:
    ``split_feature`` holds inner feature indices; a row whose bin is the
    feature's missing bin (its default bin for missing type Zero, the last
    bin for NaN) follows ``default_left``, others go left iff
    bin <= threshold_bin (ref: src/io/dense_bin.hpp Split)."""
    R = bins.shape[0]
    node = torch.zeros(R, dtype=torch.int64, device=bins.device)
    for _ in range(max_steps):
        is_internal = node >= 0
        nd = node.clamp(min=0)
        f = split_feature[nd]
        b = torch.gather(bins, 1, f[:, None])[:, 0].long()
        mt = missing_type[f]
        missing = (((mt == 1) & (b == default_bin[f]))
                   | ((mt == 2) & (b == num_bin[f] - 1)))
        go_left = torch.where(missing, default_left[nd],
                              b <= threshold_bin[nd])
        nxt = torch.where(go_left, left_child[nd], right_child[nd])
        node = torch.where(is_internal, nxt, node)
    return torch.where(node < 0, ~node, torch.zeros_like(node))


def tree_depth(left: np.ndarray, right: np.ndarray) -> int:
    depth = 0
    frontier = [0]
    while frontier:
        depth += 1
        nxt = []
        for nd in frontier:
            for c in (int(left[nd]), int(right[nd])):
                if c >= 0:
                    nxt.append(c)
        frontier = nxt
    return depth


def predict_raw(models: List, X: torch.Tensor, k: int) -> torch.Tensor:
    """Raw scores [k, n] float64 of ``models`` (HostTrees) on ``X``
    [n, F] float64, summed in tree order like the JAX package's host walk
    (basic.host_walk_raw)."""
    n = X.shape[0]
    dev = X.device
    raw = torch.zeros((k, n), dtype=torch.float64, device=dev)
    for i, t in enumerate(models):
        if any(t.decision_type[:t.num_internal] & 1):
            raise NotImplementedError("categorical splits are not ported "
                                      "to lightgbm_tpu_torch yet")
        if getattr(t, "is_linear", False):
            raise NotImplementedError("linear trees are not ported to "
                                      "lightgbm_tpu_torch yet")
        lv = torch.as_tensor(np.asarray(t.leaf_value, np.float64),
                             device=dev)
        if t.num_leaves <= 1:
            raw[i % k] += lv[0]
            continue
        ni = t.num_internal

        def a(x, dt):
            return torch.as_tensor(np.asarray(x[:ni]), dtype=dt, device=dev)
        d = np.asarray(t.decision_type[:ni])
        leaves = route_raw_rows_to_leaves(
            X, a(t.split_feature, torch.int64),
            a(t.threshold, torch.float64),
            torch.as_tensor((d & 2) != 0, device=dev),
            torch.as_tensor((d >> 2) & 3, device=dev),
            a(t.left_child, torch.int64), a(t.right_child, torch.int64),
            tree_depth(t.left_child, t.right_child))
        raw[i % k] += lv[leaves]
    return raw
