"""Objective function interface.

PyTorch counterpart of ``lightgbm_tpu/objective/base.py`` (ref:
include/LightGBM/objective_function.h). The contract the boosting layer
depends on:

- ``init(metadata, num_data, device)``: bind label/weight arrays (host
  numpy) and move what the gradients need onto the training device.
- ``get_gradients(score) -> (grad, hess)``: float32 tensors shaped like
  ``score`` (``[k, n]``).
- ``boost_from_score(class_id)``: initial score (host scalar).
- ``convert_output(raw)``: raw score -> output space (numpy);
  ``convert_output_torch(raw)`` the same on the device (f32), or None
  where the objective has no device form (the metrics then evaluate on
  the host);
- ``gradient_operands()`` / ``gradients_from(score, operands)``: the
  gradients as a function of the score and per-row operand tensors, so the
  boosting code can compute them on a padded score row;
- ``epilogue_spec()``: ``(kind, (row0, row1), sigmoid)`` for the fused
  boosting-epilogue kernel (``ops.fused_level.epilogue_pass``), which
  re-derives the gradients inside its pass, or None where the objective
  has no closed form the kernel implements;
- ``num_model_per_iteration`` (k trees per iteration), ``class_need_train``
  (a class with nothing to learn gets a constant tree), and leaf renewal
  (``is_renew_tree_output`` / ``renew_tree_output``: the L1 family's leaf
  values recomputed from residual percentiles, on the host in float64).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

K_EPSILON = 1e-15


def percentile(data: np.ndarray, alpha: float) -> float:
    """Unweighted percentile with the reference's interpolation
    (ref: src/objective/regression_objective.hpp:18 PercentileFun)."""
    cnt = len(data)
    if cnt <= 1:
        return float(data[0]) if cnt else 0.0
    float_pos = (1.0 - alpha) * cnt
    pos = int(float_pos)
    sorted_desc = np.sort(data)[::-1]
    if pos < 1:
        return float(sorted_desc[0])
    if pos >= cnt:
        return float(sorted_desc[-1])
    bias = float_pos - pos
    v1 = float(sorted_desc[pos - 1])
    v2 = float(sorted_desc[pos])
    return v1 - (v1 - v2) * bias


def weighted_percentile(data: np.ndarray, weight: np.ndarray,
                        alpha: float) -> float:
    """Weighted percentile (ref: regression_objective.hpp:50
    WeightedPercentileFun, its interpolation included)."""
    cnt = len(data)
    if cnt <= 1:
        return float(data[0]) if cnt else 0.0
    order = np.argsort(data, kind="stable")
    sdata = np.asarray(data, dtype=np.float64)[order]
    cdf = np.cumsum(np.asarray(weight, dtype=np.float64)[order])
    threshold = cdf[-1] * alpha
    pos = int(np.searchsorted(cdf, threshold, side="right"))
    pos = min(pos, cnt - 1)
    if pos == 0 or pos == cnt - 1:
        return float(sdata[pos])
    v1, v2 = float(sdata[pos - 1]), float(sdata[pos])
    if cdf[pos + 1] - cdf[pos] >= 1.0:
        return ((threshold - cdf[pos]) / (cdf[pos + 1] - cdf[pos])
                * (v2 - v1) + v1)
    return v2


class ObjectiveFunction:
    """Base objective (ref: include/LightGBM/objective_function.h:22)."""

    name = "base"
    # the JAX package traces this objective's gradients into its megastep
    # (``supports_traced_gradients``: the class that defines its gradients
    # defines ``gradients_from`` too); the megastep precheck reads it
    traced_gradients = False

    def __init__(self, config):
        self.config = config
        self.num_data = 0
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None

    def init(self, metadata, num_data: int, device=None) -> None:
        self.num_data = num_data
        self.label = metadata.label
        self.weight = metadata.weight
        self.device = device

    def get_gradients(self, score) -> Tuple:
        return self.gradients_from(score, self.gradient_operands())

    def gradient_operands(self):
        raise NotImplementedError

    def gradients_from(self, score, operands) -> Tuple:
        raise NotImplementedError

    def epilogue_spec(self):
        """(kind, (row0, row1), sigmoid): ``kind`` selects the kernel's
        formula ('binary' | 'l2'); row0/row1 are [n] float32 tensors
        (binary: ±1 label and label weight; l2: label and row weight).
        None when the kernel has no closed form for this objective."""
        return None

    def boost_from_score(self, class_id: int) -> float:
        return 0.0

    def convert_output(self, raw):
        return raw

    def convert_output_torch(self, raw):
        return None

    def to_string(self) -> str:
        return self.name

    @property
    def num_model_per_iteration(self) -> int:
        return 1


    @property
    def is_renew_tree_output(self) -> bool:
        return False

    def renew_tree_output(self, leaf_pred: float, residuals: np.ndarray,
                          row_idx: np.ndarray) -> float:
        """New output of one leaf from the residuals (label - score) of its
        rows (ref: objective_function.h RenewTreeOutput)."""
        return leaf_pred

    def class_need_train(self, class_id: int) -> bool:
        return True

    def _dev(self, a):
        """A host array as an f32 tensor on the training device."""
        import torch
        return (None if a is None else
                torch.as_tensor(np.asarray(a, np.float32), device=self.device))
