"""Objective function interface.

PyTorch counterpart of ``lightgbm_tpu/objective/base.py`` (ref:
include/LightGBM/objective_function.h). The contract the boosting layer
depends on:

- ``init(metadata, num_data, device)``: bind label/weight arrays (host
  numpy) and move what the gradients need onto the training device.
- ``get_gradients(score) -> (grad, hess)``: float32 tensors shaped like
  ``score`` (``[k, n]``).
- ``boost_from_score(class_id)``: initial score (host scalar).
- ``convert_output(raw)``: raw score -> output space (numpy).
- ``gradient_operands()`` / ``gradients_from(score, operands)``: the
  gradients as a function of the score and per-row operand tensors, so the
  boosting code can compute them on a padded score row;
- ``epilogue_spec()``: ``(kind, (row0, row1), sigmoid)`` for the fused
  boosting-epilogue kernel (``ops.fused_level.epilogue_pass``), which
  re-derives the gradients inside its pass, or None where the objective
  has no closed form the kernel implements.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

K_EPSILON = 1e-15


class ObjectiveFunction:
    """Base objective (ref: include/LightGBM/objective_function.h:22)."""

    name = "base"

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

    def to_string(self) -> str:
        return self.name
