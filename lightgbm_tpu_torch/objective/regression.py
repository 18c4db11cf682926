"""L2 regression objective.

PyTorch counterpart of ``RegressionL2Loss`` in
``lightgbm_tpu/objective/regression.py`` (ref:
src/objective/regression_objective.hpp:127-141). The other regression
losses are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import ObjectiveFunction


class RegressionL2Loss(ObjectiveFunction):
    """L2 loss; grad = score - label, hess = 1 (times the row weight)."""

    name = "regression"

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = bool(getattr(config, "reg_sqrt", False))

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        if self.sqrt:
            self.label = (np.sign(self.label)
                          * np.sqrt(np.abs(self.label))).astype(np.float32)
        self._label_t = torch.as_tensor(self.label, device=device)
        self._weight_t = (torch.as_tensor(self.weight, device=device)
                          if self.weight is not None else None)

    def gradient_operands(self):
        return (self._label_t, self._weight_t)

    def gradients_from(self, score, operands):
        label, weight = operands
        diff = score - label[None, :]
        if weight is None:
            return diff, torch.ones_like(diff)
        w = weight[None, :]
        return diff * w, w.expand_as(diff).clone()

    def epilogue_spec(self):
        # exact-class guard: a loss that subclasses L2 and overrides its
        # gradients must not inherit the L2 closed form
        if type(self) is not RegressionL2Loss:
            return None
        w = (self._weight_t if self._weight_t is not None
             else torch.ones_like(self._label_t))
        return ("l2", (self._label_t, w), 1.0)

    def boost_from_score(self, class_id):
        # ref: regression_objective.hpp:173 — weighted label mean
        if self.weight is not None:
            return float(np.sum(self.label * self.weight)
                         / np.sum(self.weight))
        return float(np.mean(self.label))

    def convert_output(self, raw):
        if self.sqrt:
            return np.sign(raw) * raw * raw
        return raw

    def convert_output_torch(self, raw):
        if self.sqrt:
            return torch.sign(raw) * raw * raw
        return raw

    def to_string(self):
        return self.name + (" sqrt" if self.sqrt else "")
