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

    def get_gradients(self, score):
        diff = score - self._label_t[None, :]
        if self._weight_t is None:
            return diff, torch.ones_like(diff)
        w = self._weight_t[None, :]
        return diff * w, w.expand_as(diff).clone()

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

    def to_string(self):
        return self.name + (" sqrt" if self.sqrt else "")
