"""Binary classification objective.

PyTorch counterpart of ``lightgbm_tpu/objective/binary.py`` (ref:
src/objective/binary_objective.hpp BinaryLogloss).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import log
from .base import K_EPSILON, ObjectiveFunction


class BinaryLogloss(ObjectiveFunction):
    """Sigmoid logloss with is_unbalance / scale_pos_weight
    (ref: binary_objective.hpp:21-222)."""

    name = "binary"
    traced_gradients = True

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0.0:
            log.fatal("Sigmoid parameter %f should be greater than zero",
                      self.sigmoid)
        self.is_unbalance = bool(config.is_unbalance)
        self.scale_pos_weight = float(config.scale_pos_weight)
        if self.is_unbalance and abs(self.scale_pos_weight - 1.0) > 1e-6:
            log.fatal("Cannot set is_unbalance and scale_pos_weight at the "
                      "same time")
        self.need_train = True

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        is_pos = self.label > 0
        cnt_pos = int(np.sum(is_pos))
        cnt_neg = num_data - cnt_pos
        self.need_train = not (cnt_pos == 0 or cnt_neg == 0)
        if not self.need_train:
            log.warning("Contains only one class")
        log.info("Number of positive: %d, number of negative: %d",
                 cnt_pos, cnt_neg)
        # label weights (ref: binary_objective.hpp:88-103)
        w_neg, w_pos = 1.0, 1.0
        if self.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= self.scale_pos_weight
        self._is_pos = is_pos
        # ±1 labels and per-row class weight, folded with row weights
        self._label_val = torch.as_tensor(
            np.where(is_pos, 1.0, -1.0).astype(np.float32), device=device)
        lw = np.where(is_pos, w_pos, w_neg).astype(np.float32)
        if self.weight is not None:
            lw = lw * self.weight
        self._label_weight = torch.as_tensor(lw, device=device)

    def gradient_operands(self):
        return (self._label_val, self._label_weight)

    def gradients_from(self, score, operands):
        # ref: binary_objective.hpp:107-136
        if not self.need_train:
            return torch.zeros_like(score), torch.zeros_like(score)
        label_val, label_weight = operands
        lv = label_val[None, :]
        lw = label_weight[None, :]
        sig = torch.tensor(self.sigmoid, dtype=torch.float32)
        response = -lv * sig / (1.0 + torch.exp(lv * sig * score))
        abs_resp = torch.abs(response)
        return response * lw, abs_resp * (sig - abs_resp) * lw

    def epilogue_spec(self):
        if not self.need_train:
            return None
        return ("binary", (self._label_val, self._label_weight),
                self.sigmoid)

    def boost_from_score(self, class_id):
        # ref: binary_objective.hpp:139-163
        if self.weight is not None:
            suml = float(np.sum(self._is_pos * self.weight))
            sumw = float(np.sum(self.weight))
        else:
            suml = float(np.sum(self._is_pos))
            sumw = float(self.num_data)
        pavg = min(max(suml / sumw, K_EPSILON), 1.0 - K_EPSILON)
        initscore = np.log(pavg / (1.0 - pavg)) / self.sigmoid
        log.info("[%s:BoostFromScore]: pavg=%f -> initscore=%f",
                 self.name, pavg, initscore)
        return float(initscore)

    def class_need_train(self, class_id):
        return self.need_train

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-self.sigmoid * raw))

    def convert_output_torch(self, raw):
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * raw))

    def to_string(self):
        return f"{self.name} sigmoid:{self.sigmoid:g}"
