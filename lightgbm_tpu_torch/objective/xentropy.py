"""Cross-entropy objectives for probabilistic labels in [0, 1].

PyTorch counterpart of ``lightgbm_tpu/objective/xentropy.py`` (ref:
src/objective/xentropy_objective.hpp CrossEntropy, CrossEntropyLambda).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import log
from .base import K_EPSILON, ObjectiveFunction


class CrossEntropy(ObjectiveFunction):
    """Cross-entropy; grad = sigmoid(s) - y
    (ref: xentropy_objective.hpp:77-95)."""

    name = "cross_entropy"

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        if self.label.min() < 0.0 or self.label.max() > 1.0:
            log.fatal("[%s]: label should be in [0, 1] interval", self.name)
        if self.weight is not None:
            if self.weight.min() < 0.0:
                log.fatal("[%s]: at least one weight is negative", self.name)
            if self.weight.sum() == 0.0:
                log.fatal("[%s]: sum of weights is zero", self.name)
        self._label_t = self._dev(self.label)
        self._weight_t = self._dev(self.weight)

    def gradient_operands(self):
        return (self._label_t, self._weight_t)

    def gradients_from(self, score, operands):
        label, weight = operands
        z = 1.0 / (1.0 + torch.exp(-score))
        g = z - label[None, :]
        h = z * (1.0 - z)
        if weight is not None:
            w = weight[None, :]
            g, h = g * w, h * w
        return g, h

    def boost_from_score(self, class_id):
        # ref: xentropy_objective.hpp:113-137
        if self.weight is not None:
            pavg = float(np.sum(self.label * self.weight)
                         / np.sum(self.weight))
        else:
            pavg = float(np.mean(self.label))
        pavg = min(max(pavg, K_EPSILON), 1.0 - K_EPSILON)
        initscore = float(np.log(pavg / (1.0 - pavg)))
        log.info("[%s:BoostFromScore]: pavg = %f -> initscore = %f",
                 self.name, pavg, initscore)
        return initscore

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-raw))


class CrossEntropyLambda(ObjectiveFunction):
    """Weighted cross-entropy in the lambda parameterization
    (ref: xentropy_objective.hpp:157-266)."""

    name = "cross_entropy_lambda"

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        if self.label.min() < 0.0 or self.label.max() > 1.0:
            log.fatal("[%s]: label should be in [0, 1] interval", self.name)
        if self.weight is not None and self.weight.min() <= 0.0:
            log.fatal("[%s]: at least one weight is non-positive",
                      self.name)
        self._label_t = self._dev(self.label)
        self._weight_t = self._dev(self.weight)

    def gradient_operands(self):
        return (self._label_t, self._weight_t)

    def gradients_from(self, score, operands):
        # ref: xentropy_objective.hpp:190-217
        label, weight = operands
        y = label[None, :]
        if weight is None:
            z = 1.0 / (1.0 + torch.exp(-score))
            return z - y, z * (1.0 - z)
        w = weight[None, :]
        epf = torch.exp(score)
        hhat = torch.log1p(epf)
        z = 1.0 - torch.exp(-w * hhat)
        enf = 1.0 / epf
        g = (1.0 - y / z) * w / (1.0 + enf)
        c = 1.0 / (1.0 - z)
        d = 1.0 + epf
        a = w * epf / (d * d)
        d2 = c - 1.0
        b = (c / (d2 * d2)) * (1.0 + w * epf - c)
        return g, a * (1.0 + y * b)

    def boost_from_score(self, class_id):
        # ref: xentropy_objective.hpp:243-265
        if self.weight is not None:
            havg = float(np.sum(self.label * self.weight)
                         / np.sum(self.weight))
        else:
            havg = float(np.mean(self.label))
        initscore = float(np.log(max(np.expm1(havg), K_EPSILON)))
        log.info("[%s:BoostFromScore]: havg = %f -> initscore = %f",
                 self.name, havg, initscore)
        return initscore

    def convert_output(self, raw):
        # the output is the exponential parameter lambda, not a
        # probability (ref: xentropy_objective.hpp:233)
        return np.log1p(np.exp(raw))
