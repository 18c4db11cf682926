"""Multiclass objectives.

PyTorch counterpart of ``lightgbm_tpu/objective/multiclass.py`` (ref:
src/objective/multiclass_objective.hpp MulticlassSoftmax, MulticlassOVA).
Scores are ``[num_class, n]``; the softmax runs across axis 0.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import log
from .base import K_EPSILON, ObjectiveFunction
from .binary import BinaryLogloss


class MulticlassSoftmax(ObjectiveFunction):
    """Softmax with the K/(K-1) hessian factor
    (ref: multiclass_objective.hpp:24-167)."""

    name = "multiclass"
    traced_gradients = True

    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        if self.num_class < 2:
            log.fatal("num_class should be greater than 1 for multiclass")
        self.factor = self.num_class / (self.num_class - 1.0)

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        li = self.label.astype(np.int32)
        if li.min() < 0 or li.max() >= self.num_class:
            log.fatal("Label must be in [0, %d), but found %d in label",
                      self.num_class, int(li.min() if li.min() < 0
                                          else li.max()))
        # per-class init probabilities (ref: multiclass_objective.hpp:58-83)
        w = self.weight if self.weight is not None else np.ones(num_data,
                                                                np.float32)
        probs = np.zeros(self.num_class)
        np.add.at(probs, li, w)
        self.class_init_probs = probs / w.sum()
        self._onehot = self._dev(
            li[None, :] == np.arange(self.num_class)[:, None])
        self._weight_t = self._dev(self.weight)

    def gradient_operands(self):
        return (self._onehot, self._weight_t)

    def gradients_from(self, score, operands):
        # ref: multiclass_objective.hpp:86-130
        onehot, weight = operands
        p = torch.exp(score - torch.max(score, dim=0, keepdim=True).values)
        p = p / torch.sum(p, dim=0, keepdim=True)
        grad = p - onehot
        hess = self.factor * p * (1.0 - p)
        if weight is not None:
            w = weight[None, :]
            grad, hess = grad * w, hess * w
        return grad, hess

    def boost_from_score(self, class_id):
        # ref: multiclass_objective.hpp:142-148, the log of the class prior
        p = max(self.class_init_probs[class_id], K_EPSILON)
        return float(np.log(p))

    def convert_output(self, raw):
        """Softmax over the class axis; ``raw`` is [n, num_class]."""
        m = raw - np.max(raw, axis=-1, keepdims=True)
        e = np.exp(m)
        return e / np.sum(e, axis=-1, keepdims=True)

    def to_string(self):
        return f"{self.name} num_class:{self.num_class}"

    @property
    def num_model_per_iteration(self):
        return self.num_class



class MulticlassOVA(ObjectiveFunction):
    """One-vs-all: num_class independent binary objectives
    (ref: multiclass_objective.hpp:172-263)."""

    name = "multiclassova"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        if self.num_class < 2:
            log.fatal("num_class should be greater than 1 for multiclassova")
        self.sigmoid = float(config.sigmoid)
        self._binaries = [BinaryLogloss(config)
                          for _ in range(self.num_class)]

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        for k, b in enumerate(self._binaries):
            # is_pos = label == k (ref: multiclass_objective.hpp:186)
            b.init(_ClassView(metadata, k), num_data, device)

    def get_gradients(self, score):
        gs, hs = [], []
        for k, b in enumerate(self._binaries):
            g, h = b.get_gradients(score[k:k + 1])
            gs.append(g)
            hs.append(h)
        return torch.cat(gs, 0), torch.cat(hs, 0)

    def boost_from_score(self, class_id):
        return self._binaries[class_id].boost_from_score(0)

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-self.sigmoid * raw))

    def class_need_train(self, class_id):
        return self._binaries[class_id].need_train

    def to_string(self):
        return (f"{self.name} num_class:{self.num_class} "
                f"sigmoid:{self.sigmoid:g}")

    @property
    def num_model_per_iteration(self):
        return self.num_class


class _ClassView:
    """Metadata view with label = (label == k) for the OVA sub-objectives."""

    def __init__(self, metadata, k):
        self.label = (metadata.label.astype(np.int32) == k).astype(
            np.float32)
        self.weight = metadata.weight
        self.init_score = metadata.init_score
