"""Regression objectives.

PyTorch counterpart of ``lightgbm_tpu/objective/regression.py`` (ref:
src/objective/regression_objective.hpp): L2, L1, Huber, Fair, Poisson,
Quantile, MAPE, Gamma and Tweedie. Each loss computes its gradients from
the ``[k, n]`` scores in f32 on the training device, in the JAX package's
operation order. L1, Quantile and MAPE renew their leaves (the boosting
layer's ``_renew_tree_output``) from residual percentiles on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import log
from .base import ObjectiveFunction, percentile, weighted_percentile


def _sign(x):
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, 0.0))


def _times_weight(g, h, weight):
    if weight is None:
        return g, h
    w = weight[None, :]
    return g * w, h * w


def _unit_hessian(g, weight):
    """(g, 1) unweighted, (g * w, w) weighted."""
    if weight is None:
        return g, torch.ones_like(g)
    w = weight[None, :]
    return g * w, w.expand_as(g).clone()


class RegressionL2Loss(ObjectiveFunction):
    """L2 loss; grad = score - label, hess = 1 (times the row weight)."""

    name = "regression"
    traced_gradients = True

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


class RegressionL1Loss(RegressionL2Loss):
    """L1; grad = sign(diff); leaves renewed to the weighted median of
    their residuals (ref: regression_objective.hpp:217-293)."""

    name = "regression_l1"
    traced_gradients = False

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = False

    def gradients_from(self, score, operands):
        label, weight = operands
        return _unit_hessian(_sign(score - label[None, :]), weight)

    def boost_from_score(self, class_id):
        if self.weight is not None:
            return weighted_percentile(self.label, self.weight, 0.5)
        return percentile(self.label, 0.5)

    @property
    def is_renew_tree_output(self):
        return True

    def renew_tree_output(self, leaf_pred, residuals, row_idx):
        if self.weight is not None:
            return weighted_percentile(residuals, self.weight[row_idx], 0.5)
        return percentile(residuals, 0.5)

    def to_string(self):
        return self.name


class RegressionHuberLoss(RegressionL2Loss):
    """Huber; the gradient clipped at alpha
    (ref: regression_objective.hpp:313-338)."""

    name = "huber"
    traced_gradients = False

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = False
        self.alpha = float(config.alpha)
        if self.alpha <= 0:
            log.fatal("alpha should be greater than 0 in huber loss")

    def gradients_from(self, score, operands):
        label, weight = operands
        g = torch.clamp(score - label[None, :], -self.alpha, self.alpha)
        return _unit_hessian(g, weight)

    def to_string(self):
        return self.name


class RegressionFairLoss(RegressionL2Loss):
    """Fair loss; grad = c·x/(|x|+c), hess = c²/(|x|+c)²
    (ref: regression_objective.hpp:362-381)."""

    name = "fair"
    traced_gradients = False

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = False
        self.c = float(config.fair_c)

    def gradients_from(self, score, operands):
        label, weight = operands
        x = score - label[None, :]
        ax_c = torch.abs(x) + self.c
        g = self.c * x / ax_c
        h = self.c * self.c / (ax_c * ax_c)
        return _times_weight(g, h, weight)

    def to_string(self):
        return self.name


class RegressionPoissonLoss(RegressionL2Loss):
    """Poisson; grad = exp(s) - y, hess = exp(s + max_delta_step)
    (ref: regression_objective.hpp:440-466)."""

    name = "poisson"
    traced_gradients = False

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = False
        self.max_delta_step = float(config.poisson_max_delta_step)

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        self.check_label()

    def check_label(self):
        if np.min(self.label) < 0.0:
            log.fatal("[%s]: at least one target label is negative",
                      self.name)
        if np.sum(self.label) == 0.0:
            log.fatal("[%s]: sum of labels is zero", self.name)

    def gradients_from(self, score, operands):
        label, weight = operands
        g = torch.exp(score) - label[None, :]
        h = torch.exp(score + self.max_delta_step)
        return _times_weight(g, h, weight)

    def boost_from_score(self, class_id):
        mean = RegressionL2Loss.boost_from_score(self, class_id)
        return float(np.log(max(mean, 1e-300)))

    def convert_output(self, raw):
        return np.exp(raw)

    def convert_output_torch(self, raw):
        return None       # the JAX package has no device form either

    def to_string(self):
        return self.name


class RegressionQuantileLoss(RegressionL2Loss):
    """Quantile (pinball); leaves renewed to the alpha-quantile of their
    residuals (ref: regression_objective.hpp:480-571)."""

    name = "quantile"
    traced_gradients = False

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = False
        self.alpha = float(config.alpha)
        if not (0.0 < self.alpha < 1.0):
            log.fatal("alpha should be in (0, 1) for quantile objective")

    def gradients_from(self, score, operands):
        label, weight = operands
        g = torch.where(score - label[None, :] >= 0, 1.0 - self.alpha,
                        -self.alpha).to(score.dtype)
        return _unit_hessian(g, weight)

    def boost_from_score(self, class_id):
        if self.weight is not None:
            return weighted_percentile(self.label, self.weight, self.alpha)
        return percentile(self.label, self.alpha)

    @property
    def is_renew_tree_output(self):
        return True

    def renew_tree_output(self, leaf_pred, residuals, row_idx):
        if self.weight is not None:
            return weighted_percentile(residuals, self.weight[row_idx],
                                       self.alpha)
        return percentile(residuals, self.alpha)

    def to_string(self):
        return f"{self.name} alpha:{self.alpha}"


class RegressionMAPELoss(RegressionL1Loss):
    """MAPE; L1 with the per-row weight 1/max(1, |label|)
    (ref: regression_objective.hpp:580-668)."""

    name = "mape"

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        if np.any(np.abs(self.label) < 1):
            log.warning("Some label values are < 1 in absolute value. MAPE "
                        "is unstable with such values, so LightGBM rounds "
                        "them to 1.0 when calculating MAPE.")
        lw = 1.0 / np.maximum(1.0, np.abs(self.label))
        if self.weight is not None:
            lw = lw * self.weight
        self.label_weight = lw.astype(np.float32)
        self._label_weight_t = self._dev(self.label_weight)

    def gradient_operands(self):
        return (self._label_t, self._weight_t, self._label_weight_t)

    def gradients_from(self, score, operands):
        label, weight, label_weight = operands
        g = _sign(score - label[None, :]) * label_weight[None, :]
        if weight is None:
            return g, torch.ones_like(g)
        return g, weight[None, :].expand_as(g).clone()

    def boost_from_score(self, class_id):
        return weighted_percentile(self.label, self.label_weight, 0.5)

    def renew_tree_output(self, leaf_pred, residuals, row_idx):
        return weighted_percentile(residuals, self.label_weight[row_idx],
                                   0.5)


class RegressionGammaLoss(RegressionPoissonLoss):
    """Gamma; grad = 1 - y·exp(-s), hess = y·exp(-s)
    (ref: regression_objective.hpp:687-706)."""

    name = "gamma"

    def gradients_from(self, score, operands):
        label, weight = operands
        e = torch.exp(-score)
        y = label[None, :]
        return _times_weight(1.0 - y * e, y * e, weight)


class RegressionTweedieLoss(RegressionPoissonLoss):
    """Tweedie with variance power rho
    (ref: regression_objective.hpp:723-744)."""

    name = "tweedie"

    def __init__(self, config):
        super().__init__(config)
        self.rho = float(config.tweedie_variance_power)

    def gradients_from(self, score, operands):
        label, weight = operands
        y = label[None, :]
        e1 = torch.exp((1.0 - self.rho) * score)
        e2 = torch.exp((2.0 - self.rho) * score)
        g = -y * e1 + e2
        h = -y * (1.0 - self.rho) * e1 + (2.0 - self.rho) * e2
        return _times_weight(g, h, weight)
