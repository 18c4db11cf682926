"""Evaluation metrics.

PyTorch counterpart of ``lightgbm_tpu/metric/__init__.py`` (ref:
src/metric/metric.cpp:17 CreateMetric; the regression, binary and
xentropy hpp families). Every metric has two forms:

- ``eval(score, objective)``: the host form, numpy in float64 on a copied
  ``[k, n]`` score matrix, as the JAX package's;
- ``eval_device(score_dev, objective, cache)``: the device form, torch on
  the scores' device with f32 reductions, the mirror of the JAX package's
  ``eval_device``/``loss_jnp`` (and of what ``metric/traced.py``'s
  builders compute inside its megastep scan). It returns 0-d tensors (the
  caller fetches every scalar of an eval call at once), or None where the
  JAX package has no device form either; the host form then runs.

``auc`` on the device is the tie-grouped trapezoid of the JAX package's
``_weighted_auc_jnp``: a stable descending sort, group ids at distinct
scores, per-group sums by ``scatter_add``.

The multiclass metrics (``multi_logloss``, ``multi_error`` with
``multi_error_top_k``, ``auc_mu`` with ``auc_mu_weights``) take the
``[k, n]`` scores. ``multi_logloss`` (under the softmax and one-vs-all
objectives, or none) and ``multi_error`` have the device forms of the JAX
package's ``metric/traced.py:123-167``; ``auc_mu`` has a host form only.

The ranking metrics need query groups: ``ndcg`` (``eval_at``, or
``ndcg@k``) has the JAX package's device form (``metric/traced.py``
``_ndcg_builder``: one lexsort by query then descending score, per-slot
discounts and per-query ideal DCGs precomputed on the host, segment sums
by ``index_add_``); ``map`` has a host form only, as in the JAX package.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import Config
from ..utils import dcg, log

K_EPSILON = 1e-15

# metric-name aliases (ref: config.cpp ParseMetrics + docs/Parameters.rst)
METRIC_ALIASES = {
    "l2": "l2", "mean_squared_error": "l2", "mse": "l2",
    "regression": "l2", "regression_l2": "l2",
    "l2_root": "rmse", "root_mean_squared_error": "rmse", "rmse": "rmse",
    "l1": "l1", "mean_absolute_error": "l1", "mae": "l1",
    "regression_l1": "l1",
    "quantile": "quantile", "huber": "huber", "fair": "fair",
    "poisson": "poisson",
    "mape": "mape", "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "gamma_deviance": "gamma_deviance",
    "tweedie": "tweedie",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "binary_error": "binary_error",
    "auc": "auc", "average_precision": "average_precision",
    "auc_mu": "auc_mu",
    "multi_logloss": "multi_logloss", "multiclass": "multi_logloss",
    "softmax": "multi_logloss", "multiclassova": "multi_logloss",
    "multiclass_ova": "multi_logloss", "ova": "multi_logloss",
    "ovr": "multi_logloss",
    "multi_error": "multi_error",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "xentlambda": "cross_entropy_lambda",
    "kullback_leibler": "kullback_leibler", "kldiv": "kullback_leibler",
    "ndcg": "ndcg", "lambdarank": "ndcg", "rank_xendcg": "ndcg",
    "xendcg": "ndcg", "xe_ndcg": "ndcg", "xe_ndcg_mart": "ndcg",
    "xendcg_mart": "ndcg",
    "map": "map", "mean_average_precision": "map",
}

class Metric:
    """Base metric (ref: include/LightGBM/metric.h:28)."""

    names: List[str] = []
    is_bigger_better = False

    def __init__(self, config: Config):
        self.config = config

    def init(self, metadata, num_data: int) -> None:
        self.num_data = num_data
        self.label = metadata.label
        self.weight = metadata.weight
        self.query_boundaries = metadata.query_boundaries
        # under a rank layout: compacted row -> padded global row
        # (parallel/multiproc.GlobalMetadata)
        self.query_row_map = getattr(metadata, "query_row_map", None)
        if self.weight is not None:
            self.sum_weights = float(np.sum(self.weight))
        else:
            self.sum_weights = float(num_data)
        self._dev = None          # (device, label, weight) on the device

    def eval(self, score: np.ndarray, objective) -> List[float]:
        raise NotImplementedError

    def eval_mp(self, score_local, objective, mp):
        """The metric under a rank layout from this rank's [k, local_real]
        scores (host float64), or None where it has no distributed form
        (lightgbm_tpu/metric/__init__.py:121-123)."""
        return None

    def _eval_mp_ranked(self, score_local, mp, accum_fn, width: int):
        """A per-query metric under a rank layout (lightgbm_tpu/metric/
        __init__.py:91-119): each rank sums over the queries whose rows it
        holds, then one host gather of [sums, query count] and the sum
        over ranks in rank order; a zero-size query is rank 0's, so it is
        counted once. Every rank returns the same values."""
        qb = self.query_boundaries
        off = mp.offset
        sums = np.zeros(width, np.float64)
        cnt = 0
        for q in range(len(qb) - 1):
            rows_g = dcg.query_rows(qb, self.query_row_map, q)
            if rows_g.size == 0:
                if mp.process_index == 0:
                    accum_fn(q, np.zeros(0), np.zeros(0), sums)
                    cnt += 1
                continue
            if not off <= rows_g[0] < off + mp.block:
                continue
            lab = np.asarray(self.label)[rows_g]
            sc = np.asarray(score_local[0][rows_g - off], np.float64)
            accum_fn(q, lab, sc, sums)
            cnt += 1
        allg = mp._allgather(np.concatenate([sums, [float(cnt)]]))
        allg = allg.reshape(mp.process_count, width + 1)
        tot = allg[:, :width].sum(axis=0)
        n_q = allg[:, width].sum()
        return list(tot / max(1.0, n_q))

    def has_device_form(self, objective) -> bool:
        """Whether ``eval_device`` evaluates under ``objective`` (the JAX
        package's ``metric/traced.py`` builds a traced form exactly for
        these)."""
        return False

    def eval_device(self, score_dev: torch.Tensor, objective, cache=None):
        """0-d f32 tensors on the scores' device, one per name, or None
        when this metric has no device form (the host form runs)."""
        return None

    @staticmethod
    def _converts_on_device(objective) -> bool:
        return objective is None or objective.convert_output_torch(
            torch.zeros(1)) is not None

    def _converted_row(self, score_dev, objective, cache):
        """Objective-converted [n] score row, shared across one eval set's
        metrics through ``cache``; None when the objective has no device
        conversion."""
        if cache is not None and "converted_row" in cache:
            return cache["converted_row"]
        s = score_dev[0]
        if objective is not None:
            s = objective.convert_output_torch(s)
        if cache is not None and s is not None:
            cache["converted_row"] = s
        return s

    def _dev_label_weight(self, device):
        if self._dev is None or self._dev[0] != device:
            w = (torch.as_tensor(self.weight, device=device)
                 if self.weight is not None else None)
            self._dev = (device, torch.as_tensor(self.label, device=device),
                         w)
        return self._dev[1], self._dev[2]


def _weighted_sum(pt, weight):
    return torch.sum(pt * weight) if weight is not None else torch.sum(pt)


# ---------------------------------------------------------------------------
# Regression metrics (ref: src/metric/regression_metric.hpp)
# ---------------------------------------------------------------------------
class _RegressionMetric(Metric):
    """Weighted pointwise loss averaged over rows
    (ref: regression_metric.hpp:22-113)."""

    convert = True  # run objective.convert_output on scores first

    def loss(self, label, score):
        raise NotImplementedError

    def loss_torch(self, label, score):
        """Device mirror of ``loss``, or None (no device form)."""
        return None

    def average(self, sum_loss, sum_weights):
        return sum_loss / sum_weights

    def average_torch(self, sum_loss, sum_weights):
        return sum_loss / sum_weights

    def eval(self, score, objective):
        s = score[0]
        if self.convert and objective is not None:
            s = objective.convert_output(s)
        pt = self.loss(self.label, s)
        if self.weight is not None:
            sum_loss = float(np.sum(pt * self.weight))
        else:
            sum_loss = float(np.sum(pt))
        return [self.average(sum_loss, self.sum_weights)]

    def has_device_form(self, objective) -> bool:
        return (type(self).loss_torch is not _RegressionMetric.loss_torch
                and (not self.convert or self._converts_on_device(objective)))

    def eval_device(self, score_dev, objective, cache=None):
        if not self.has_device_form(objective):
            return None
        s = (self._converted_row(score_dev, objective, cache)
             if self.convert else score_dev[0])
        label, weight = self._dev_label_weight(score_dev.device)
        sum_loss = _weighted_sum(self.loss_torch(label, s), weight)
        return [self.average_torch(sum_loss, self.sum_weights)]


class L2Metric(_RegressionMetric):
    names = ["l2"]

    def loss(self, label, score):
        d = score - label
        return d * d

    def loss_torch(self, label, score):
        d = score - label
        return d * d


class RMSEMetric(L2Metric):
    names = ["rmse"]

    def average(self, sum_loss, sum_weights):
        return float(np.sqrt(sum_loss / sum_weights))

    def average_torch(self, sum_loss, sum_weights):
        return torch.sqrt(sum_loss / sum_weights)


class L1Metric(_RegressionMetric):
    names = ["l1"]

    def loss(self, label, score):
        return np.abs(score - label)

    def loss_torch(self, label, score):
        return torch.abs(score - label)


class QuantileMetric(_RegressionMetric):
    names = ["quantile"]

    def loss(self, label, score):
        delta = label - score
        a = self.config.alpha
        return np.where(delta < 0, (a - 1.0) * delta, a * delta)

    def loss_torch(self, label, score):
        delta = label - score
        a = self.config.alpha
        return torch.where(delta < 0, (a - 1.0) * delta, a * delta)


class HuberLossMetric(_RegressionMetric):
    names = ["huber"]

    def loss(self, label, score):
        diff = score - label
        a = self.config.alpha
        return np.where(np.abs(diff) <= a, 0.5 * diff * diff,
                        a * (np.abs(diff) - 0.5 * a))

    def loss_torch(self, label, score):
        diff = score - label
        a = self.config.alpha
        return torch.where(torch.abs(diff) <= a, 0.5 * diff * diff,
                           a * (torch.abs(diff) - 0.5 * a))


class FairLossMetric(_RegressionMetric):
    names = ["fair"]

    def loss(self, label, score):
        x = np.abs(score - label)
        c = self.config.fair_c
        return c * x - c * c * np.log1p(x / c)


class PoissonMetric(_RegressionMetric):
    names = ["poisson"]

    def loss(self, label, score):
        s = np.maximum(score, 1e-10)
        return s - label * np.log(s)


class MAPEMetric(_RegressionMetric):
    names = ["mape"]

    def loss(self, label, score):
        return np.abs(label - score) / np.maximum(1.0, np.abs(label))

    def loss_torch(self, label, score):
        return torch.abs(label - score) / torch.clamp(torch.abs(label),
                                                      min=1.0)


class GammaMetric(_RegressionMetric):
    names = ["gamma"]

    def loss(self, label, score):
        # ref: regression_metric.hpp:261-272 (negative gamma log-likelihood)
        psi = 1.0
        theta = -1.0 / np.maximum(score, 1e-300)
        b = -np.log(np.maximum(-theta, 1e-300))
        c = (1.0 / psi * np.log(np.maximum(label / psi, 1e-300))
             - np.log(np.maximum(label, 1e-300)))
        return -((label * theta - b) / psi + c)


class GammaDevianceMetric(_RegressionMetric):
    names = ["gamma_deviance"]

    def loss(self, label, score):
        tmp = label / (score + 1e-9)
        return tmp - np.log(np.maximum(tmp, 1e-300)) - 1.0

    def average(self, sum_loss, sum_weights):
        return sum_loss * 2.0


class TweedieMetric(_RegressionMetric):
    names = ["tweedie"]

    def loss(self, label, score):
        rho = self.config.tweedie_variance_power
        s = np.maximum(score, 1e-10)
        a = label * np.exp((1.0 - rho) * np.log(s)) / (1.0 - rho)
        b = np.exp((2.0 - rho) * np.log(s)) / (2.0 - rho)
        return -a + b


# ---------------------------------------------------------------------------
# Binary metrics (ref: src/metric/binary_metric.hpp)
# ---------------------------------------------------------------------------
class _BinaryMetric(Metric):
    def loss(self, label, prob):
        raise NotImplementedError

    def loss_torch(self, label, prob):
        raise NotImplementedError

    def eval(self, score, objective):
        s = score[0]
        if objective is not None:
            s = objective.convert_output(s)
        pt = self.loss(self.label, s)
        if self.weight is not None:
            sum_loss = float(np.sum(pt * self.weight))
        else:
            sum_loss = float(np.sum(pt))
        return [sum_loss / self.sum_weights]

    def has_device_form(self, objective) -> bool:
        return self._converts_on_device(objective)

    def eval_device(self, score_dev, objective, cache=None):
        if not self.has_device_form(objective):
            return None
        s = self._converted_row(score_dev, objective, cache)
        label, weight = self._dev_label_weight(score_dev.device)
        sum_loss = _weighted_sum(self.loss_torch(label, s), weight)
        return [sum_loss / self.sum_weights]


class BinaryLoglossMetric(_BinaryMetric):
    names = ["binary_logloss"]

    def loss(self, label, prob):
        # ref: binary_metric.hpp:119-130
        p = np.clip(np.where(label > 0, prob, 1.0 - prob), K_EPSILON, None)
        return -np.log(p)

    def loss_torch(self, label, prob):
        p = torch.clamp(torch.where(label > 0, prob, 1.0 - prob),
                        min=K_EPSILON)
        return -torch.log(p)


class BinaryErrorMetric(_BinaryMetric):
    names = ["binary_error"]

    def loss(self, label, prob):
        # ref: binary_metric.hpp:143-149
        return np.where(prob <= 0.5, (label > 0), (label <= 0)) \
            .astype(np.float64)

    def loss_torch(self, label, prob):
        return torch.where(prob <= 0.5, label > 0, label <= 0) \
            .to(torch.float32)


def _weighted_auc(label: np.ndarray, score: np.ndarray,
                  weight: Optional[np.ndarray]) -> float:
    """AUC with tie handling (ref: binary_metric.hpp:159-268 AUCMetric::Eval
    — trapezoid accumulation over score-sorted groups)."""
    pos = (label > 0).astype(np.float64)
    w = weight.astype(np.float64) if weight is not None else \
        np.ones_like(pos)
    order = np.argsort(-score, kind="stable")
    sp = pos[order]
    sw = w[order]
    ss = score[order]
    new_group = np.concatenate([[True], ss[1:] != ss[:-1]])
    gid = np.cumsum(new_group) - 1
    n_groups = gid[-1] + 1 if len(gid) else 0
    g_pos = np.zeros(n_groups)
    g_all = np.zeros(n_groups)
    np.add.at(g_pos, gid, sp * sw)
    np.add.at(g_all, gid, sw)
    g_neg = g_all - g_pos
    cum_pos_before = np.concatenate([[0.0], np.cumsum(g_pos)[:-1]])
    # ties contribute half
    s_area = np.sum(g_neg * (cum_pos_before + 0.5 * g_pos))
    total_pos = float(np.sum(sp * sw))
    total_neg = float(np.sum(sw)) - total_pos
    if total_pos <= 0 or total_neg <= 0:
        log.warning("AUC is undefined with only one class present")
        return 1.0
    return float(s_area / (total_pos * total_neg))


def _weighted_auc_torch(label: torch.Tensor, score: torch.Tensor,
                        weight: Optional[torch.Tensor]) -> torch.Tensor:
    """Device mirror of ``_weighted_auc``: the same tie-grouped trapezoid
    with f32 sums; a 0-d tensor."""
    n = score.shape[0]
    pos = (label > 0).to(torch.float32)
    w = weight if weight is not None else torch.ones_like(pos)
    order = torch.argsort(-score, stable=True)
    sp = pos[order] * w[order]
    sw = w[order]
    ss = score[order]
    new_group = torch.ones(n, dtype=torch.int32, device=score.device)
    new_group[1:] = (ss[1:] != ss[:-1]).to(torch.int32)
    gid = torch.cumsum(new_group, 0) - 1
    g_pos = torch.zeros(n, dtype=torch.float32, device=score.device) \
        .scatter_add_(0, gid, sp)
    g_all = torch.zeros(n, dtype=torch.float32, device=score.device) \
        .scatter_add_(0, gid, sw)
    g_neg = g_all - g_pos
    cum_pos_before = torch.zeros_like(g_pos)
    cum_pos_before[1:] = torch.cumsum(g_pos, 0)[:-1]
    s_area = torch.sum(g_neg * (cum_pos_before + 0.5 * g_pos))
    total_pos = torch.sum(sp)
    total_neg = torch.sum(sw) - total_pos
    # the one-class case matches the host form's 1.0
    return torch.where((total_pos <= 0) | (total_neg <= 0),
                       torch.ones((), device=score.device),
                       s_area / (total_pos * total_neg))


class AUCMetric(Metric):
    names = ["auc"]
    is_bigger_better = True

    def eval(self, score, objective):
        return [_weighted_auc(self.label, score[0], self.weight)]

    def has_device_form(self, objective) -> bool:
        return True

    def eval_device(self, score_dev, objective, cache=None):
        label, weight = self._dev_label_weight(score_dev.device)
        return [_weighted_auc_torch(label, score_dev[0], weight)]


class AveragePrecisionMetric(Metric):
    """ref: binary_metric.hpp:270-380 (weighted average precision)."""

    names = ["average_precision"]
    is_bigger_better = True

    def eval(self, score, objective):
        w = (self.weight.astype(np.float64) if self.weight is not None
             else np.ones(self.num_data))
        pos = (self.label > 0).astype(np.float64)
        order = np.argsort(-score[0], kind="stable")
        sp = pos[order] * w[order]
        sw = w[order]
        ss = score[0][order]
        new_group = np.concatenate([[True], ss[1:] != ss[:-1]])
        gid = np.cumsum(new_group) - 1
        n_groups = gid[-1] + 1
        g_pos = np.zeros(n_groups)
        g_all = np.zeros(n_groups)
        np.add.at(g_pos, gid, sp)
        np.add.at(g_all, gid, sw)
        cum_pos = np.cumsum(g_pos)
        cum_all = np.cumsum(g_all)
        total_pos = cum_pos[-1]
        if total_pos <= 0:
            log.warning("Average precision is undefined with no positives")
            return [1.0]
        precision = cum_pos / cum_all
        recall_delta = g_pos / total_pos
        return [float(np.sum(precision * recall_delta))]


# ---------------------------------------------------------------------------
# Cross-entropy metrics (ref: src/metric/xentropy_metric.hpp)
# ---------------------------------------------------------------------------
def _xent(label, prob):
    # soft labels in [0, 1] (ref: xentropy_metric.hpp:33 XentLoss)
    p = np.clip(prob, K_EPSILON, 1.0 - K_EPSILON)
    return -(label * np.log(p) + (1.0 - label) * np.log(1.0 - p))


def _stable_sigmoid(s):
    # saturated raw scores would overflow np.exp
    return 1.0 / (1.0 + np.exp(-np.clip(s, -500.0, 500.0)))


class CrossEntropyMetric(Metric):
    names = ["cross_entropy"]

    def eval(self, score, objective):
        pt = _xent(self.label, _stable_sigmoid(score[0]))
        if self.weight is not None:
            return [float(np.sum(pt * self.weight) / self.sum_weights)]
        return [float(np.sum(pt) / self.sum_weights)]


class CrossEntropyLambdaMetric(Metric):
    names = ["cross_entropy_lambda"]

    def eval(self, score, objective):
        # ref: xentropy_metric.hpp:196-226 — the lambda parameterization
        s = score[0]
        w = self.weight if self.weight is not None else 1.0
        hhat = np.logaddexp(0.0, s)   # log(1+e^s) without overflow
        z = 1.0 - np.exp(-w * hhat)
        z = np.clip(z, K_EPSILON, 1.0 - K_EPSILON)
        pt = _xent(self.label, z)
        return [float(np.sum(pt) / self.num_data)]


class KullbackLeiblerDivergence(Metric):
    """KL(label || sigmoid(score)) = xentropy minus label entropy
    (ref: xentropy_metric.hpp:249-320)."""

    names = ["kullback_leibler"]

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        # float64 before the clip: a float32 label rounds 1 - 1e-15 back
        # to exactly 1.0
        lab = np.clip(np.asarray(self.label, np.float64), K_EPSILON,
                      1.0 - K_EPSILON)
        ent = -(self.label * np.log(lab)
                + (1.0 - self.label) * np.log(1.0 - lab))
        # entropy is zero for hard 0/1 labels
        ent = np.where((self.label <= 0.0) | (self.label >= 1.0), 0.0, ent)
        if self.weight is not None:
            self.presum_label_entropy = float(np.sum(ent * self.weight)
                                              / self.sum_weights)
        else:
            self.presum_label_entropy = float(np.mean(ent))

    def eval(self, score, objective):
        pt = _xent(self.label, _stable_sigmoid(score[0]))
        if self.weight is not None:
            xent = float(np.sum(pt * self.weight) / self.sum_weights)
        else:
            xent = float(np.mean(pt))
        return [xent - self.presum_label_entropy]


# ---------------------------------------------------------------------------
# Multiclass metrics (ref: src/metric/multiclass_metric.hpp)
# ---------------------------------------------------------------------------
def _multiclass_probs_torch(objective, score):
    """[k, n] class probabilities of [k, n] scores on the device, as the
    host form's ``objective.convert_output`` gives them; None for an
    objective with no such form (``metric/traced.py:123-134``)."""
    if objective is None or objective.name in ("multiclass", "softmax"):
        e = torch.exp(score - score.amax(0, keepdim=True))
        return e / e.sum(0, keepdim=True)
    if objective.name == "multiclassova":
        return 1.0 / (1.0 + torch.exp(-float(objective.sigmoid) * score))
    return None


class _MulticlassMetric(Metric):
    def _dev_class_weight(self, device):
        """(int64 class labels, weights or None) on ``device``."""
        if getattr(self, "_cls_dev", None) is None \
                or self._cls_dev[0] != device:
            label, weight = self._dev_label_weight(device)
            self._cls_dev = (device, label.long(), weight)
        return self._cls_dev[1], self._cls_dev[2]


class MultiSoftmaxLoglossMetric(_MulticlassMetric):
    names = ["multi_logloss"]

    def has_device_form(self, objective) -> bool:
        return objective is None or objective.name in (
            "multiclass", "softmax", "multiclassova")

    def eval_device(self, score_dev, objective, cache=None):
        if not self.has_device_form(objective):
            return None
        li, weight = self._dev_class_weight(score_dev.device)
        probs = _multiclass_probs_torch(objective, score_dev)
        n = score_dev.shape[1]
        p = torch.clamp(probs[li, torch.arange(n, device=li.device)],
                        min=K_EPSILON)
        return [_weighted_sum(-torch.log(p), weight) / self.sum_weights]

    def eval(self, score, objective):
        # score: [num_class, n], converted by the objective where one is set
        k, n = score.shape
        if objective is not None:
            probs = objective.convert_output(score.T)  # [n, k]
        else:
            m = score - np.max(score, axis=0, keepdims=True)
            e = np.exp(m)
            probs = (e / np.sum(e, axis=0, keepdims=True)).T
        li = self.label.astype(np.int64)
        p = np.clip(probs[np.arange(n), li], K_EPSILON, None)
        pt = -np.log(p)
        if self.weight is not None:
            return [float(np.sum(pt * self.weight) / self.sum_weights)]
        return [float(np.sum(pt) / self.sum_weights)]


class MultiErrorMetric(_MulticlassMetric):
    names = ["multi_error"]

    def has_device_form(self, objective) -> bool:
        return True

    def eval_device(self, score_dev, objective, cache=None):
        li, weight = self._dev_class_weight(score_dev.device)
        n = score_dev.shape[1]
        true_score = score_dev[li, torch.arange(n, device=li.device)]
        num_larger = (score_dev >= true_score[None, :]).sum(0)
        err = (num_larger > int(self.config.multi_error_top_k)) \
            .to(torch.float32)
        return [_weighted_sum(err, weight) / self.sum_weights]

    def eval(self, score, objective):
        k, n = score.shape
        li = self.label.astype(np.int64)
        top_k = int(self.config.multi_error_top_k)
        # an error iff more than top_k classes score at least the true
        # class, itself included (ref: multiclass_metric.hpp:142-151)
        true_score = score[li, np.arange(n)]
        num_larger = np.sum(score >= true_score[None, :], axis=0)
        err = (num_larger > top_k).astype(np.float64)
        if self.weight is not None:
            return [float(np.sum(err * self.weight) / self.sum_weights)]
        return [float(np.sum(err) / self.sum_weights)]


class AucMuMetric(Metric):
    """AUC-mu (ref: multiclass_metric.hpp:183-337): the pairwise class
    separability averaged over all class pairs, under the auc_mu_weights
    decision matrix when one is given."""

    names = ["auc_mu"]
    is_bigger_better = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self.num_class = int(self.config.num_class)
        aw = self.config.auc_mu_weights
        nc = self.num_class
        if aw:
            W = np.asarray(aw, dtype=np.float64).reshape(nc, nc)
        else:
            W = np.ones((nc, nc)) - np.eye(nc)
        self.W = W

    def eval(self, score, objective):
        nc, n = score.shape
        li = self.label.astype(np.int64)
        w = (self.weight.astype(np.float64) if self.weight is not None
             else np.ones(n))
        total = 0.0
        cnt = 0
        for i in range(nc):
            for j in range(i + 1, nc):
                mask = (li == i) | (li == j)
                if not mask.any() or not ((li == i).any()
                                          and (li == j).any()):
                    cnt += 1
                    continue
                # the decision value from the weight matrix's rows
                # (ref: :252-276); class i should score the lower value
                v = (self.W[i, j] * score[j, mask]
                     - self.W[j, i] * score[i, mask])
                lab = (li[mask] == i).astype(np.float64)
                total += _weighted_auc(lab, -v, w[mask])
                cnt += 1
        return [total / max(cnt, 1)]


# ---------------------------------------------------------------------------
# Rank metrics (ref: src/metric/rank_metric.hpp, map_metric.hpp)
# ---------------------------------------------------------------------------
class NDCGMetric(Metric):
    """NDCG@k for each k of ``eval_at`` (ref: rank_metric.hpp); a query
    whose labels are all zero counts as perfect."""

    is_bigger_better = True

    def __init__(self, config):
        super().__init__(config)
        self.eval_at = [int(k) for k in (config.eval_at or [1, 2, 3, 4, 5])]
        self.names = [f"ndcg@{k}" for k in self.eval_at]
        self.label_gain = dcg.default_label_gain(config.label_gain)

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.query_boundaries is None:
            log.fatal("The NDCG metric requires query information")
        dcg.check_label(self.label, len(self.label_gain))
        qb = self.query_boundaries
        self.num_queries = len(qb) - 1
        # per-query ideal DCGs, -1 for an all-zero-label query
        self.inv_max_dcgs = np.zeros((self.num_queries, len(self.eval_at)))
        for q in range(self.num_queries):
            lab = np.asarray(self.label)[
                dcg.query_rows(qb, self.query_row_map, q)]
            for ki, k in enumerate(self.eval_at):
                m = dcg.max_dcg_at_k(k, lab, self.label_gain)
                self.inv_max_dcgs[q, ki] = 1.0 / m if m > 0 else -1.0
        self._ops = None

    def _accum(self, q, lab, sc, sums):
        for ki, k in enumerate(self.eval_at):
            if self.inv_max_dcgs[q, ki] <= 0:
                sums[ki] += 1.0            # (ref: rank_metric.hpp:88-92)
            else:
                d = dcg.dcg_at_k([k], lab, sc, self.label_gain)[0]
                sums[ki] += d * self.inv_max_dcgs[q, ki]

    def eval(self, score, objective):
        qb = self.query_boundaries
        result = np.zeros(len(self.eval_at))
        for q in range(self.num_queries):
            self._accum(q, self.label[qb[q]:qb[q + 1]],
                        score[0][qb[q]:qb[q + 1]], result)
        return list(result / self.num_queries)

    def eval_mp(self, score_local, objective, mp):
        if self.query_row_map is None:
            return None
        return self._eval_mp_ranked(score_local, mp, self._accum,
                                    len(self.eval_at))

    def has_device_form(self, objective) -> bool:
        # (the compacted layout of a rank layout evaluates on the host,
        # lightgbm_tpu/metric/traced.py:180-181)
        return self.num_queries > 0 and self.query_row_map is None

    def _device_ops(self, device):
        """The static operands of ``_ndcg_builder`` on ``device``: each
        row's gain, query id, the [n_k, n] discount of its slot after the
        lexsort (zero past each cutoff), and the per-query ideal DCGs."""
        if self._ops is not None and self._ops[0] == device:
            return self._ops[1]
        qb = np.asarray(self.query_boundaries, np.int64)
        n = int(qb[-1])
        sizes = np.diff(qb)
        row_gain = self.label_gain[self.label.astype(np.int64)]
        qid = np.repeat(np.arange(self.num_queries), sizes)
        pos = np.arange(n, dtype=np.int64) - qb[qid]
        disc = dcg.discounts(int(sizes.max()))
        factor = np.stack([np.where(pos < k, disc[pos], 0.0)
                           for k in self.eval_at])
        degenerate = self.inv_max_dcgs <= 0
        inv_max = np.where(degenerate, 0.0, self.inv_max_dcgs).T

        def t(a, dt=torch.float32):
            return torch.as_tensor(np.asarray(a), device=device).to(dt)
        ops = (t(row_gain), t(qid, torch.int64), t(factor), t(inv_max),
               t(degenerate.T, torch.bool))
        self._ops = (device, ops)
        return ops

    def eval_device(self, score_dev, objective, cache=None):
        if not self.has_device_form(objective):
            return None
        row_gain, qid, factor, inv_max_t, degen_t = self._device_ops(
            score_dev.device)
        nq = self.num_queries
        order = torch.sort(-score_dev[0], stable=True).indices
        order = order[torch.sort(qid[order], stable=True).indices]
        g_sorted = row_gain[order]
        out = []
        for ki in range(len(self.eval_at)):
            dcg_q = torch.zeros(nq, dtype=torch.float32,
                                device=score_dev.device).index_add_(
                0, qid, g_sorted * factor[ki])
            ndcg_q = torch.where(degen_t[ki], 1.0, dcg_q * inv_max_t[ki])
            out.append(torch.sum(ndcg_q) / float(nq))
        return out


class MapMetric(Metric):
    """MAP@k for each k of ``eval_at`` (ref: src/metric/map_metric.hpp);
    a host form only, as in the JAX package."""

    is_bigger_better = True

    def __init__(self, config):
        super().__init__(config)
        self.eval_at = [int(k) for k in (config.eval_at or [1, 2, 3, 4, 5])]
        self.names = [f"map@{k}" for k in self.eval_at]

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.query_boundaries is None:
            log.fatal("The MAP metric requires query information")
        self.num_queries = len(self.query_boundaries) - 1

    def _accum(self, q, lab, sc, sums):
        rel = (lab > 0).astype(np.float64)[np.argsort(-sc, kind="stable")]
        cum_rel = np.cumsum(rel)
        prec = cum_rel / np.arange(1, len(rel) + 1)
        for ki, k in enumerate(self.eval_at):
            kk = min(k, len(rel))
            n_rel = cum_rel[kk - 1] if kk > 0 else 0
            if n_rel > 0:
                sums[ki] += float(np.sum((prec * rel)[:kk]) / n_rel)

    def eval(self, score, objective):
        qb = self.query_boundaries
        result = np.zeros(len(self.eval_at))
        for q in range(self.num_queries):
            self._accum(q, self.label[qb[q]:qb[q + 1]],
                        score[0][qb[q]:qb[q + 1]], result)
        return list(result / self.num_queries)

    def eval_mp(self, score_local, objective, mp):
        # (the JAX package has no distributed MAP and skips the metric
        # under many processes; the port sums it as NDCG's)
        if self.query_row_map is None:
            return None
        return self._eval_mp_ranked(score_local, mp, self._accum,
                                    len(self.eval_at))


# ---------------------------------------------------------------------------
_REGISTRY = {
    "l2": L2Metric, "rmse": RMSEMetric, "l1": L1Metric,
    "quantile": QuantileMetric, "huber": HuberLossMetric,
    "fair": FairLossMetric, "poisson": PoissonMetric, "mape": MAPEMetric,
    "gamma": GammaMetric, "gamma_deviance": GammaDevianceMetric,
    "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric, "binary_error": BinaryErrorMetric,
    "auc": AUCMetric, "average_precision": AveragePrecisionMetric,
    "cross_entropy": CrossEntropyMetric,
    "cross_entropy_lambda": CrossEntropyLambdaMetric,
    "kullback_leibler": KullbackLeiblerDivergence,
    "multi_logloss": MultiSoftmaxLoglossMetric,
    "multi_error": MultiErrorMetric, "auc_mu": AucMuMetric,
    "ndcg": NDCGMetric, "map": MapMetric,
}


def create_metric(name: str, config: Config) -> Optional[Metric]:
    """Factory (ref: src/metric/metric.cpp:17 Metric::CreateMetric)."""
    raw = name.strip().lower()
    if raw in ("", "none", "null", "na", "custom"):
        return None
    # "ndcg@5" / "map@3" forms set eval_at inline
    if "@" in raw:
        base, ks = raw.split("@", 1)
        base = METRIC_ALIASES.get(base, base)
        if base in ("ndcg", "map"):
            cfg = Config(dict(config.to_dict()))
            cfg._values["eval_at"] = [int(k) for k in ks.split(",")]
            return _REGISTRY[base](cfg)
    resolved = METRIC_ALIASES.get(raw, raw)
    cls = _REGISTRY.get(resolved)
    if cls is None:
        log.fatal("Unknown metric type name: %s", name)
    return cls(config)


def default_metric_for_objective(objective_name: str) -> str:
    """Objective's eponymous metric (ref: config.cpp objective->metric map)."""
    mapping = {
        "regression": "l2", "regression_l1": "l1", "huber": "huber",
        "fair": "fair", "poisson": "poisson", "quantile": "quantile",
        "mape": "mape", "gamma": "gamma", "tweedie": "tweedie",
        "binary": "binary_logloss",
        "multiclass": "multi_logloss", "multiclassova": "multi_logloss",
        "cross_entropy": "cross_entropy",
        "cross_entropy_lambda": "cross_entropy_lambda",
        "lambdarank": "ndcg", "rank_xendcg": "ndcg",
    }
    return mapping.get(objective_name, "")
