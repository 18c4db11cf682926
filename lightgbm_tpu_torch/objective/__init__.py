"""Objective functions (gradient/hessian producers).

PyTorch counterpart of ``lightgbm_tpu/objective``: ``binary``, the
regression losses (``regression``, ``regression_l1``, ``huber``, ``fair``,
``poisson``, ``quantile``, ``mape``, ``gamma``, ``tweedie``), ``multiclass``
and ``multiclassova``, ``cross_entropy`` and ``cross_entropy_lambda``, and
the ranking objectives ``lambdarank`` and ``rank_xendcg`` (which need query
groups, ``Dataset(group=...)``).
"""
from __future__ import annotations

from typing import Optional

from ..config import Config
from ..utils import log
from .base import ObjectiveFunction
from .binary import BinaryLogloss
from .multiclass import MulticlassOVA, MulticlassSoftmax
from .rank import LambdarankNDCG, RankXENDCG
from .regression import (RegressionFairLoss, RegressionGammaLoss,
                         RegressionHuberLoss, RegressionL1Loss,
                         RegressionL2Loss, RegressionMAPELoss,
                         RegressionPoissonLoss, RegressionQuantileLoss,
                         RegressionTweedieLoss)
from .xentropy import CrossEntropy, CrossEntropyLambda

_REGISTRY = {
    "regression": RegressionL2Loss,
    "regression_l1": RegressionL1Loss,
    "huber": RegressionHuberLoss,
    "fair": RegressionFairLoss,
    "poisson": RegressionPoissonLoss,
    "quantile": RegressionQuantileLoss,
    "mape": RegressionMAPELoss,
    "gamma": RegressionGammaLoss,
    "tweedie": RegressionTweedieLoss,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
    "lambdarank": LambdarankNDCG,
    "rank_xendcg": RankXENDCG,
}


def _unknown(name: str) -> None:
    log.fatal("Unknown objective type name: %s", name)


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """Factory (ref: src/objective/objective_function.cpp:17).  Returns
    None for objective="none"."""
    name = config.objective
    if name in ("none", ""):
        return None
    cls = _REGISTRY.get(name)
    if cls is None:
        _unknown(name)
    return cls(config)


def create_objective_from_string(s: str) -> Optional[ObjectiveFunction]:
    """Rebuild an objective from its model-file ToString form
    (ref: objective_function.cpp:49 CreateObjectiveFunction(str))."""
    tokens = s.strip().split(" ")
    if not tokens or tokens[0] in ("none", ""):
        return None
    name = tokens[0]
    cls = _REGISTRY.get(name)
    if cls is None:
        _unknown(name)
    params = {}
    for tok in tokens[1:]:
        if ":" in tok:
            k, v = tok.split(":", 1)
            params[k] = v
        elif tok == "sqrt":
            params["reg_sqrt"] = True
    cfg = Config(params)
    cfg._values["objective"] = name  # keep resolved name
    return cls(cfg)
