"""Objective functions (gradient/hessian producers).

PyTorch counterpart of ``lightgbm_tpu/objective``: ``binary``, the
regression losses (``regression``, ``regression_l1``, ``huber``, ``fair``,
``poisson``, ``quantile``, ``mape``, ``gamma``, ``tweedie``), ``multiclass``
and ``multiclassova``, ``cross_entropy`` and ``cross_entropy_lambda``. The
ranking objectives (``lambdarank``, ``rank_xendcg``) are not ported yet
(ROADMAP Queue A item 4) and raise.
"""
from __future__ import annotations

from typing import Optional

from ..config import Config
from ..utils import log
from .base import ObjectiveFunction
from .binary import BinaryLogloss
from .multiclass import MulticlassOVA, MulticlassSoftmax
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
}
_RANKING = ("lambdarank", "rank_xendcg")


def _unported(name: str) -> None:
    if name in _RANKING:
        log.fatal("objective %s is not ported to lightgbm_tpu_torch yet "
                  "(ranking: ROADMAP Queue A item 4)", name)
    log.fatal("Unknown objective type name: %s", name)


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """Factory (ref: src/objective/objective_function.cpp:17).  Returns
    None for objective="none"."""
    name = config.objective
    if name in ("none", ""):
        return None
    cls = _REGISTRY.get(name)
    if cls is None:
        _unported(name)
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
        _unported(name)
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
