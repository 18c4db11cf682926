"""Objective functions (gradient/hessian producers).

PyTorch counterpart of ``lightgbm_tpu/objective`` for the objectives this
port has: ``binary`` and ``regression`` (L2). Others raise.
"""
from __future__ import annotations

from typing import Optional

from ..config import Config
from ..utils import log
from .base import ObjectiveFunction
from .binary import BinaryLogloss
from .regression import RegressionL2Loss

_REGISTRY = {
    "regression": RegressionL2Loss,
    "binary": BinaryLogloss,
}


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """Factory (ref: src/objective/objective_function.cpp:17).  Returns
    None for objective="none"."""
    name = config.objective
    if name in ("none", ""):
        return None
    cls = _REGISTRY.get(name)
    if cls is None:
        log.fatal("objective %s is not ported to lightgbm_tpu_torch yet "
                  "(available: %s)", name, ", ".join(sorted(_REGISTRY)))
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
        log.fatal("objective %s is not ported to lightgbm_tpu_torch yet",
                  name)
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
