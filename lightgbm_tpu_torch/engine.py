"""Training entry point (PyTorch counterpart of ``lightgbm_tpu/engine.py``).

``train(params, train_set, num_boost_round)`` runs the boosting loop on the
device the params name (``device_type``, default ``"cuda"``). Valid sets,
callbacks, early stopping, custom objectives and ``init_model`` are not
ported yet.

Which iteration body runs (``boosting/gbdt.py``): ``train`` arms the
megastep body while ``tpu_megastep`` is true (the default), as the JAX
package's ``engine.train`` does on the TPU; with ``tpu_megastep=False`` it
takes the epilogue body, as a bare ``Booster.update()`` loop does, wherever
that body applies (binary or L2, ``tpu_fused_epilogue``).
"""
from __future__ import annotations

from typing import Any, Dict

from .basic import Booster, Dataset

_ROUND_ALIASES = ("num_iterations", "num_iteration", "n_iter", "num_tree",
                  "num_trees", "num_round", "num_rounds", "nrounds",
                  "num_boost_round", "n_estimators", "max_iter")


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100) -> Booster:
    """Train a booster (ref: engine.py:25); stops early only when no split
    meets the requirements. Runs the megastep body unless
    ``tpu_megastep=False`` (module docstring)."""
    params = dict(params) if params else {}
    # round-count aliases in params win, as in the JAX package
    for alias in _ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
    params["num_iterations"] = num_boost_round
    booster = Booster(params=params, train_set=train_set)
    booster._gbdt.arm_megastep(bool(booster.config.tpu_megastep))
    for _ in range(num_boost_round):
        if booster.update():
            break
    return booster
