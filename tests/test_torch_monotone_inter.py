"""Monotone constraints in the intermediate mode through the port against
the JAX package's fused engine, and the advanced mode's degrade.

``test_torch_monotone``'s fixture (the adversarial rows behind a constant
column, ``monotone_constraints=[0, 1, 0]``), 20 rounds through ``train()``
(the megastep body): ``monotone_constraints_method=intermediate`` gives
the JAX package's trees (clipped child outputs, cross-tightened bounds,
stale-leaf rescans), and ``advanced``, which needs the leaf-wise grower,
degrades to ``intermediate`` in both packages with the same warning and
the same trees. Predictions are monotone in x0.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.utils import log as jlog
from lightgbm_tpu_torch.utils import log as tlog
from test_torch_monotone import (JAX_ENGINE, PARAMS, ROUNDS, adversarial,
                                 count_clipped, worst_step)
from torch_parity import assert_same_trees

torch.set_num_threads(1)

ADVANCED_WARNING = ("monotone_constraints_method=advanced (segment bound "
                    "planes) runs on the leaf-wise grower; this "
                    "configuration uses intermediate instead")


def _train(pkg, method, **extra):
    X, y = adversarial()
    bst = pkg.train(dict(PARAMS, monotone_constraints_method=method,
                         **extra), pkg.Dataset(X, label=y), ROUNDS)
    bst.num_trees()
    return bst


def _logged(log, fn):
    """fn() with the lines of ``log`` (a package's logger) collected."""
    lines = []
    log.register_logger(lines.append)
    try:
        out = fn()
    finally:
        log.register_logger(None)
    return out, lines


@pytest.mark.parametrize("method", ["intermediate", "advanced"])
def test_intermediate_matches_jax(method, monkeypatch):
    X, _ = adversarial()
    clipped = count_clipped(monkeypatch)
    verbose = {"verbose": 0}        # warnings on
    bt, t_lines = _logged(tlog, lambda: _train(lt, method, device_type="cpu",
                                             **verbose))
    bj, j_lines = _logged(jlog, lambda: _train(lj, method, **JAX_ENGINE,
                                             **verbose))
    assert bt._gbdt.mono_mode == bj._gbdt.mono_mode == "intermediate"
    warned = [any(ADVANCED_WARNING in s for s in lines)
              for lines in (t_lines, j_lines)]
    assert warned == [method == "advanced"] * 2
    assert bt.num_trees() == bj.num_trees() == ROUNDS
    assert clipped["clipped"] > 0
    assert_same_trees(bt.models, bj.models, X)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-5,
                               atol=1e-6)
    assert worst_step(bt) >= -1e-6
    assert worst_step(bj) >= -1e-6
