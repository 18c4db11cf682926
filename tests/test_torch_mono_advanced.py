"""The advanced monotone mode through the port against the JAX package
(the leaf-wise grower's segment bound planes,
``lightgbm_tpu/models/learner.py:922-964``, ``ops/split.py:259-296``), on
the CPU.

``tests/test_monotone.py:153-183``'s fixture (y rises with x0 everywhere
and, where x1 > 0.5, by x0 * x2 more: the signal needs a child to escape
its neighbour's shadow), cut to 3,000 rows and 5 rounds: ``advanced``
through both packages gives equal trees under ``torch_parity``'s
near-tie rule and predictions within rtol 1e-5 / atol 1e-6; the port's
model is monotone in x0 (worst step >= -1e-9 along 200 sweeps) and fits
at least as well as its intermediate mode (MSE within x 1.0001), and
differently. On the depth-wise grower ``advanced`` degrades to
``intermediate`` in both packages, with the same warning and trees.
"""
import numpy as np
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.utils import log as jlog
from lightgbm_tpu_torch.utils import log as tlog
from torch_parity import assert_same_trees

torch.set_num_threads(1)

MONO = [1, 0, 0]
PARAMS = {"objective": "regression", "num_leaves": 31, "verbose": 0,
          "monotone_constraints": MONO}
ROUNDS = 5
DEGRADE = ("monotone_constraints_method=advanced (segment bound planes) "
           "runs on the leaf-wise grower; this configuration uses "
           "intermediate instead")


def _rows():
    rng = np.random.RandomState(2)
    n = 3000
    X = rng.rand(n, 3)
    y = (1.5 * X[:, 0]
         + np.where(X[:, 1] > 0.5, 2.0 * X[:, 0] * X[:, 2], 0.0)
         + 0.05 * rng.randn(n)).astype(np.float32)
    return X, y


def _sweep_worst(bst, rng, sweeps=200, pts=64):
    worst = 0.0
    for _ in range(sweeps):
        ctx = rng.rand(1, 3).repeat(pts, axis=0)
        ctx[:, 0] = np.linspace(0, 1, pts)
        worst = min(worst, float(np.diff(bst.predict(ctx)).min()))
    return worst


def _port(method, **extra):
    X, y = _rows()
    return lt.train(dict(PARAMS, monotone_constraints_method=method,
                         tpu_engine="xla", device_type="cpu", **extra),
                    lt.Dataset(X, label=y), ROUNDS)


def _jax(method, **extra):
    X, y = _rows()
    bst = lj.train(dict(PARAMS, monotone_constraints_method=method, **extra),
                   lj.Dataset(X, label=y), ROUNDS)
    bst.num_trees()
    return bst


def _same(bt, bj):
    X, _ = _rows()
    assert_same_trees(bt.models, bj.models, X)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-5,
                               atol=1e-6)


def test_advanced_matches_jax_and_is_monotone():
    X, y = _rows()
    ba, bj = _port("advanced"), _jax("advanced")
    assert ba._gbdt.mono_mode == bj._gbdt.mono_mode == "advanced"
    assert ba._gbdt.grow_policy == "leafwise"
    _same(ba, bj)
    assert _sweep_worst(ba, np.random.RandomState(3)) >= -1e-9
    bi = _port("intermediate")
    assert bi._gbdt.mono_mode == "intermediate"
    mse_a = float(np.mean((ba.predict(X) - y) ** 2))
    mse_i = float(np.mean((bi.predict(X) - y) ** 2))
    assert mse_a <= mse_i * 1.0001, (mse_a, mse_i)
    assert not np.allclose(ba.predict(X), bi.predict(X))


def test_advanced_on_depthwise_degrades_to_intermediate():
    lines_t, lines_j = [], []
    tlog.register_logger(lines_t.append)
    jlog.register_logger(lines_j.append)
    try:
        bt = _port("advanced", grow_policy="depthwise", num_leaves=15)
        bj = _jax("advanced", grow_policy="depthwise", num_leaves=15)
    finally:
        tlog.register_logger(None)
        jlog.register_logger(None)
    for b, lines in ((bt, lines_t), (bj, lines_j)):
        assert b._gbdt.mono_mode == "intermediate"
        assert b._gbdt.grow_policy == "depthwise"
        assert any(DEGRADE in s for s in lines)
    _same(bt, bj)
