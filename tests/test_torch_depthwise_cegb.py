"""The XLA engine's depth-wise grower and CEGB through the port against
the JAX package (``lightgbm_tpu/models/learner.py:996-1384``,
``boosting/gbdt.py:1406-1440``), on the CPU.

``grow_policy="depthwise"`` on ``tpu_engine="xla"``, then
``tests/test_cegb.py``'s four fixtures (a prohibitive coupled penalty, a
split penalty, a prohibitive lazy penalty, small lazy penalties through
``Booster.update()``), each through both packages: equal trees under
``torch_parity``'s near-tie rule, predictions within rtol 1e-5 / atol
1e-6, and after every tree the same ``cegb_used`` (and, under lazy
penalties, the same per-row bitmap ``cegb_used_rf``). CEGB moves the
engine to the XLA depth-wise grower in both. ``reset_parameter`` changing
the split penalty mid-run changes the next trees alike.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from torch_parity import assert_same_trees

torch.set_num_threads(1)


def _cegb_rows(R=3000, seed=0):
    """test_cegb.py's regression draw: feature 0 slightly stronger than
    feature 1, features 2 and 3 noise."""
    rng = np.random.RandomState(seed)
    X = rng.randn(R, 4).astype(np.float32)
    y = (1.0 * X[:, 0] + 0.9 * X[:, 1] + 0.1 * rng.randn(R)) \
        .astype(np.float32)
    return X, y


def _lazy_rows(n, seed, w1):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 3)
    y = (X[:, 0] + w1 * X[:, 1] > (1.4 if w1 == 2.0 else 0.8)) \
        .astype(np.float32)
    return X, y


REG = {"objective": "regression", "verbose": -1, "min_data_in_leaf": 5}
FIXTURES = {
    "coupled": (lambda: _cegb_rows(), dict(
        REG, num_leaves=15, cegb_tradeoff=1.0,
        cegb_penalty_feature_coupled=[1e9, 0, 0, 0]), 5),
    "split": (lambda: _cegb_rows(seed=1), dict(
        REG, num_leaves=31, cegb_penalty_split=0.5), 3),
    "lazy_block": (lambda: _lazy_rows(3000, 0, 2.0), {
        "objective": "binary", "num_leaves": 15, "verbose": -1,
        "cegb_penalty_feature_lazy": [0.0, 1e6, 0.0]}, 5),
    "lazy_reuse": (lambda: _lazy_rows(2000, 3, 0.5), {
        "objective": "binary", "num_leaves": 7, "verbose": -1,
        "cegb_penalty_feature_lazy": [1e-4, 1e-4, 1e-4]}, 4),
}


def _updates(params, X, y, rounds, reset_at=None, reset=None):
    """Both packages' boosters, ``rounds`` update() calls each, the CEGB
    state compared after every tree; ``reset`` given to
    ``reset_parameter`` before update ``reset_at``."""
    bj = lj.Booster(params=dict(params),
                    train_set=lj.Dataset(X, label=y, params={"verbose": -1}))
    bt = lt.Booster(params=dict(params, device_type="cpu"),
                    train_set=lt.Dataset(X, label=y,
                                         params={"device_type": "cpu"}))
    for it in range(rounds):
        if it == reset_at:
            bj.reset_parameter(dict(reset))
            bt.reset_parameter(dict(reset))
        stop_j, stop_t = bj.update(), bt.update()
        assert bool(stop_j) == bool(stop_t)
        gj, gt = bj._gbdt, bt._gbdt
        assert gt.use_cegb == gj.use_cegb
        if gt.use_cegb:
            np.testing.assert_array_equal(gt.cegb_used.numpy(),
                                          np.asarray(gj.cegb_used))
        if getattr(gj, "use_cegb_lazy", False):
            assert gt.use_cegb_lazy
            np.testing.assert_array_equal(gt.cegb_used_rf.numpy(),
                                          np.asarray(gj.cegb_used_rf))
    bj.num_trees()
    return bt, bj


def _same(bt, bj, X):
    assert_same_trees(bt.models, bj.models, X)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)


def test_depthwise_xla_matches_jax():
    X, y = _cegb_rows(2000, seed=5)
    p = dict(REG, num_leaves=15, tpu_engine="xla", grow_policy="depthwise")
    bj = lj.train(dict(p), lj.Dataset(X, label=y), 3)
    bj.num_trees()
    bt = lt.train(dict(p, device_type="cpu"), lt.Dataset(X, label=y), 3)
    g = bt._gbdt
    assert (g.use_fused, g.use_frontier, g.grow_policy) \
        == (False, False, "depthwise")
    assert g._fast_path_reason() == "engine:xla"
    assert all(m.num_leaves == 15 for m in bt.models)
    _same(bt, bj, X)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_cegb_fixture_matches_jax(name):
    data, params, rounds = FIXTURES[name]
    X, y = data()
    bt, bj = _updates(params, X, y, rounds)
    g = bt._gbdt
    assert g.use_cegb and g.grow_policy == "depthwise" and not g.use_fused
    assert g._fast_path_reason() == "engine:auto"
    _same(bt, bj, X)
    used = {int(f) for m in bt.models for f in m.split_feature[
        :m.num_internal]}
    if name == "coupled":
        assert 0 not in used
    if name == "lazy_block":
        assert 1 not in used and g.use_cegb_lazy
    if name == "lazy_reuse":
        assert int(g.cegb_used_rf.sum()) > 0


def test_reset_parameter_changes_the_split_penalty():
    X, y = _cegb_rows(2000, seed=1)
    p = dict(REG, num_leaves=31, cegb_penalty_split=1e-3)
    bt, bj = _updates(p, X, y, 4, reset_at=2,
                      reset={"cegb_penalty_split": 0.1})
    assert bt._gbdt.params.cegb_penalty_split == 0.1
    leaves = [m.num_leaves for m in bt.models]
    assert leaves[2] < leaves[1]
    _same(bt, bj, X)
