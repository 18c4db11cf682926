"""What trains on the other engines trains on the XLA engine too: valid
sets and metrics, multiclass, GOSS, leaf renewal (``regression_l1``),
DART, RF and linear-tree leaves with ``tpu_engine="xla"``, through the
port against the JAX package on the CPU (whose ``auto`` engine is this
one). Equal trees under ``torch_parity``'s near-tie rule, predictions
within rtol 1e-5 / atol 1e-6 (GOSS: atol 1e-5, as in
``test_torch_goss.py``: its multiplier, 8 here, scales the sampled rows'
gradients and with them the f32 sum-order differences), the valid
metric equal within 1e-6.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from torch_parity import assert_same_trees

torch.set_num_threads(1)

BASE = {"num_leaves": 15, "verbose": -1, "min_data_in_leaf": 5,
        "tpu_engine": "xla"}
CASES = {
    "valid": dict(objective="binary", metric="auc"),
    "multiclass": dict(objective="multiclass", num_class=3),
    "goss": dict(objective="binary", boosting="goss", learning_rate=0.5),
    "regression_l1": dict(objective="regression_l1"),
    "dart": dict(objective="binary", boosting="dart", drop_rate=0.5,
                 skip_drop=0.0),
    "rf": dict(objective="binary", boosting="rf", bagging_fraction=0.7,
               bagging_freq=1),
    "linear_tree": dict(objective="regression", linear_tree=True),
}


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5)
    z = X[:, 0] + 0.7 * X[:, 1] - 0.4 * X[:, 2] + 0.3 * rng.randn(n)
    return X, z


def _label(name, z):
    if name == "multiclass":
        return np.digitize(z, [-0.5, 0.5]).astype(float)
    if CASES[name]["objective"] in ("regression", "regression_l1"):
        return z
    return (z > 0).astype(float)


@pytest.mark.parametrize("name", list(CASES))
def test_xla_engine_trains_what_the_others_do(name):
    X, z = _rows(2000, 0)
    y = _label(name, z)
    p = dict(BASE, **CASES[name])
    dp = {"linear_tree": True} if name == "linear_tree" else {}
    dj = lj.Dataset(X, label=y, params=dict(dp))
    dt = lt.Dataset(X, label=y, params=dict(dp, device_type="cpu"))
    kj, kt = {}, {}
    if name == "valid":
        Xv, zv = _rows(500, 1)
        kj = {"valid_sets": [lj.Dataset(Xv, label=(zv > 0).astype(float),
                                        reference=dj)]}
        kt = {"valid_sets": [lt.Dataset(Xv, label=(zv > 0).astype(float),
                                        reference=dt)]}
    bj = lj.train(dict(p), dj, 4, **kj)
    bj.num_trees()
    bt = lt.train(dict(p, device_type="cpu"), dt, 4, **kt)
    g = bt._gbdt
    assert not (g.use_fused or g.use_frontier)
    assert g.grow_policy == "leafwise"
    atol = 1e-5 if name == "goss" else 1e-6
    assert_same_trees(bt.models, bj.models, X, atol=atol)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-5,
                               atol=atol)
    if name == "valid":
        (_, m, vt, _), = bt.eval_valid()
        (_, _, vj, _), = bj.eval_valid()
        assert m == "auc" and abs(vt - vj) <= 1e-6
