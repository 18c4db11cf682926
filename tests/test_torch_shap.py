"""TreeSHAP ``pred_contrib`` through the port against the JAX package.

Models trained by the port on the CPU (2,000 x 6 rows from a numpy seed,
5% NaN in column 0, exact zeros in column 1, column 2 a categorical code
0-5; 15 leaves, max_bin 31): a binary gbdt with column 2 categorical, a
3-class multiclass, DART, RF and a linear-tree regression. The JAX
package explains the same model text (its host recursion, no JAX
program). On 120 rows with every routing case (NaN, zeros, negative,
fractional and unseen categories):

- the device form (``io.shap.predict_contrib`` through ``Booster.predict``,
  here on CPU tensors), the plain form (``predict_contrib_plain``) and the
  JAX package's ``predict_contrib`` agree within rtol/atol 1e-9, in
  float64;
- gbdt, multiclass and DART: each class block's contributions plus its
  expected value equal ``predict(raw_score=True)`` within 1e-9, but for
  a NaN in a categorical column, which SHAP reads as category 0 (as the
  JAX package does) and the predictor sends right;
- RF and linear trees are explained as the JAX package explains them, and
  are not additive: RF's blocks sum to the trees' sum, not their mean;
  a linear tree's to its constant leaves, not its linear outputs;
- ``start_iteration``/``num_iteration`` select the trees as ``predict``
  does, and CSR input gives the dense input's contributions;
- patterns over several int64 words give the one-word result within
  1e-12, and a second call the same bits.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.io.shap import predict_contrib_plain

torch.set_num_threads(1)

BASE = {"num_leaves": 15, "max_bin": 31, "min_data_in_leaf": 20,
        "verbose": -1, "device_type": "cpu"}
MODELS = {
    "gbdt": ({"objective": "binary"}, 8),
    "multiclass": ({"objective": "multiclass", "num_class": 3}, 5),
    "dart": ({"objective": "binary", "boosting": "dart", "skip_drop": 0.0,
              "drop_rate": 0.3}, 8),
    "rf": ({"objective": "binary", "boosting": "rf",
            "bagging_fraction": 0.6, "bagging_freq": 1}, 6),
    "linear": ({"objective": "regression", "linear_tree": True}, 5),
}


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[rng.rand(n) < 0.05, 0] = np.nan
    X[rng.rand(n) < 0.3, 1] = 0.0
    X[:, 2] = rng.randint(0, 6, n)
    z = np.nan_to_num(X[:, 0]) + 0.8 * X[:, 1] + 0.5 * (X[:, 2] % 3) \
        - 0.5 + 0.3 * X[:, 3] + 0.3 * rng.randn(n)
    return X, z


def _odd_rows():
    X, _ = _rows(120, 9)
    X[:10, 0] = np.nan
    X[10:20, 1] = 0.0
    X[20:40, 2] = np.array([-1.0, 2.5, 7.0, 99.0, np.nan] * 4)
    X[40:45, 3] = np.nan
    return X


@pytest.fixture(scope="module")
def models():
    X, z = _rows(2000, 0)
    labels = {"binary": (z > 0).astype(float),
              "multiclass": np.digitize(z, [-0.5, 0.5]).astype(float),
              "regression": z}
    out = {}
    for name, (params, rounds) in MODELS.items():
        ds = lt.Dataset(X, label=labels[params["objective"]],
                        categorical_feature=[2] if name == "gbdt" else [])
        out[name] = lt.train(dict(BASE, **params), ds, rounds)
    return out


def _jax(bst):
    return lj.Booster(model_str=bst.model_to_string())


@pytest.mark.parametrize("name", list(MODELS))
def test_device_plain_and_jax_agree(models, name):
    bst = models[name]
    X = _odd_rows()
    got = bst.predict(X, pred_contrib=True)
    k = bst.num_model_per_iteration()
    assert got.shape == (len(X), k * 7) and got.dtype == np.float64
    plain = predict_contrib_plain(bst.models, X, k, 6)
    np.testing.assert_allclose(got, plain, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got, _jax(bst).predict(X, pred_contrib=True),
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name", ["gbdt", "multiclass", "dart"])
def test_additive(models, name):
    bst = models[name]
    X = _odd_rows()
    k = bst.num_model_per_iteration()
    sums = bst.predict(X, pred_contrib=True).reshape(len(X), k, 7).sum(2)
    raw = np.asarray(bst.predict(X, raw_score=True)).reshape(len(X), k)
    # SHAP reads a NaN category as category 0 where the predictor sends it
    # right (the JAX package's rules, shap.py:27-29): those rows of the
    # categorical model are left out
    ok = ~np.isnan(X[:, 2]) if name == "gbdt" else np.ones(len(X), bool)
    np.testing.assert_allclose(sums[ok], raw[ok], rtol=1e-9, atol=1e-9)
    if name == "gbdt":
        assert not np.allclose(sums[~ok], raw[~ok], atol=1e-3)


def test_rf_and_linear_are_not_additive(models):
    """The JAX package's explanation, matched: RF's contributions add up
    to the sum of its trees (not the averaged prediction), a linear tree's
    to its constant leaves."""
    X = _odd_rows()
    rf = models["rf"]
    sums = rf.predict(X, pred_contrib=True).sum(1)
    raw = rf.predict(X, raw_score=True)
    np.testing.assert_allclose(sums, raw * rf.num_trees(), rtol=1e-9,
                               atol=1e-9)
    assert not np.allclose(sums, raw, atol=1e-3)
    lin = models["linear"]
    sums = lin.predict(X, pred_contrib=True).sum(1)
    const = lt.Booster(params={"device_type": "cpu"},
                       model_str=lin.model_to_string())
    for t in const.models:
        t.is_linear = False
    np.testing.assert_allclose(sums, const.predict(X, raw_score=True),
                               rtol=1e-9, atol=1e-9)
    assert not np.allclose(sums, lin.predict(X, raw_score=True), atol=1e-3)


@pytest.mark.parametrize("name", ["gbdt", "multiclass"])
def test_iterations_and_csr(models, name):
    bst = models[name]
    X = _odd_rows()
    bj = _jax(bst)
    kw = dict(pred_contrib=True, start_iteration=2, num_iteration=3)
    got = bst.predict(X, **kw)
    np.testing.assert_allclose(got, bj.predict(X, **kw), rtol=1e-9,
                               atol=1e-9)
    raw = bst.predict(X, raw_score=True, start_iteration=2, num_iteration=3)
    k = bst.num_model_per_iteration()
    ok = ~np.isnan(X[:, 2])      # as in test_additive
    np.testing.assert_allclose(got.reshape(len(X), k, 7).sum(2)[ok],
                               np.asarray(raw).reshape(len(X), k)[ok],
                               rtol=1e-9, atol=1e-9)
    Xs = np.nan_to_num(X)      # CSR holds no NaN: missing is zero
    np.testing.assert_allclose(bst.predict(sp.csr_matrix(Xs),
                                           pred_contrib=True),
                               bst.predict(Xs, pred_contrib=True),
                               rtol=0, atol=0)


def test_patterns_over_several_words(models, monkeypatch):
    """Paths too long for one pattern word (``io.shap._BITS`` elements
    per word; 2 here, so every tree's keys take several words and are
    renumbered before each) give the one-word contributions; a second
    call gives the same bits."""
    from lightgbm_tpu_torch.io import shap
    bst = models["multiclass"]
    X = _odd_rows()
    want = bst.predict(X, pred_contrib=True)
    assert np.array_equal(bst.predict(X, pred_contrib=True), want)
    monkeypatch.setattr(shap, "_BITS", 2)
    np.testing.assert_allclose(bst.predict(X, pred_contrib=True), want,
                               rtol=1e-12, atol=1e-12)
