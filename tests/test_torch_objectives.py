"""The pointwise objectives of the port against the JAX package.

For each of ``regression_l1``, ``huber``, ``fair``, ``poisson``,
``quantile``, ``mape``, ``gamma``, ``tweedie``, ``cross_entropy``,
``cross_entropy_lambda`` (and ``multiclass``/``multiclassova`` for the
gradients): the gradients and hessians on the same f32 scores within
rtol 1e-6 (atol 2.5e-7, two f32 ulps at 1: ``1 - y*exp(-s)`` and the like
cancel to small values, and XLA's and PyTorch's f32 ``exp`` may differ in
the last bit), with and without row weights; the weighted
``cross_entropy_lambda`` hessian within rtol 1e-5, because its closed form
subtracts ``c - 1`` with ``c = 1 / (1 - z)`` and so magnifies those last
bits (measured: 6.4e-6 at worst on these scores); ``boost_from_score``
equal; the renewed leaf values of the L1 family (``renew_tree_output`` on
the same residuals) equal; and the trees after 5 rounds of ``train()``
equal (``torch_parity.assert_same_trees``) on 2,000 x 5 rows at
num_leaves=7, max_bin=15, the JAX side on ``tpu_engine="fused",
tpu_fused_epilogue=False``. The renewing objectives train on the
synchronous body of both packages, the others on the megastep body.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.objective import create_objective as j_create
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.objective import create_objective as t_create
from torch_parity import assert_same_trees

torch.set_num_threads(1)

REGRESSION = ["regression_l1", "huber", "fair", "quantile", "mape"]
POSITIVE = ["poisson", "gamma", "tweedie"]
PROBABILITY = ["cross_entropy", "cross_entropy_lambda"]
ALL = REGRESSION + POSITIVE + PROBABILITY
ROUNDS = 5
PARAMS = {"num_leaves": 7, "max_bin": 15, "verbose": -1,
          "min_data_in_leaf": 5, "alpha": 0.7}
JAX_ENGINE = {"tpu_engine": "fused", "tpu_fused_epilogue": False}


class _Meta:
    def __init__(self, label, weight=None):
        self.label = label.astype(np.float32)
        self.weight = None if weight is None else weight.astype(np.float32)
        self.init_score = None
        self.query_boundaries = None


def _labels(objective, z):
    if objective in POSITIVE:
        return np.exp(0.5 * z)
    if objective in PROBABILITY:
        return 1.0 / (1.0 + np.exp(-z))
    if objective.startswith("multiclass"):
        return np.digitize(z, [-0.45, 0.45]).astype(np.float64)
    return 2.0 * z + 1.0


def _pair(objective, weighted, n=3000):
    rng = np.random.RandomState(5)
    z = rng.randn(n)
    meta = _Meta(_labels(objective, z),
                 rng.uniform(0.5, 2.0, n) if weighted else None)
    p = dict(PARAMS, objective=objective, num_class=3)
    jo, to = j_create(JConfig(p)), t_create(TConfig(p))
    jo.init(meta, n)
    to.init(meta, n, torch.device("cpu"))
    return jo, to, meta


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("objective", ALL + ["multiclass", "multiclassova"])
def test_gradients_match_jax(objective, weighted):
    jo, to, _ = _pair(objective, weighted)
    k = to.num_model_per_iteration
    assert k == jo.num_model_per_iteration
    score = np.random.RandomState(6).randn(k, 3000).astype(np.float32)
    gj, hj = jo.get_gradients(jnp.asarray(score))
    gt, ht = to.get_gradients(torch.as_tensor(score))
    assert gt.dtype == ht.dtype == torch.float32
    assert tuple(gt.shape) == tuple(ht.shape) == (k, 3000)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6,
                               atol=2.5e-7)
    rtol_h = 1e-5 if (objective, weighted) == ("cross_entropy_lambda",
                                                True) else 1e-6
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=rtol_h,
                               atol=2.5e-7)
    for c in range(k):
        assert to.boost_from_score(c) == pytest.approx(
            jo.boost_from_score(c), rel=1e-12, abs=1e-12)
        assert to.class_need_train(c) == jo.class_need_train(c)
    assert to.is_renew_tree_output == jo.is_renew_tree_output
    assert to.to_string() == jo.to_string()


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("objective", ["regression_l1", "quantile", "mape"])
def test_renewed_leaf_values_match_jax(objective, weighted):
    jo, to, meta = _pair(objective, weighted)
    rng = np.random.RandomState(8)
    for size in (1, 2, 7, 400):
        rows = np.sort(rng.choice(3000, size, replace=False))
        res = rng.randn(size) * 3.0
        assert to.renew_tree_output(0.5, res, rows) == \
            jo.renew_tree_output(0.5, res, rows)


def _data(objective):
    rng = np.random.RandomState(9)
    X = rng.randn(2000, 5)
    X[rng.rand(2000) < 0.05, 2] = np.nan
    z = X[:, 0] + 0.5 * np.nan_to_num(X[:, 2]) + 0.3 * rng.randn(2000)
    return X, _labels(objective, z)


def _train(pkg, objective, extra):
    X, y = _data(objective)
    bst = pkg.train(dict(PARAMS, objective=objective, **extra),
                    pkg.Dataset(X, label=y), ROUNDS)
    bst.num_trees()
    return bst


@pytest.mark.parametrize("objective", ALL)
def test_trees_match_jax(objective):
    X, _ = _data(objective)
    bt = _train(lt, objective, {"device_type": "cpu"})
    bj = _train(lj, objective, JAX_ENGINE)
    renew = objective in ("regression_l1", "quantile", "mape")
    assert (bt._gbdt._fast_path_reason() is not None) == renew
    assert bt.num_trees() == bj.num_trees() == ROUNDS
    assert_same_trees(bt.models, bj.models, X)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(bt.train_scores().numpy(),
                               np.asarray(bj._gbdt.scores)[0], rtol=1e-5,
                               atol=1e-6)
