"""GOSS through the port against the JAX package.

GOSS samples rows from |g·h| on the host: the rows at or above the
top_rate quantile (``np.partition``), plus other_rate of the rest drawn
by ``RandomState(bagging_seed).choice`` without replacement, whose
gradients are scaled by (n - top_k) / other_k; no sampling before
iteration 1/learning_rate. 2,000 x 6 rows, learning_rate 0.2 (sampling
from iteration 5), min_data_in_leaf=40, ``Booster.update()`` x 16 on both
packages with the JAX side on ``tpu_engine="fused",
tpu_fused_epilogue=False``: every iteration's bag mask and drawn rows
(hence its multiplier) bit-equal, and the trees equal
(``torch_parity.assert_same_trees``, leaf values within rtol 1e-5 and
atol 1e-5: the multiplier, 8 here, scales the drawn rows' gradients and
with them the last-bit differences of f32 histogram sums taken in another
order; measured 1.8e-6 at worst); the same for 3 classes over 8
iterations at learning_rate 0.25, where the |g·h| sum over the classes
must reach numpy in the same f32 bits as the JAX package's
``jnp.sum(axis=0)``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.boosting.gbdt import GOSS, abs_gh_class_sum
from torch_parity import assert_same_trees

torch.set_num_threads(1)

PARAMS = {"boosting": "goss", "num_leaves": 15, "max_bin": 15,
          "verbose": -1, "top_rate": 0.2, "other_rate": 0.1,
          "min_data_in_leaf": 40}
JAX_ENGINE = {"tpu_engine": "fused", "tpu_fused_epilogue": False}
CASES = {"binary": ({"objective": "binary", "learning_rate": 0.2}, 16),
         "multiclass": ({"objective": "multiclass", "num_class": 3,
                         "learning_rate": 0.25}, 8)}


def _data(objective):
    rng = np.random.RandomState(4)
    X = rng.randn(2000, 6)
    X[rng.rand(2000) < 0.05, 2] = np.nan
    z = X[:, 0] + 0.5 * X[:, 1] + 0.4 * rng.randn(2000)
    if objective == "binary":
        return X, (z > 0).astype(np.float64)
    return X, np.digitize(z, [-0.45, 0.45]).astype(np.float64)


class _Recorder:
    """Wraps the GOSS RandomState: keeps every ``choice`` result."""

    def __init__(self, rs):
        self.rs, self.drawn = rs, []

    def choice(self, *a, **kw):
        out = self.rs.choice(*a, **kw)
        self.drawn.append(np.sort(out))
        return out


def _run(pkg, case, extra):
    params, rounds = CASES[case]
    X, y = _data(params["objective"])
    bst = pkg.Booster(dict(PARAMS, **params, **extra),
                      pkg.Dataset(X, label=y))
    g = bst._gbdt
    rec = g.bag_rng = _Recorder(g.bag_rng)
    masks, counts = [], []
    for _ in range(rounds):
        bst.update()
        masks.append(np.asarray(g.bag_weight) > 0)
        counts.append(g.bag_cnt)
    return bst, masks, counts, rec.drawn


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    case = request.param
    return (case, _run(lt, case, {"device_type": "cpu"}),
            _run(lj, case, JAX_ENGINE))


def test_port_goss_is_the_sync_body(runs):
    case, (bt, *_), _ = runs
    assert isinstance(bt._gbdt, GOSS)
    assert bt._gbdt._fast_path_reason() == "boosting:goss"


def test_bags_bit_equal_jax(runs):
    case, (_, mt, ct, dt), (_, mj, cj, dj) = runs
    params, rounds = CASES[case]
    start = int(1.0 / params["learning_rate"])
    n = 2000
    top_k, other_k = int(n * 0.2), int(n * 0.1)
    assert ct == cj
    assert ct[:start] == [n] * start
    # rows tied at the threshold all count as top rows
    assert all(c >= top_k + other_k for c in ct[start:])
    assert len(dt) == len(dj) == rounds - start
    for a, b in zip(mt, mj):
        np.testing.assert_array_equal(a, b)
    # the drawn rows carry the (n - top_k) / other_k multiplier
    for a, b in zip(dt, dj):
        np.testing.assert_array_equal(a, b)
        assert len(a) == other_k


def test_trees_match_jax(runs):
    case, (bt, *_), (bj, *_) = runs
    X, _ = _data(CASES[case][0]["objective"])
    bj.num_trees()
    assert bt.num_trees() == bj.num_trees()
    assert_same_trees(bt.models, bj.models, X, atol=1e-5)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-5)


def test_class_sum_matches_jnp_sum():
    """|g·h| summed over 3 classes in class order by the port equals
    ``jnp.sum(jnp.abs(g * h), axis=0)`` bit for bit: numpy's threshold and
    draw see the same values."""
    rng = np.random.RandomState(0)
    g = rng.randn(3, 5000).astype(np.float32) * np.float32(3.7)
    h = rng.rand(3, 5000).astype(np.float32)
    want = np.asarray(jnp.sum(jnp.abs(jnp.asarray(g) * jnp.asarray(h)),
                              axis=0))
    got = abs_gh_class_sum(torch.as_tensor(g), torch.as_tensor(h))
    np.testing.assert_array_equal(got.numpy(), want)
