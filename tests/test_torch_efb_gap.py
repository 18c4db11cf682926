"""Exclusive feature bundling (EFB) on dense data: the port bundles where
the JAX package bundles, into the same bundles, and grows the same trees.

``enable_bundle`` defaults to true, and both packages' fused engines
bundle whenever bundling cuts the column count
(``lightgbm_tpu/boosting/gbdt.py`` ``_setup_bundles``; the port's
``GBDT._setup_bundles``, where ``tpu_engine="auto"`` is the fused
engine). 3,000 rows of 3 dense and 8 mutually exclusive columns, binary,
7 leaves, 3 rounds, ``enable_bundle`` left at its default. Each test
checks that both sides really bundled (else it proves nothing) into the
same bundle lists, then equal trees under tests/torch_parity.py's
near-tie rule and raw predictions within 1e-6: through ``train()`` (the
megastep body) and through a bare ``update()`` loop (the epilogue body,
whose ``epilogue_pass`` then builds the root histogram of bundle
columns). Seven leaves keep every split on signal: at 15 leaves the last
splits of the first tree tie exactly between a dense and a bundled column
(gain 2.644 both), and the packages' search orders may break the tie
differently. One JAX configuration, in a file of its own, so its
interpret-mode compile runs beside the other files. (The first test's
name dates from when the port trained unbundled.)
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from torch_parity import assert_same_trees

# small shapes: intra-op threads would only contend with the other test
# workers' processes
torch.set_num_threads(1)

ROUNDS = 3
P = {"objective": "binary", "num_leaves": 7, "verbose": -1}


def _data():
    """3 dense columns and 8 columns of which each row sets at most one."""
    rng = np.random.RandomState(11)
    n = 3000
    dense = rng.randn(n, 3)
    sparse = np.zeros((n, 8))
    which = rng.randint(-1, 8, n)                # -1: no sparse column set
    rows = np.nonzero(which >= 0)[0]
    sparse[rows, which[rows]] = rng.uniform(0.5, 3.0, rows.size)
    X = np.hstack([dense, sparse])
    y = (dense[:, 0] + 0.8 * sparse[:, 2] - 0.6 * sparse[:, 5]
         + 0.3 * rng.randn(n) > 0).astype(np.float64)
    return X, y


@pytest.fixture(scope="module")
def jax_booster():
    X, y = _data()
    assert ((X[:, 3:] != 0).sum(1) <= 1).all()   # mutually exclusive
    assert "enable_bundle" not in P                 # the default: true
    bj = lj.train(dict(P, tpu_engine="fused", tpu_fused_epilogue=False),
                  lj.Dataset(X, label=y), num_boost_round=ROUNDS)
    assert bj.num_trees() == ROUNDS
    assert bj._gbdt.use_bundles                     # the JAX side bundled
    return bj


def _assert_bundled_alike(bt, bj, X):
    gt, gj = bt._gbdt, bj._gbdt
    assert gt.use_bundles
    np.testing.assert_array_equal(gt.bundle_cfg.col_of_feat.numpy(),
                                  np.asarray(gj.bundle_cfg.col_of_feat))
    np.testing.assert_array_equal(gt.bundle_cfg.offset_of_feat.numpy(),
                                  np.asarray(gj.bundle_cfg.offset_of_feat))
    np.testing.assert_array_equal(gt.bundle_bins_dev.numpy(),
                                  np.asarray(gj.bundle_bins_dev))
    assert gt.bundle_col_bins == gj.bundle_col_bins
    assert gt.fused_bundle_cols < X.shape[1]
    assert bj.num_trees() == bt.num_trees() == ROUNDS
    assert_same_trees(bt.models, bj.models, X)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=0,
                               atol=1e-6)


def test_port_trains_unbundled_with_the_jax_package_bundles(jax_booster):
    X, y = _data()
    bt = lt.train(dict(P, device_type="cpu"), lt.Dataset(X, label=y),
                  num_boost_round=ROUNDS)
    _assert_bundled_alike(bt, jax_booster, X)


def test_port_update_body_bundles_as_the_jax_package(jax_booster):
    X, y = _data()
    bt = lt.Booster(dict(P, device_type="cpu"), lt.Dataset(X, label=y))
    assert bt._gbdt._use_epilogue()
    for _ in range(ROUNDS):
        bt.update()
    _assert_bundled_alike(bt, jax_booster, X)


def test_bundling_stays_off_where_the_jax_package_keeps_it_off():
    """The frontier engine (no bundling unless asked) and
    ``enable_bundle=False``: neither package bundles."""
    X, y = _data()
    for extra in ({"tpu_engine": "frontier"}, {"enable_bundle": False}):
        bt = lt.Booster(dict(P, device_type="cpu", **extra),
                        lt.Dataset(X, label=y))
        assert not bt._gbdt.use_bundles, extra
    bt = lt.Booster(dict(P, device_type="cpu", tpu_engine="frontier",
                         tpu_enable_bundle=True), lt.Dataset(X, label=y))
    assert bt._gbdt.use_bundles and not bt._gbdt.use_frontier
