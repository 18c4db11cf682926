"""The port's whole training slice against the JAX package.

``lightgbm_tpu_torch.train(..., device_type="cpu")`` against
``lightgbm_tpu.train(..., tpu_engine="fused", tpu_fused_epilogue=False)`` on
2,000 rows x 6 features (one 5% NaN), num_leaves=15, max_bin=15, 5 rounds,
binary, and L2 with row weights, and weighted binary at max_bin=255
(Bp=256, int16 bins, the library's default width): bin boundaries and tree
structure equal, raw predictions
within rtol=1e-5, atol=1e-6 (leaf values are f32 sums taken in another
order). Model texts cross between the packages both ways.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import convert
from torch_parity import assert_same_trees

# small shapes: intra-op threads would only contend with the other test
# workers' processes
torch.set_num_threads(1)

ROUNDS = 5
PARAMS = {"num_leaves": 15, "verbose": -1}


def _data():
    rng = np.random.RandomState(0)
    X = rng.randn(2000, 6)
    X[rng.rand(2000) < 0.05, 3] = np.nan
    y = (X[:, 0] + 0.5 * np.nan_to_num(X[:, 3]) + 0.3 * rng.randn(2000)
         > 0).astype(np.float64)
    return X, y


@pytest.fixture(scope="module", params=[("binary", 15, False),
                                        ("regression", 15, True),
                                        ("binary", 255, True)],
                ids=["binary", "regression-weighted", "binary-int16-weighted"])
def trained(request):
    X, y = _data()
    objective, max_bin, weighted = request.param
    w = (np.random.RandomState(1).uniform(0.5, 2.0, len(y)) if weighted
         else None)
    p = dict(PARAMS, objective=objective, max_bin=max_bin)
    dt = lt.Dataset(X, label=y, weight=w)
    bt = lt.train(dict(p, device_type="cpu"), dt, num_boost_round=ROUNDS)
    assert bt._gbdt.fused_bins_T.dtype == (torch.int16 if max_bin > 127
                                           else torch.int8)
    dj = lj.Dataset(X, label=y, weight=w)
    bj = lj.train(dict(p, tpu_engine="fused", tpu_fused_epilogue=False), dj,
                  num_boost_round=ROUNDS)
    assert bj.num_trees() == ROUNDS      # settles the pipelined trees
    return X, dt, bt, dj, bj


def test_bin_boundaries_equal(trained):
    _, dt, _, dj, _ = trained
    mt, mj = dt._inner.mappers, dj._inner.mappers
    assert len(mt) == len(mj) == 6
    for a, b in zip(mt, mj):
        assert (a.num_bin, a.missing_type, a.default_bin) == \
            (b.num_bin, b.missing_type, b.default_bin)
        np.testing.assert_array_equal(a.bin_upper_bound, b.bin_upper_bound)
    np.testing.assert_array_equal(dt._inner.bins, np.asarray(dj._inner.bins))
    assert any(m.missing_type == 2 for m in mt)      # the NaN column


def test_trees_and_predictions_match_jax(trained):
    """Structure equal under the near-tie rule of tests/torch_parity.py;
    leaf values and predictions within rtol 1e-5, atol 1e-6."""
    X, _, bt, _, bj = trained
    assert len(bt.models) == len(bj.models) == ROUNDS
    assert all(m.num_leaves == 15 for m in bt.models + bj.models)
    assert_same_trees(bt.models, bj.models, X)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-5,
                               atol=1e-6)


def test_port_model_text_loads_in_jax(trained):
    X, _, bt, _, _ = trained
    text = bt.model_to_string()
    loaded = lj.Booster(model_str=text)
    # the same float64 trees walked on the host by both packages
    np.testing.assert_allclose(loaded.predict(X, raw_score=True),
                               bt.predict(X, raw_score=True), rtol=1e-12,
                               atol=0)


def _tree_blocks(text):
    start = text.index("Tree=0")
    return text[start:text.index("end of trees", start)]


def test_jax_model_text_round_trips_through_port(trained):
    X, _, _, _, bj = trained
    text = bj.model_to_string()
    port = convert.booster_from_model_string(text, device_type="cpu")
    np.testing.assert_allclose(port.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-12,
                               atol=0)
    np.testing.assert_allclose(port.predict(X), bj.predict(X), rtol=1e-12)
    again = port.model_to_string()
    assert _tree_blocks(again) == _tree_blocks(text)
    assert lj.Booster(model_str=again).num_trees() == ROUNDS


def test_dried_up_first_tree_matches_jax():
    """No split meets min_data_in_leaf: both packages stop after the first
    iteration with one constant tree carrying the init score
    (gbdt.cpp:421-437)."""
    X, y = _data()
    p = dict(PARAMS, objective="binary", max_bin=15, min_data_in_leaf=5000)
    bt = lt.train(dict(p, device_type="cpu"), lt.Dataset(X, label=y),
                  num_boost_round=3)
    bj = lj.train(dict(p, tpu_engine="fused", tpu_fused_epilogue=False),
                  lj.Dataset(X, label=y), num_boost_round=3)
    assert bt.num_trees() == bj.num_trees() == 1
    assert bt.models[0].num_leaves == bj.models[0].num_leaves == 1
    np.testing.assert_allclose(bt.models[0].leaf_value,
                               bj.models[0].leaf_value, rtol=1e-12)
    np.testing.assert_allclose(bt.train_scores().numpy(),
                               np.asarray(bj._gbdt.scores)[0], rtol=1e-6)
