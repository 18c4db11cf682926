"""The port's frontier-v1 engine against the JAX package's.

1. ``grow_tree_frontier`` on the same binned matrix and gradients (4,096
   rows x 6 features, no/zero/NaN missing types): the JAX grower with its
   Pallas histogram in interpret mode, the port's on CPU tensors. Equal
   structure and row -> leaf map, leaf values at rtol 1e-5, atol 1e-6. Once
   at the default slot cap and once at slot_cap=2, which takes the extra
   level passes (``frontier.py:88``; at num_leaves=15 a cap of 8 would not).
2. The slice: port ``train({... "tpu_engine": "frontier"})`` for 3 rounds
   against the JAX package's sync driver on its frontier engine, binary,
   plain and with bagging 0.7/1 and feature_fraction 0.6. On the CPU the
   JAX package turns the frontier engine off (``gbdt.py:2023`` needs
   ``on_tpu``); the test sets ``on_tpu`` and re-runs ``_setup_engine``,
   with the grower's histogram call in interpret mode. Trees equal under
   tests/torch_parity.py's rule, training scores and predictions at rtol
   1e-5, atol 1e-6.
3. ``rollback_one_iter`` on this engine, in both packages, and the port's
   frontier model text loading in the JAX package.

One num_leaves and one Bp, so the JAX grower compiles for few static
argument sets.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu.models.frontier as jfr
import lightgbm_tpu_torch as lt
from lightgbm_tpu.models.learner import FeatureMeta as JMeta
from lightgbm_tpu.ops.pallas_histogram import build_histograms_pallas_cm
from lightgbm_tpu.ops.split import SplitParams as JParams
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.models import frontier as tfr
from lightgbm_tpu_torch.ops import fused_level as tfl
from lightgbm_tpu_torch.ops.pallas_histogram import pad_feature_layout
from lightgbm_tpu_torch.ops.split import SplitParams as TParams
from torch_parity import assert_same_trees

# small shapes: intra-op threads would only contend with the other test
# workers' processes
torch.set_num_threads(1)

LEAVES = 15
STRUCT = ("split_feature", "threshold_bin", "default_left", "left_child",
          "right_child", "leaf_count", "leaf_depth")


@pytest.fixture(scope="module", autouse=True)
def interpret_histograms():
    """The JAX grower calls its Pallas histogram without ``interpret``; run
    it in interpret mode on the CPU (the package itself is unchanged)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jfr, "build_histograms_pallas_cm",
               functools.partial(build_histograms_pallas_cm, interpret=True))
    yield
    mp.undo()


# ------------------------------------------------------------ 1. the grower
def _grower_inputs(R=4096, F=6, B=32, seed=0):
    rng = np.random.RandomState(seed)
    mt = np.array([2, 1, 0, 2, 0, 1], np.int32)
    Fp, Bp = pad_feature_layout(F, B)
    bins = np.zeros((R, Fp), np.int32)
    bins[:, :F] = rng.randint(0, B - 1, size=(R, F))
    y = ((bins[:, 0] > 12) + 0.5 * (bins[:, 1] > 20)
         + 0.1 * rng.randn(R)).astype(np.float32)
    w = (rng.rand(R) < 0.8).astype(np.float32)
    gh = np.stack([-(y - y.mean()) * w, w, w], 1).astype(np.float32)
    # a NaN-missing feature's last bin holds its NaN rows; pad features
    # carry num_bin 2 and are masked out (gbdt.py _init_frontier)
    nb = np.full(Fp, 2, np.int32)
    nb[:F] = np.where(mt == 2, B - 1, B)
    meta = {"num_bin": nb, "missing_type": np.pad(mt, (0, Fp - F)),
            "default_bin": np.zeros(Fp, np.int32),
            "monotone": np.zeros(Fp, np.int32)}
    return bins, gh, meta, np.arange(Fp) < F, Bp


@pytest.mark.parametrize("slot_cap", [64, 2])
def test_grow_tree_frontier_matches_jax(slot_cap):
    bins, gh, meta, fmask, Bp = _grower_inputs()
    jtree, jleaf = jfr.grow_tree_frontier(
        jnp.asarray(bins), jnp.asarray(bins.T.copy()), jnp.asarray(gh),
        JMeta(**{k: jnp.asarray(v) for k, v in meta.items()}),
        jnp.asarray(fmask), JParams(min_data_in_leaf=5), LEAVES, Bp,
        slot_cap=slot_cap)
    jtree = jax.device_get(jtree)
    tfl.reset_launch_counts()
    ttree, tleaf = tfr.grow_tree_frontier(
        torch.as_tensor(bins), torch.as_tensor(gh),
        convert.feature_meta_from_numpy(meta), torch.as_tensor(fmask),
        TParams(min_data_in_leaf=5), LEAVES, Bp, slot_cap=slot_cap)
    assert sum(tfl.launches.values()) == 0       # CPU: plain versions
    assert ttree.num_leaves == int(jtree.num_leaves) > 8
    for k in STRUCT:
        np.testing.assert_array_equal(getattr(ttree, k).numpy(),
                                      np.asarray(getattr(jtree, k)), k)
    np.testing.assert_allclose(ttree.leaf_value.numpy(),
                               np.asarray(jtree.leaf_value), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))
    lv = np.array(jtree.leaf_value)
    np.testing.assert_array_equal(
        tfr.leaf_value_lookup(torch.as_tensor(lv), tleaf, LEAVES).numpy(),
        np.asarray(jfr.leaf_value_lookup(jnp.asarray(lv), jleaf, LEAVES)))


def test_level_count():
    # 255 leaves at the default cap: 9 levels (plus the root pass)
    assert tfr.level_count(255, -1, 64) == 9
    assert tfr.level_count(15, -1, 64) == 5
    assert tfr.level_count(15, -1, 2) == 7          # 2 extra passes
    assert tfr.level_count(15, 3, 64) == 3


# ------------------------------------------------- 2. the slice as a whole
BASE = {"objective": "binary", "num_leaves": LEAVES, "max_bin": 31,
        "tpu_engine": "frontier", "verbose": -1}


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    X = rng.randn(3000, 6)
    X[rng.rand(3000) < 0.05, 3] = np.nan
    y = (X[:, 0] + 0.5 * np.nan_to_num(X[:, 3]) + 0.3 * rng.randn(3000)
         > 0).astype(np.float64)
    return X, y


def _jax_booster(params, X, y):
    """The JAX package's Booster on its frontier engine, off the TPU."""
    bst = lj.Booster(params=params, train_set=lj.Dataset(X, label=y))
    g = bst._gbdt
    g.on_tpu = True
    g._setup_engine(g.config)
    assert g.use_frontier and not g.use_fused
    return bst


@pytest.mark.parametrize("extra", [
    {}, {"bagging_fraction": 0.7, "bagging_freq": 1,
         "feature_fraction": 0.6}], ids=["binary", "bagging_ff"])
def test_train_matches_jax_frontier_engine(data, extra):
    X, y = data
    p = dict(BASE, **extra)
    bj = _jax_booster(p, X, y)
    for _ in range(3):
        bj.update()
    tfl.reset_launch_counts()
    bt = lt.train(dict(p, device_type="cpu"), lt.Dataset(X, label=y), 3)
    g = bt._gbdt
    assert g.use_frontier and not g._use_epilogue()
    assert not hasattr(g, "fused_bins_T")
    assert g.bins_i32.dtype == torch.int32
    assert tuple(g.bins_i32.shape) == (3000, g.frontier_Fp)
    assert sum(tfl.launches.values()) == 0
    assert bt.num_trees() == 3
    assert_same_trees(bt.models, bj.models, X)
    np.testing.assert_allclose(bt.train_scores().numpy(),
                               np.asarray(bj._gbdt.scores)[0], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)
    # a bare update() loop reaches the same body: megastep and epilogue
    # do not apply to this engine
    bu = lt.Booster(params=dict(p, device_type="cpu"),
                    train_set=lt.Dataset(X, label=y))
    for _ in range(3):
        bu.update()
    np.testing.assert_array_equal(bu.train_scores().numpy(),
                                  bt.train_scores().numpy())


# ------------------------------------------- 3. rollback, model text
def test_rollback_and_model_text(data):
    X, y = data
    bt = lt.Booster(params=dict(BASE, device_type="cpu"),
                    train_set=lt.Dataset(X, label=y))
    bj = _jax_booster(BASE, X, y)
    for i in range(3):
        if i == 2:
            s2 = bt.train_scores().clone()
        bt.update()
        bj.update()
    for bst in (bt, bj):
        bst.rollback_one_iter()
        bst.update()
    bt.rollback_one_iter()
    np.testing.assert_allclose(bt.train_scores().numpy(), s2.numpy(),
                               rtol=1e-6, atol=1e-6)
    bt.update()
    assert bt.num_trees() == bj.num_trees() == 3
    assert_same_trees(bt.models, bj.models, X)
    np.testing.assert_allclose(bt.train_scores().numpy(),
                               np.asarray(bj._gbdt.scores)[0], rtol=1e-5,
                               atol=1e-6)
    loaded = lj.Booster(model_str=bt.model_to_string())
    np.testing.assert_allclose(loaded.predict(X, raw_score=True),
                               bt.predict(X, raw_score=True), rtol=1e-12,
                               atol=0)
