"""The XLA engine's leaf-wise grower through the port against the JAX
package (``lightgbm_tpu/models/learner.py:479-986``), on the CPU.

The same bins and gradients (numpy, seeded) go through both growers: equal
tree arrays, leaf values within rtol 1e-5 (f32 sums taken in another
order; split gains to 1e-6 of the root's, their cancellation's scale).
Then ``train()`` with ``tpu_engine="xla"`` (the JAX package trains
the same grower on the CPU, where its ``auto`` is ``xla``): equal trees
under ``torch_parity``'s near-tie rule, predictions within rtol 1e-5 /
atol 1e-6, with ``max_depth``, a categorical column and
``feature_fraction_bynode`` each. ``grow_policy="leafwise"`` on the fused
engine takes the XLA leaf-wise grower in both packages (it trained the
fused depth-wise engine in the port before), and ``tpu_engine="frontier"``
with ``tpu_histogram_impl="segment"`` or ``"onehot"`` resolves to it too.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.models import learner as jl
from lightgbm_tpu.ops import split as js
from lightgbm_tpu_torch.models import learner as tl
from lightgbm_tpu_torch.ops import split as ts
from torch_parity import assert_same_trees

torch.set_num_threads(1)

BASE = {"objective": "binary", "num_leaves": 15, "verbose": -1,
        "min_data_in_leaf": 5}
ROUNDS = 3


def _rows(n=2000, seed=0):
    """The grow_policy probe's draw: 2,000 x 5 binary rows on signal."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5)
    y = (X[:, 0] + 0.7 * X[:, 1] - 0.4 * X[:, 2] + 0.3 * rng.randn(n)
         > 0).astype(float)
    return X, y


def _train_both(params, X, y, rounds=ROUNDS, cats="auto"):
    bj = lj.train(dict(params), lj.Dataset(X, label=y,
                                           categorical_feature=cats), rounds)
    bj.num_trees()
    bt = lt.train(dict(params, device_type="cpu"),
                  lt.Dataset(X, label=y, categorical_feature=cats), rounds)
    return bt, bj


def _assert_same_models(bt, bj, X):
    assert_same_trees(bt.models, bj.models, X)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)


def test_grow_tree_leafwise_matches_jax():
    rng = np.random.RandomState(4)
    R, F, B, L = 3000, 6, 16, 15
    bins = rng.randint(0, B, (R, F)).astype(np.uint8)
    g = (bins[:, 0] > 7) * 1.0 - (bins[:, 1] > 9) * 0.6 \
        + 0.2 * rng.randn(R)
    gh = np.stack([g, rng.rand(R) * 0.5 + 0.5, np.ones(R)], 1) \
        .astype(np.float32)
    nb = np.full(F, B, np.int32)
    z = np.zeros(F, np.int32)
    fm = np.ones(F, bool)
    kw = dict(min_data_in_leaf=10, lambda_l2=1.0)
    tj, rlj = jl.grow_tree_leafwise(
        jnp.asarray(bins), jnp.asarray(gh),
        jl.FeatureMeta(*[jnp.asarray(a) for a in (nb, z, z, z)]),
        jnp.asarray(fm), js.SplitParams(**kw), L, B)
    tt, rlt = tl.grow_tree_leafwise(
        torch.as_tensor(bins), torch.as_tensor(gh),
        tl.FeatureMeta(*[torch.as_tensor(a) for a in (nb, z, z, z)]),
        torch.as_tensor(fm), ts.SplitParams(**kw), L, B)
    assert tt.num_leaves == int(tj.num_leaves) == L
    for k in ("split_feature", "threshold_bin", "default_left",
              "left_child", "right_child", "leaf_depth", "leaf_count"):
        np.testing.assert_array_equal(getattr(tt, k).numpy(),
                                      np.asarray(getattr(tj, k)), k)
    np.testing.assert_array_equal(rlt.numpy(), np.asarray(rlj))
    for k in ("leaf_value", "leaf_weight", "internal_value"):
        np.testing.assert_allclose(getattr(tt, k).numpy(),
                                   np.asarray(getattr(tj, k)), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    # a gain is the difference of the children's and the parent's terms:
    # its rounding follows the largest (the root's) gain
    gain = np.asarray(tj.split_gain)
    np.testing.assert_allclose(tt.split_gain.numpy(), gain, rtol=1e-5,
                               atol=1e-6 * np.abs(gain).max())


@pytest.mark.parametrize("extra", [
    {}, {"max_depth": 3}, {"feature_fraction_bynode": 0.6},
    {"categorical": True}], ids=["plain", "max_depth", "bynode",
                                 "categorical"])
def test_train_xla_leafwise_matches_jax(extra):
    X, y = _rows()
    cats = "auto"
    p = dict(BASE, tpu_engine="xla")
    if extra.get("categorical"):
        rng = np.random.RandomState(5)
        X = X.copy()
        X[:, 3] = rng.randint(0, 6, len(X))
        y = (X[:, 0] + np.isin(X[:, 3], [1, 4]) * 1.5
             + 0.3 * rng.randn(len(X)) > 0.7).astype(float)
        cats = [3]
        p.update(min_data_per_group=20, cat_smooth=1.0)
    else:
        p.update(extra)
    bt, bj = _train_both(p, X, y, cats=cats)
    g = bt._gbdt
    assert not g.use_fused and not g.use_frontier
    assert g.grow_policy == bj._gbdt.grow_policy == "leafwise"
    assert g._fast_path_reason() == "engine:xla"
    assert all(m.num_leaves > 1 for m in bt.models)
    if "max_depth" in extra:
        assert max(m.leaf_depth.max() for m in bt.models) <= 3
    if cats != "auto":
        assert any(((m.decision_type[:m.num_internal] & 1) != 0).any()
                   for m in bt.models)
    _assert_same_models(bt, bj, X)


def test_grow_policy_leafwise_on_fused_matches_jax():
    """The repaired fault: ``grow_policy="leafwise"`` with
    ``tpu_engine="fused"`` trains the XLA leaf-wise grower, as the JAX
    package resolves it (gbdt.py:2038-2106)."""
    X, y = _rows()
    p = dict(BASE, tpu_engine="fused", grow_policy="leafwise")
    bt, bj = _train_both(p, X, y)
    gt, gj = bt._gbdt, bj._gbdt
    assert (gt.use_fused, gt.grow_policy) == (gj.use_fused, gj.grow_policy) \
        == (False, "leafwise")
    assert hasattr(gt, "xla_hist_bins") and not hasattr(gt, "fused_bins_T")
    assert gt._fast_path_reason() == "engine:fused"
    _assert_same_models(bt, bj, X)


@pytest.mark.parametrize("impl", ["segment", "onehot"])
def test_frontier_with_xla_histograms_trains_leafwise(impl):
    X, y = _rows(1000, seed=2)
    p = dict(BASE, tpu_engine="frontier", tpu_histogram_impl=impl)
    bt = lt.train(dict(p, device_type="cpu"), lt.Dataset(X, label=y), 2)
    g = bt._gbdt
    assert not (g.use_fused or g.use_frontier)
    assert g.grow_policy == "leafwise"
    assert g._xla_hist_impl() == impl
    # the JAX package's resolution, with its frontier engine allowed (its
    # engine needs a TPU for Pallas; the histogram impl decides first)
    bj = lj.Booster(dict(p), lj.Dataset(X, label=y))
    gj = bj._gbdt
    gj.on_tpu = True
    gj._setup_engine(gj.config)
    assert (gj.use_fused, gj.use_frontier, gj.grow_policy) \
        == (False, False, "leafwise")
    b2 = lt.train(dict(BASE, tpu_engine="xla", device_type="cpu"),
                  lt.Dataset(X, label=y), 2)
    assert _trees_text(bt) == _trees_text(b2)


def _trees_text(bst):
    """The model text's tree blocks (the parameters that follow differ)."""
    s = bst.model_to_string()
    return s[s.index("Tree=0"):s.index("end of trees")]


def test_learner_helpers_match_jax():
    """``best_split`` (the channel-minor wrapper, with monotone bounds and
    a CEGB delta), ``gather_split_info`` (a forced split's record) and
    ``cegb_delta_matrix`` on the same random histograms: equal choices,
    values within rtol 1e-5."""
    rng = np.random.RandomState(9)
    S, F, B = 4, 6, 16
    cnt = rng.randint(0, 40, (S, F, B)).astype(np.float32)
    hist = np.stack([rng.randn(S, F, B) * cnt, cnt * 0.25, cnt], -1) \
        .astype(np.float32)
    hist[:, 1:] = hist[:, :1]          # every feature partitions the rows
    hist[:, 1:, :, 0] = np.roll(hist[:, :1, :, 0], 3, axis=2)
    nb = np.full(F, B, np.int32)
    mt = np.array([0, 1, 2, 0, 2, 1], np.int32)
    db = np.array([0, 3, 0, 0, 0, 5], np.int32)
    mono = np.array([0, 1, 0, -1, 0, 0], np.int32)
    fm = np.ones((S, F), bool)
    po = rng.randn(S).astype(np.float32) * 0.1
    lo = np.array([-np.inf, -0.5, -np.inf, -1.0], np.float32)
    hi = np.array([np.inf, 0.5, 1.0, np.inf], np.float32)
    depth = np.array([1, 2, 3, 4], np.int32)
    kw = dict(min_data_in_leaf=5, lambda_l2=1.0, cegb_tradeoff=0.5,
              cegb_penalty_split=0.01)
    jp, tp = js.SplitParams(**kw), ts.SplitParams(**kw)
    coupled = np.array([0, 3, 0, 1, 0, 2], np.float32)
    used = np.array([1, 0, 0, 0, 1, 0], bool)
    lazy = np.array([0, 0, 0.1, 0, 0, 0.2], np.float32)
    unused = rng.randint(0, 50, (S, F)).astype(np.float32)
    dj = np.asarray(jl.cegb_delta_matrix(
        jp, jnp.asarray(coupled), jnp.asarray(used),
        jnp.asarray(cnt[:, 0].sum(1)), jnp.asarray(lazy),
        jnp.asarray(unused)))
    t = torch.as_tensor
    dt = tl.cegb_delta_matrix(tp, t(coupled), t(used), t(cnt[:, 0].sum(1)),
                              t(lazy), t(unused))
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-6)
    jmeta = jl.FeatureMeta(*[jnp.asarray(a) for a in (nb, mt, db, mono)])
    tmeta = tl.FeatureMeta(*[t(a) for a in (nb, mt, db, mono)])
    bj = jl.best_split(jnp.asarray(hist), jmeta, jnp.asarray(fm), jp,
                       jnp.asarray(po), use_bounds=True,
                       bound_lo=jnp.asarray(lo), bound_hi=jnp.asarray(hi),
                       leaf_depth=jnp.asarray(depth), cegb_delta=dj)
    bt = tl.best_split(t(hist), tmeta, t(fm), tp, t(po), use_bounds=True,
                       bound_lo=t(lo), bound_hi=t(hi), leaf_depth=t(depth),
                       cegb_delta=dt)
    for k in ("feature", "threshold", "default_left"):
        np.testing.assert_array_equal(getattr(bt, k).numpy(),
                                      np.asarray(getattr(bj, k)), k)
    for k in ("gain", "left_output", "right_output", "left_count"):
        np.testing.assert_allclose(getattr(bt, k).numpy(),
                                   np.asarray(getattr(bj, k)), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for f, thr in ((1, 6), (2, 9), (5, 4)):
        gj = jl.gather_split_info(jnp.asarray(hist[0]), jnp.int32(f),
                                  jnp.int32(thr), jmeta, jp,
                                  jnp.float32(po[0]))
        gt = tl.gather_split_info(t(hist[0]), f, thr, tmeta, tp, po[0])
        for k in ("gain", "left_output", "right_output", "left_count",
                  "right_count"):
            np.testing.assert_allclose(getattr(gt, k).numpy()[0],
                                       np.asarray(getattr(gj, k)),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
