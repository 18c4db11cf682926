"""The port's Booster.update fast path against the JAX package's.

1. ``epilogue_pass_plain`` (what the wrapper runs on CPU tensors) against
   ``lightgbm_tpu.ops.fused_level.epilogue_pass`` in Pallas interpret mode,
   on the same numpy operands: binary and L2, nch 5 and 3, B=16 with int8
   bins and B=256 with int16 bins, an active and an all-inactive deferred
   table, ~30% zero bag weights, padding rows at leaf -1 and leaves outside
   the leaf-value table. Tolerances: new_score at rtol 1e-6; gh_T decoded
   to f32 (hi + lo) at rtol 1e-6 (the two packages compute the same f32
   gradients from these inputs on the CPU); the histogram
   at 1e-5 of each plane's largest sum of absolute values (f32 sums taken
   in another order err by that much; the planes' own values cancel); the
   weight channel and slots 1-7 exactly.
2. The bag masks (iterations 0-7) and per-tree feature masks (trees 0-5)
   bit-equal to the JAX package's ``_bag_mask_for`` / ``_feature_mask``.
3. The slice as a whole: port ``Booster.update()`` x 6 against the JAX
   package's ``Booster.update()`` x 6 on the fused engine (its epilogue
   path on the CPU), on tests/test_epilogue.py's data (3,000 x 10, 4%
   NaN): trees equal under the near-tie rule of tests/torch_parity.py,
   leaf values, raw predictions and training scores at rtol 1e-5,
   atol 1e-6. Binary, bagging and feature_fraction here (they share one
   compiled JAX step); 63 leaves and the no-split stop, which compile
   their own, in tests/test_torch_update.py so the two files run side by
   side.
4. The port's two iteration bodies train identically on the CPU, and
   ``rollback_one_iter`` drops the epilogue carry and re-primes.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.ops import fused_level as jfl
from lightgbm_tpu_torch.objective.regression import RegressionL2Loss
from lightgbm_tpu_torch.ops import fused_level as tfl
from torch_parity import (BASE, UPDATES, assert_same_trees,
                          assert_update_matches_jax, make_data, update)

# small shapes: intra-op threads would only contend with the other test
# workers' processes
torch.set_num_threads(1)


# ------------------------------------------------------------ 1. the kernel
def _epilogue_operands(B, kind, active, seed):
    """(numpy operands, F_oh, Rp): 1,500 real rows of 2,048, 5 features
    with no, zero and NaN missing types, rows in leaves 0..5; three active
    slots on leaves 0..2 (or none); leaf-value table of 7 entries, so some
    routed rows land outside it and add nothing."""
    rng = np.random.RandomState(seed)
    R, Rp, F = 1500, 2048, 5
    nb = np.array([B, B - 3, B, 7, B], np.int32)
    mt = np.array([0, 1, 2, 0, 2], np.int32)
    db = np.array([0, 4, 0, 0, 0], np.int32)
    F_oh, Bp = jfl.feature_layout(F, B)
    assert Bp == B
    bins_T = np.zeros((max(F_oh, 8), Rp), np.int8 if B <= 128 else np.int16)
    for f in range(F):
        bins_T[f, :R] = rng.randint(0, nb[f], R)
    leaf_T = np.full((1, Rp), -1, np.int32)
    leaf_T[0, :R] = rng.randint(0, 6, R)
    feat = np.array([1, 2, 3, -1, -1, -1, -1, -1], np.int32)
    thr = np.array([5, 7, 2, 0, 0, 0, 0, 0], np.int32)
    dl = np.array([1, 0, 1, 0, 0, 0, 0, 0], bool)
    tbl = np.zeros((8, 128), np.int32)
    tbl[:, 0] = -2
    if active:
        tbl[:3, 0] = [0, 1, 2]
        tbl[:3, 1] = [6, 6, 3]
    else:
        feat[:] = -1
    lv = (rng.randn(7) * 0.1).astype(np.float32)
    score = np.zeros((1, Rp), np.float32)
    score[0, :R] = rng.randn(R)
    ops = np.zeros((8, Rp), np.float32)
    if kind == "binary":
        ops[0, :R] = np.where(rng.rand(R) < 0.4, 1.0, -1.0)
        ops[1, :R] = rng.uniform(0.5, 2.0, R)
    else:
        ops[0, :R] = rng.randn(R) * 3.0
        ops[1, :R] = rng.uniform(0.5, 2.0, R)
    bag = np.zeros((1, Rp), np.float32)
    bag[0, :R] = rng.rand(R) >= 0.3
    route = (feat, thr, dl, nb, mt, db)
    return (bins_T, leaf_T, route, tbl, lv, score, ops, bag), F_oh, Rp


def _abs_sums(bins_T, gh, F_oh, B, nch):
    """[F_oh*B, nch] float64 sums of |channel| per histogram cell: the scale
    of any f32 summation order's rounding error."""
    vals = np.abs(np.asarray(gh, np.float64)[:nch])
    out = np.zeros((F_oh * B, nch))
    for f in range(F_oh):
        for c in range(nch):
            np.add.at(out[:, c], f * B + bins_T[f].astype(np.int64), vals[c])
    return out


def _decode(gh, nch):
    """[8, R] bf16 -> (g, h, w) f32 (hi + lo when nch = 5)."""
    x = np.asarray(gh, np.float32)
    if nch == tfl.NCH_PRECISE:
        return x[0] + x[1], x[2] + x[3], x[4]
    return x[0], x[1], x[2]


@pytest.mark.parametrize("kind,nch,B,active", [
    ("binary", 5, 16, True),
    ("binary", 3, 16, False),
    ("l2", 5, 16, False),
    ("l2", 3, 16, True),
    ("binary", 5, 256, False),   # int16 bins
    ("l2", 3, 256, True),
])
def test_epilogue_pass_plain_matches_jax(kind, nch, B, active):
    (bins_T, leaf_T, route, tbl, lv, score, ops, bag), F_oh, Rp = \
        _epilogue_operands(B, kind, active, seed=B + nch)
    W_j = jfl.build_route_table(*[jnp.asarray(a) for a in route], 8, F_oh,
                                B)
    hist_j, score_j, gh_j = jfl.epilogue_pass(
        jnp.asarray(bins_T), jnp.asarray(leaf_T), W_j, jnp.asarray(tbl),
        jnp.asarray(lv), jnp.asarray(score), jnp.asarray(ops),
        jnp.asarray(bag), num_bins=B, f_oh=F_oh, nch=nch, kind=kind,
        sigmoid=1.0, tile_rows=1024, interpret=True)
    t = torch.as_tensor
    W_t = tfl.build_route_table(*[t(a) for a in route], 8, F_oh, B)
    before = dict(tfl.launches)
    hist_t, score_t, gh_t = tfl.epilogue_pass(
        t(bins_T), t(leaf_T), W_t, t(tbl), t(lv), t(score), t(ops), t(bag),
        num_bins=B, f_oh=F_oh, nch=nch, kind=kind, sigmoid=1.0)
    assert tfl.launches == before          # CPU tensors: plain version
    np.testing.assert_allclose(score_t.numpy(), np.asarray(score_j),
                               rtol=1e-6)
    if active:   # some rows moved to a leaf outside the 7-entry table
        assert (np.asarray(score_j) == score).mean() > 0.05
    for a, b in zip(_decode(gh_t.float().numpy(), nch), _decode(gh_j, nch)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-30)
    gh_np = gh_t.float().numpy()
    assert not gh_np[nch:].any()
    hj, ht = np.asarray(hist_j), hist_t.numpy()
    assert ht.shape == (F_oh * B, nch * 8)
    live = np.zeros(nch * 8, bool)
    live[::8] = True
    assert not ht[:, ~live].any() and not hj[:, ~live].any()
    scale = _abs_sums(bins_T, gh_j, F_oh, B, nch).max(0)
    for c in range(nch - 1):
        assert np.abs(ht[:, 8 * c] - hj[:, 8 * c]).max() <= 1e-5 * scale[c]
    np.testing.assert_array_equal(ht[:, 8 * (nch - 1)], hj[:, 8 * (nch - 1)])
    # rows out of the bag and padding rows add nothing: the weight plane
    # of feature 0 counts the bag
    assert ht[:B, 8 * (nch - 1)].sum() == bag.sum()


def test_epilogue_wrapper_refuses_what_the_kernel_does_not_take():
    (bins_T, leaf_T, route, tbl, lv, score, ops, bag), F_oh, Rp = \
        _epilogue_operands(16, "binary", True, seed=0)
    t = torch.as_tensor
    W = tfl.build_route_table(*[t(a) for a in route], 8, F_oh, 16)
    args = [t(bins_T), t(leaf_T), W, t(tbl), t(lv), t(score), t(ops),
            t(bag)]
    kw = dict(num_bins=16, f_oh=F_oh)
    for i, bad in ((4, t(lv).double()), (5, t(score)[:, :100]),
                   (6, t(ops)[:2]), (7, t(bag).to(torch.bfloat16))):
        with pytest.raises(ValueError):
            tfl.epilogue_pass(*(args[:i] + [bad] + args[i + 1:]), **kw)
    with pytest.raises(ValueError):
        tfl.epilogue_pass(*args, kind="huber", **kw)
    with pytest.raises(ValueError):
        tfl.epilogue_pass(*args, nch=4, **kw)


# ------------------------------------------------------------ 2. the masks
@pytest.fixture(scope="module")
def data():
    return make_data()


@pytest.mark.parametrize("params", [
    {"bagging_fraction": 0.7, "bagging_freq": 2, "feature_fraction": 0.7},
    {"pos_bagging_fraction": 0.6, "neg_bagging_fraction": 0.9,
     "bagging_freq": 1, "feature_fraction": 0.5, "bagging_seed": 11,
     "feature_fraction_seed": 5},
], ids=["bagging", "balanced"])
def test_bag_and_feature_masks_bit_equal(data, params):
    X, y, _ = data
    p = dict(BASE, **params)
    gt = lt.Booster(params=dict(p, device_type="cpu"),
                    train_set=lt.Dataset(X, label=y))._gbdt
    gj = lj.Booster(params=p, train_set=lj.Dataset(X, label=y))._gbdt
    assert gt.is_bagging and gj.is_bagging
    assert gt.balanced_bagging == gj.balanced_bagging
    for it in range(8):
        np.testing.assert_array_equal(gt._bag_mask_for(it),
                                      gj._bag_mask_for(it))
    for _ in range(6):
        np.testing.assert_array_equal(gt._feature_mask(),
                                      np.asarray(gj._feature_mask()))


# ------------------------------------------------- 3. the slice as a whole
@pytest.mark.parametrize("params", [
    {},
    {"bagging_fraction": 0.7, "bagging_freq": 2},
    # at 0.7 and 0.8 a 20-row node's gain ties exactly (f32) between two
    # features that split it differently, and the tie-break falls on the
    # last bits of each package's sums
    {"feature_fraction": 0.6},
], ids=["binary", "bagging", "feature_fraction"])
def test_update_matches_jax_epilogue_path(data, params):
    """The variants that share the JAX package's compiled step; the others
    are in tests/test_torch_update.py."""
    assert_update_matches_jax(data, params)


# --------------------------------------------- 4. bodies, rollback, guards
@pytest.mark.parametrize("params", [
    {"bagging_fraction": 0.7, "bagging_freq": 2, "feature_fraction": 0.7},
    {"objective": "regression", "num_leaves": 63},
    {"pos_bagging_fraction": 0.5, "bagging_freq": 1},
], ids=["bagging_ff", "l2_leaves63", "balanced"])
def test_port_bodies_train_identically(data, params):
    X, y, yr = data
    p = dict(BASE, device_type="cpu", **params)
    label = yr if p["objective"] == "regression" else y
    on = update(lt, X, label, p)
    off = update(lt, X, label, dict(p, tpu_fused_epilogue=False))
    assert on._gbdt._use_epilogue() and not off._gbdt._use_epilogue()
    np.testing.assert_array_equal(on.predict(X, raw_score=True),
                                  off.predict(X, raw_score=True))
    # train() arms the megastep body unless tpu_megastep=False
    tr = lt.train(dict(p, num_iterations=UPDATES),
                  lt.Dataset(X, label=label))
    assert tr._gbdt._megastep_armed and tr._gbdt._epi_carry is None
    np.testing.assert_array_equal(tr.predict(X, raw_score=True),
                                  off.predict(X, raw_score=True))


def test_rollback_drops_the_carry_and_reprimes(data):
    """As tests/test_epilogue.py's rollback case, in both packages: 4
    updates, a rollback, 2 updates; and the port's rollback subtracts
    exactly the tree it removes."""
    X, y, _ = data
    p = dict(BASE, bagging_fraction=0.7, bagging_freq=2)
    bt = update(lt, X, y, dict(p, device_type="cpu"), n=3)
    s3 = bt.train_scores().clone()
    bt.update()
    bj = update(lj, X, y, p, n=4)
    for bst in (bt, bj):
        bst.rollback_one_iter()
        assert bst._gbdt._epi_carry is None
        if bst is bt:
            np.testing.assert_allclose(bt.train_scores().numpy(),
                                       s3.numpy(), rtol=1e-6, atol=1e-6)
        for _ in range(2):
            bst.update()   # re-primes from the scores
    assert bt.num_trees() == bj.num_trees() == 5
    assert_same_trees(bt.models, bj.models, X)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)


def test_subclassed_l2_gradients_leave_the_epilogue(data):
    X, _, yr = data

    class Shifted(RegressionL2Loss):
        def get_gradients(self, score):
            g, h = super().get_gradients(score)
            return g + 0.5, h

    bst = lt.Booster(params=dict(BASE, objective="regression",
                                 device_type="cpu"),
                     train_set=lt.Dataset(X, label=yr))
    assert bst._gbdt._use_epilogue()
    obj = Shifted(bst.config)
    obj.init(bst.train_set._inner.metadata, len(yr), torch.device("cpu"))
    assert obj.epilogue_spec() is None
