"""Linear-tree leaves through the port against the JAX package.

2,000 x 6 rows from a numpy seed with 5% NaN in column 2, a 600-row valid
set that keeps its raw rows (``linear_tree`` in its params) and one that
does not; 15 leaves, max_bin 15, min_data_in_leaf 40, ``linear_lambda``
0.1, 6 rounds of ``train()``; the JAX side on ``tpu_engine="fused",
tpu_fused_epilogue=False`` (both take the synchronous body,
``config:linear_tree``). Regression on a piecewise-linear target, and
binary:

- trees equal (``torch_parity.assert_same_trees``, leaf values within
  rtol/atol 1e-5), the same leaf columns, coefficients and constants
  within rtol 1e-6 (atol 1e-9); training and both valid sets' scores, and
  predictions, within rtol/atol 1e-5;
- on every tree's own operands (captured from the port's run): the plain
  fit (``ops.linear.fit_linear_leaves_plain``) equals the JAX package's
  ``_fit_linear_leaves`` within rtol 1e-9 (atol 1e-12), and the device
  form (here on CPU tensors) equals the plain fit within rtol 1e-9 (atol
  1e-12), at blocks of 1, 7 and 512 rows, and repeats its own bits and
  the trainer's;
- a row with NaN in one of its leaf's columns takes the constant
  ``leaf_value``, the others ``leaf_const`` plus their linear term (rtol
  1e-12); the model text of each package predicts in the other
  within rtol/atol 1e-9; ``dump_model`` equals the JAX package's (which
  leaves the linear models out);
- ``cv`` (4,000 rows in 2 folds, each training on 2,000 rows as above,
  so the JAX programs compile once for the file): folds are row
  subsets without raw data, so every fold keeps constant leaves with a
  warning, in both packages (equal fold metrics within rtol 1e-5);
- port only: a constant column 0 in front (dropped as trivial, so inner
  and real feature indices differ; the JAX package's fit indexes with the
  wrong ones and raises IndexError there): every leaf fits on its own
  path's real columns and equals a direct numpy ridge on them within
  rtol 1e-9.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.models.tree import HostTree as JHostTree
from lightgbm_tpu_torch.boosting.gbdt import GBDT
from lightgbm_tpu_torch.ops import linear
from lightgbm_tpu_torch.ops.predict import tree_leaves
from lightgbm_tpu_torch.utils import log as tlog
from torch_parity import assert_same_trees

torch.set_num_threads(1)

BASE = {"num_leaves": 15, "max_bin": 15, "min_data_in_leaf": 40,
        "verbose": -1, "linear_tree": True, "linear_lambda": 0.1}
JAX_ENGINE = {"tpu_engine": "fused", "tpu_fused_epilogue": False}
ROUNDS = 6
LAM = 0.1


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[rng.rand(n) < 0.05, 2] = np.nan
    x2 = np.nan_to_num(X[:, 2])
    z = np.where(X[:, 0] > 0, 2.0 * X[:, 1], -X[:, 1]) + 0.8 * x2 \
        + 0.5 * X[:, 3] + 0.1 * rng.randn(n)
    return X, z


def _data():
    X, z = _rows(2600, 5)
    return (X[:2000], X[2000:], {"regression": (z[:2000], z[2000:]),
                                 "binary": ((z[:2000] > 0).astype(float),
                                            (z[2000:] > 0).astype(float))})


X, XV, LABELS = _data()


def _train(pkg, objective, params):
    y, yv = LABELS[objective]
    p = dict(BASE, objective=objective, **params)
    ds = pkg.Dataset(X, label=y)
    vraw = pkg.Dataset(XV, label=yv, reference=ds, params=dict(p))
    vbin = pkg.Dataset(XV, label=yv, reference=ds)
    return pkg.train(p, ds, ROUNDS, valid_sets=[vraw, vbin],
                     valid_names=["raw", "binned"])


@pytest.fixture(scope="module", params=["regression", "binary"])
def runs(request):
    objective = request.param
    calls = []
    orig = GBDT._fit_linear_leaves

    def capture(self, ht, row_leaf, grad, hess):
        before = (ht.num_leaves, ht.split_feature.copy(),
                  ht.left_child.copy(), ht.right_child.copy(),
                  ht.leaf_value.copy())
        orig(self, ht, row_leaf, grad, hess)
        calls.append((before, row_leaf.numpy().copy(), grad.numpy().copy(),
                      hess.numpy().copy(), self.bag_weight.numpy() > 0,
                      [list(f) for f in ht.leaf_features],
                      [list(c) for c in ht.leaf_coeff],
                      np.array(ht.leaf_const)))
    GBDT._fit_linear_leaves = capture
    try:
        bt = _train(lt, objective, {"device_type": "cpu"})
    finally:
        GBDT._fit_linear_leaves = orig
    bj = _train(lj, objective, JAX_ENGINE)
    bj.num_trees()
    return objective, bt, bj, calls


def test_linear_trees_match_jax(runs):
    objective, bt, bj, _ = runs
    assert bt._gbdt._fast_path_reason() == "config:linear_tree"
    assert bt.num_trees() == bj.num_trees() == ROUNDS
    assert_same_trees(bt.models, bj.models, X, atol=1e-5)
    fitted = 0
    for a, b in zip(bt.models, bj.models):
        assert a.is_linear and b.is_linear
        assert a.leaf_features == b.leaf_features
        fitted += sum(1 for f in a.leaf_features if f)
        np.testing.assert_allclose(a.leaf_const, b.leaf_const, rtol=1e-6,
                                   atol=1e-9)
        for ca, cb in zip(a.leaf_coeff, b.leaf_coeff):
            np.testing.assert_allclose(ca, cb, rtol=1e-6, atol=1e-9)
    assert fitted > 20
    g_t, g_j = bt._gbdt, bj._gbdt
    for a, b in zip([g_t.scores] + g_t.valid_scores,
                    [g_j.scores] + g_j.valid_scores):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    for Xp in (X, XV):
        np.testing.assert_allclose(bt.predict(Xp, raw_score=True),
                                   bj.predict(Xp, raw_score=True),
                                   rtol=1e-5, atol=1e-5)
    # the valid set with raw rows takes the linear outputs, the binned one
    # the constant leaves
    raw_pred = bt.predict(XV, raw_score=True)
    np.testing.assert_allclose(g_t.valid_scores[0][0].numpy(), raw_pred,
                               rtol=1e-5, atol=1e-5)
    assert not np.allclose(g_t.valid_scores[1][0].numpy(), raw_pred,
                           rtol=1e-3, atol=1e-3)


def test_fit_forms_match_jax_on_the_port_operands(runs):
    objective, bt, bj, calls = runs
    gj = bj._gbdt
    assert len(calls) == ROUNDS
    saved_bag = gj.bag_weight
    try:
        for (nl, sf, lc, rc, lv), rl, g, h, bag, feats, coef, const \
                in calls[1:]:
            jt = JHostTree(nl)
            jt.split_feature, jt.left_child, jt.right_child = sf, lc, rc
            jt.leaf_value = lv
            gj.bag_weight = bag.astype(np.float32)
            gj._fit_linear_leaves(jt, rl, g, h)
            # the paths the JAX fit took are the plain fit's input
            plain = linear.fit_linear_leaves_plain(
                X.astype(np.float32), rl, g, h, bag,
                [list(f) for f in jt.branch_features()], LAM)
            dev = linear.fit_linear_leaves(
                torch.as_tensor(X.astype(np.float32)), torch.as_tensor(rl),
                torch.as_tensor(g), torch.as_tensor(h), torch.as_tensor(bag),
                [list(f) for f in jt.branch_features()], LAM)
            for leaf in range(nl):
                want = plain[leaf]
                if want is None:
                    assert jt.leaf_features[leaf] == [] and dev[leaf] is None
                    continue
                assert jt.leaf_features[leaf] == want[0] == dev[leaf][0] \
                    == feats[leaf]
                np.testing.assert_allclose(
                    want[1] + [want[2]],
                    jt.leaf_coeff[leaf] + [jt.leaf_const[leaf]],
                    rtol=1e-9, atol=1e-12)
                np.testing.assert_allclose(
                    dev[leaf][1] + [dev[leaf][2]], want[1] + [want[2]],
                    rtol=1e-9, atol=1e-12)
                np.testing.assert_allclose(coef[leaf] + [const[leaf]],
                                           want[1] + [want[2]], rtol=1e-9,
                                           atol=1e-12)
    finally:
        gj.bag_weight = saved_bag


@pytest.mark.parametrize("block", [1, 7, 512])
def test_device_fit_is_fixed_order(runs, block, monkeypatch):
    """The device form sums each leaf in blocks of ``_BLOCK`` rows in a
    fixed order: at any block size it equals the plain fit, a second call
    gives the same bits, and at the default size it gives the trainer's
    own fits to the bit."""
    _, _, _, calls = runs
    monkeypatch.setattr(linear, "_BLOCK", block)
    for (nl, sf, lc, rc, lv), rl, g, h, bag, feats, coef, const \
            in calls[1:]:
        paths = [list(f) for f in feats]
        ops = (torch.as_tensor(X.astype(np.float32)), torch.as_tensor(rl),
               torch.as_tensor(g), torch.as_tensor(h), torch.as_tensor(bag))
        fits = [linear.fit_linear_leaves(*ops, paths, LAM)
                for _ in range(2)]
        assert fits[0] == fits[1]
        plain = linear.fit_linear_leaves_plain(
            X.astype(np.float32), rl, g, h, bag, paths, LAM)
        for leaf in range(nl):
            got, want = fits[0][leaf], plain[leaf]
            if want is None:
                assert got is None
                continue
            np.testing.assert_allclose(got[1] + [got[2]],
                                       want[1] + [want[2]], rtol=1e-9,
                                       atol=1e-12)
            if block == 512:
                assert got[1] == coef[leaf] and got[2] == const[leaf]


def test_nan_rows_take_the_constant(runs):
    _, bt, _, _ = runs
    Xt = torch.as_tensor(X)
    n_nan = 0
    for t in bt.models[1:]:
        leaves = tree_leaves(t, Xt)
        out = linear.linear_leaf_outputs(t, Xt, leaves).numpy()
        lv = leaves.numpy()
        for leaf, feats in enumerate(t.leaf_features):
            rows = lv == leaf
            if not feats or not rows.any():
                continue
            nan = rows & np.isnan(X[:, feats]).any(1)
            ok = rows & ~nan
            n_nan += int(nan.sum())
            np.testing.assert_array_equal(out[nan], t.leaf_value[leaf])
            np.testing.assert_allclose(
                out[ok], t.leaf_const[leaf]
                + X[np.ix_(ok, feats)] @ np.asarray(t.leaf_coeff[leaf]),
                rtol=1e-12, atol=1e-12)
    assert n_nan > 0


def test_model_text_both_ways_and_dump(runs):
    _, bt, bj, _ = runs
    assert "is_linear=1" in bt.model_to_string()
    for text, pkg, src in ((bt.model_to_string(), lj, bt),
                           (bj.model_to_string(), lt, bj)):
        kw = {"device_type": "cpu"} if pkg is lt else {}
        other = pkg.Booster(params=kw, model_str=text)
        np.testing.assert_allclose(other.predict(XV, raw_score=True),
                                   src.predict(XV, raw_score=True),
                                   rtol=1e-9, atol=1e-9)
    text = bj.model_to_string()
    assert lt.Booster(params={"device_type": "cpu"},
                      model_str=text).dump_model() \
        == lj.Booster(model_str=text).dump_model()


def test_cv_folds_keep_constant_leaves():
    # 4,000 rows: each fold trains on 2,000, the shape the JAX package
    # already compiled for
    Xcv, y = _rows(4000, 6)
    said = []
    tlog.register_logger(said.append)
    try:
        rt = lt.cv(dict(BASE, objective="regression", device_type="cpu"),
                   lt.Dataset(Xcv, label=y, params=dict(BASE)), 3, nfold=2,
                   return_cvbooster=True)
    finally:
        tlog.register_logger(None)
    rj = lj.cv(dict(BASE, objective="regression", **JAX_ENGINE),
               lj.Dataset(Xcv, label=y, params=dict(BASE)), 3, nfold=2)
    assert any("linear_tree needs retained raw data" in s for s in said)
    for b in rt["cvbooster"].boosters:
        assert b.train_set._inner.raw_data is None
        assert not any(m.is_linear for m in b.models)
    keys = [k for k in rj if k != "cvbooster"]
    assert sorted(keys) == sorted(k for k in rt if k != "cvbooster")
    for k in keys:
        np.testing.assert_allclose(rt[k], rj[k], rtol=1e-5)


def test_constant_column_fits_the_path_columns():
    rng = np.random.RandomState(2)
    Xc = np.concatenate([np.full((3000, 1), 3.0), rng.randn(3000, 4)], 1)
    y = np.where(Xc[:, 1] > 0, Xc[:, 2], -2.0 * Xc[:, 3]) \
        + 0.1 * rng.randn(3000)
    calls = []
    orig = linear.fit_linear_leaves

    def capture(raw, row_leaf, grad, hess, in_bag, paths, lam):
        calls.append((row_leaf.numpy().copy(), grad.numpy().copy(),
                      hess.numpy().copy(), in_bag.numpy().copy(), paths))
        return orig(raw, row_leaf, grad, hess, in_bag, paths, lam)
    import lightgbm_tpu_torch.boosting.gbdt as gbdt_mod
    gbdt_mod.fit_linear_leaves = capture
    try:
        bst = lt.train(dict(BASE, objective="regression", device_type="cpu"),
                       lt.Dataset(Xc, label=y), 3)
    finally:
        gbdt_mod.fit_linear_leaves = orig
    assert bst._gbdt.train_data.used_features == [1, 2, 3, 4]
    Xc32 = Xc.astype(np.float32).astype(np.float64)
    assert len(calls) == 2
    for t, (rl, g, h, bag, paths) in zip(bst.models[1:], calls):
        want_paths = [sorted(set(p)) for p in t.branch_features()]
        assert paths == want_paths
        assert all(0 not in p for p in paths)
        for leaf, feats in enumerate(t.leaf_features):
            if not feats:
                continue
            assert feats == paths[leaf]
            rows = np.nonzero((rl == leaf) & bag)[0]
            # the raw columns as the dataset keeps them (float32)
            A = np.concatenate([Xc32[np.ix_(rows, feats)],
                                np.ones((len(rows), 1))], 1)
            M = (A * h[rows, None]).T @ A + LAM * np.eye(len(feats) + 1)
            coef = -np.linalg.solve(M, A.T @ g[rows])
            shrink = bst._gbdt.shrinkage_rate
            np.testing.assert_allclose(
                t.leaf_coeff[leaf] + [t.leaf_const[leaf]],
                list(coef * shrink), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(bst.predict(Xc, raw_score=True),
                               bst.train_scores().numpy(), rtol=1e-5,
                               atol=1e-5)
