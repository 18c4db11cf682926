"""Categorical features in the port against the JAX package.

Data made as tests/test_categorical.py makes it: integer category codes
(12, 3 and 30 categories, the 3-category one under
``max_cat_to_onehot=4`` so one-hot splits run too, 3% NaN in the first),
numerical columns between them, and a binary label from a scattered
subset of categories plus one numerical column. Tolerances:

- binning, bin maps, feature infos, route tables: exact;
- ``best_categorical_split_cm`` (one-hot and sorted subset) and the
  combined ``best_split_cm``: chosen features and left sets exact, gains
  and sums within rtol 1e-6, atol 1e-6 (f32 sums of the same bins in
  another order; a numerical winner's gain and sums in the combined scan
  within rtol 1e-5, see that test);
- trees through ``train()`` (megastep body) and the ``update()`` loop
  (epilogue body): split features, decision types and category bitsets
  equal, leaf values within rtol 1e-5; predictions within rtol 1e-5;
- ``predict`` on raw values with NaN, negative, fractional and unseen
  categories, the model text round trip, and a JAX-trained model loaded
  through ``convert.py``: within rtol 1e-6, atol 1e-9 (float64 routing
  both sides).

The adaptive-bins cut runs in tests/test_torch_categorical_cuts.py (its
own compiled configuration, so ``--dist loadfile`` runs it beside this
file).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import TpuDataset
from lightgbm_tpu.ops import fused_level as jfl
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.convert import (booster_from_model_string,
                                        tree_arrays_from_numpy)
from lightgbm_tpu_torch.dataset import BinnedDataset
from lightgbm_tpu_torch.ops import fused_level as tfl
from lightgbm_tpu_torch.ops import split as tsplit

torch.set_num_threads(1)

CATS = [0, 2, 4]
ROUNDS = 4
PARAMS = {"objective": "binary", "num_leaves": 15, "verbose": -1,
          "tpu_engine": "fused", "min_data_in_leaf": 5,
          "min_data_per_group": 5, "cat_smooth": 1.0, "max_bin": 31}
SPLIT_TOL = dict(rtol=1e-6, atol=1e-6)


def cat_rows(R=4000, seed=0):
    """Columns: 12-category code (3% NaN), numerical, 3-category code,
    numerical, 30-category code, numerical; the label from categories
    {1, 4, 7, 10} of the first, 1 of the second, five of the third, and
    the first numerical column."""
    rng = np.random.RandomState(seed)
    c1 = rng.randint(0, 12, R)
    c2 = rng.randint(0, 3, R)
    c3 = rng.randint(0, 30, R)
    num = rng.randn(R, 3)
    good = (np.isin(c1, [1, 4, 7, 10]) + 0.5 * (c2 == 1)
            + 0.3 * np.isin(c3, [2, 5, 11, 17, 23]))
    y = (good + 0.4 * num[:, 0] + 0.2 * rng.randn(R) > 0.7)
    X = np.column_stack([c1, num[:, 0], c2, num[:, 1], c3, num[:, 2]])
    X = X.astype(np.float64)
    X[rng.rand(R) < 0.03, 0] = np.nan
    return X, y.astype(np.float32)


def assert_same_cat_trees(port_models, jax_models, rtol=1e-5, atol=1e-6):
    assert len(port_models) == len(jax_models)
    for a, b in zip(port_models, jax_models):
        assert a.num_leaves == b.num_leaves
        for k in ("split_feature", "left_child", "right_child",
                  "decision_type", "leaf_count"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
        num = (a.decision_type & 1) == 0
        np.testing.assert_array_equal(a.threshold_bin[num],
                                      b.threshold_bin[num])
        assert a.cat_boundaries == b.cat_boundaries
        assert a.cat_threshold == b.cat_threshold
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=rtol,
                                   atol=atol)


# ------------------------------------------------------------- binning
def test_categorical_binning_matches_jax():
    X, _ = cat_rows(3000, 1)
    X[:7, 4] = -3.0                 # negative codes bin with NaN
    cfg = {"max_bin": 31, "verbose": -1}
    jd = TpuDataset.from_data(X, JConfig(cfg), categorical_feature=CATS)
    td = BinnedDataset.from_data(X, TConfig(cfg), "cpu",
                                 categorical_feature=CATS)
    np.testing.assert_array_equal(td.bins, jd.bins)
    np.testing.assert_array_equal(td.is_categorical, jd.is_categorical)
    assert td.is_categorical.tolist() == [True, False] * 3
    np.testing.assert_array_equal(td.num_bin_per_feat, jd.num_bin_per_feat)
    np.testing.assert_array_equal(td.missing_types, jd.missing_types)
    for mt, mj in zip(td.mappers, jd.mappers):
        assert mt.bin_type == mj.bin_type
        assert mt.bin_2_categorical == mj.bin_2_categorical
        assert mt.categorical_2_bin == mj.categorical_2_bin
    assert td.feature_infos() == jd.feature_infos()
    Xv, _ = cat_rows(500, 9)
    Xv[:5, 0] = 99                  # unseen categories
    np.testing.assert_array_equal(
        BinnedDataset.from_data(Xv, TConfig(cfg), "cpu", reference=td).bins,
        TpuDataset.from_data(Xv, JConfig(cfg), reference=jd).bins)


def test_categorical_feature_by_name():
    X, y = cat_rows(600, 2)
    names = [f"c{i}" for i in range(6)]
    a = lt.Dataset(X, label=y, feature_name=names, categorical_feature=[
        "c0", "c2", "c4"], params={"device_type": "cpu"}).construct()
    b = lt.Dataset(X, label=y, categorical_feature=CATS,
                   params={"device_type": "cpu"}).construct()
    np.testing.assert_array_equal(a._inner.is_categorical,
                                  b._inner.is_categorical)
    np.testing.assert_array_equal(a._inner.bins, b._inner.bins)


# --------------------------------------------------------- split search
def _cat_planes(seed, S=3, F=4, B=32):
    """[S, F, B] planes whose features have 3, 12, 26 and 30 bins."""
    rng = np.random.RandomState(seed)
    nb = np.array([3, 12, 26, 30], np.int32)[:F]
    cnt = np.zeros((S, F, B), np.float32)
    for f in range(F):
        cnt[:, f, :nb[f]] = rng.randint(0, 40, (S, nb[f]))
    hess = (cnt * (0.5 + 0.1 * rng.rand(S, F, B))).astype(np.float32)
    grad = (rng.randn(S, F, B) * cnt).astype(np.float32)
    parent = (0.1 * rng.randn(S)).astype(np.float32)
    return grad, hess, cnt, nb, parent


PARAM_CASES = {
    "default": dict(min_data_in_leaf=3, min_data_per_group=5,
                    cat_smooth=2.0, cat_l2=1.0, max_cat_to_onehot=4,
                    max_cat_threshold=16),
    "onehot-wide": dict(min_data_in_leaf=2, max_cat_to_onehot=16,
                        cat_smooth=1.0),
    "l1-smooth": dict(min_data_in_leaf=3, min_data_per_group=20,
                      cat_smooth=5.0, cat_l2=10.0, lambda_l1=0.5,
                      lambda_l2=1.0, max_cat_threshold=4,
                      path_smooth=2.0, max_delta_step=3.0),
}


def _split_both(fn, planes, kw, mask=None, **extra):
    grad, hess, cnt, nb, parent = planes
    F = grad.shape[1]
    mask = np.ones(F, bool) if mask is None else mask
    jb = getattr(jsplit, fn)(
        *(jnp.asarray(a) for a in (grad, hess, cnt, nb)), *extra.get(
            "j_args", ()), jnp.asarray(mask),
        *extra.get("j_args2", ()), jsplit.SplitParams(**kw),
        jnp.asarray(parent), **extra.get("j_kw", {}))
    tb = getattr(tsplit, fn)(
        *(torch.as_tensor(a) for a in (grad, hess, cnt, nb)),
        *extra.get("t_args", ()), torch.as_tensor(mask),
        *extra.get("t_args2", ()), tsplit.SplitParams(**kw),
        torch.as_tensor(parent), **extra.get("t_kw", {}))
    return tb, jb


def _assert_split_equal(tb, jb, rtol=SPLIT_TOL["rtol"]):
    for k in ("feature", "threshold", "default_left", "cat_flag",
              "cat_mask"):
        np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                      np.asarray(getattr(jb, k)), k)
    for k in ("gain", "left_output", "right_output", "left_sum_grad",
              "left_sum_hess", "left_count", "right_sum_grad",
              "right_sum_hess", "right_count"):
        np.testing.assert_allclose(getattr(tb, k).numpy(),
                                   np.asarray(getattr(jb, k)), err_msg=k,
                                   rtol=rtol, atol=SPLIT_TOL["atol"])


@pytest.mark.parametrize("case", list(PARAM_CASES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_best_categorical_split_matches_jax(case, seed):
    planes = _cat_planes(seed)
    kw = PARAM_CASES[case]
    tb, jb = _split_both("best_categorical_split_cm", planes, kw)
    assert bool(tb.cat_flag.any())
    _assert_split_equal(tb, jb)
    # the scan on the categorical planes only gives the same result
    mask = np.array([True, False, True, True])
    tb, jb = _split_both("best_categorical_split_cm", planes, kw, mask)
    tc, _ = _split_both("best_categorical_split_cm", planes, kw, mask,
                        t_kw={"cat_idx": torch.tensor([0, 2, 3])})
    _assert_split_equal(tb, jb)
    _assert_split_equal(tc, jb)


@pytest.mark.parametrize("seed", [3, 4])
def test_best_split_combined_matches_jax(seed):
    """Features 0 and 2 categorical, 1 and 3 numerical (missing types
    NaN and None): each slot takes the categorical winner only where its
    gain is strictly greater. A numerical winner's gain and sums come
    from cumulative sums over the bins in another order than XLA's: here
    (gains up to ~4e4 from differences of ~1e5 terms, outputs up to ~150)
    they are held to rtol 1e-5."""
    planes = _cat_planes(seed, S=6)
    grad, hess, cnt, nb, parent = planes
    F = grad.shape[1]
    is_cat = np.array([True, False, True, False])
    mt = np.array([0, 2, 0, 0], np.int32)
    db = np.zeros(F, np.int32)
    kw = PARAM_CASES["default"]
    tb, jb = _split_both(
        "best_split_cm", planes, kw,
        j_args=(jnp.asarray(mt), jnp.asarray(db)),
        j_args2=(jnp.asarray(is_cat), jnp.zeros(F, jnp.int32)),
        j_kw={"has_cat": True},
        t_args=(torch.as_tensor(mt), torch.as_tensor(db)),
        t_args2=(torch.as_tensor(is_cat),),
        t_kw={"cat_idx": torch.tensor([0, 2])})
    assert bool(tb.cat_flag.any()) and not bool(tb.cat_flag.all())
    _assert_split_equal(tb, jb, rtol=1e-5)


def test_route_table_with_categorical_slots_matches_jax():
    rng = np.random.RandomState(0)
    Sp, F, B = 8, 5, 16
    F_oh = 8
    nb = np.array([12, 16, 3, 9, 16], np.int32)
    mt = np.array([2, 0, 0, 1, 2], np.int32)
    db = np.array([0, 3, 0, 2, 0], np.int32)
    feat = np.array([0, 1, 2, -1, 3, 4, 0, 2], np.int32)
    thr = rng.randint(0, 8, Sp).astype(np.int32)
    dl = rng.rand(Sp) < 0.5
    cf = np.array([1, 0, 1, 1, 0, 0, 1, 1], bool)
    cm = rng.rand(Sp, B) < 0.4
    cm[:, 0] = False                  # bin 0 never in a left set
    args = (feat, thr, dl, nb, mt, db)
    W_j = jfl.build_route_table(*(jnp.asarray(a) for a in args), Sp, F_oh,
                                B, cat_flag=jnp.asarray(cf),
                                cat_mask=jnp.asarray(cm))
    W_t = tfl.build_route_table(*(torch.as_tensor(a) for a in args), Sp,
                                F_oh, B, cat_flag=torch.as_tensor(cf),
                                cat_mask=torch.as_tensor(cm))
    np.testing.assert_array_equal(W_t.float().numpy(),
                                  np.asarray(W_j, np.float32))
    # a categorical row is its mask on its feature's slab, holes included
    np.testing.assert_array_equal(W_t[0, :B].bool().numpy(), cm[0])
    assert not bool(W_t[3].any())     # inactive slot


# ---------------------------------------------------------------- trees
def _train(pkg, body, extra, X, y, Xv, yv):
    ds = pkg.Dataset(X, label=y, categorical_feature=CATS)
    if body == "train":
        dv = pkg.Dataset(Xv, label=yv, reference=ds)
        ev = {}
        bst = pkg.train(dict(PARAMS, metric="binary_logloss", **extra), ds,
                        ROUNDS, valid_sets=[dv], valid_names=["v"],
                        callbacks=[pkg.record_evaluation(ev)])
    else:
        bst = pkg.Booster(dict(PARAMS, **extra), ds)
        for _ in range(ROUNDS):
            bst.update()
        ev = None
    bst.num_trees()
    return bst, ev


@pytest.fixture(scope="module", params=["train", "update"])
def trained(request):
    X, y = cat_rows()
    Xv, yv = cat_rows(1000, 7)
    bt, et = _train(lt, request.param, {"device_type": "cpu"}, X, y, Xv, yv)
    bj, ej = _train(lj, request.param, {}, X, y, Xv, yv)
    return request.param, bt, et, bj, ej


def test_trees_match_jax(trained):
    body, bt, _, bj, _ = trained
    X, _ = cat_rows()
    # the epilogue body leaves its carry; the megastep body drops it
    assert (bt._gbdt._epi_carry is not None) == (body == "update")
    assert bt._gbdt.cat_idx.tolist() == [0, 2, 4]
    assert all((m.decision_type & 1).sum() > 0 for m in bt.models)
    assert_same_cat_trees(bt.models, bj.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-5,
                               atol=1e-7)


def test_train_scores_and_valid_routing(trained):
    """The trainer's f32 scores equal ``predict``'s float64 routing on the
    raw values (rtol, atol 1e-5), and the recorded valid logloss (valid
    rows routed through the device trees' cat_mask) equals the JAX
    package's."""
    body, bt, et, bj, ej = trained
    X, _ = cat_rows()
    np.testing.assert_allclose(bt.train_scores().numpy(),
                               bt.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-5)
    if body == "train":
        np.testing.assert_allclose(et["v"]["binary_logloss"],
                                   ej["v"]["binary_logloss"], rtol=1e-5)
        Xv, _ = cat_rows(1000, 7)
        np.testing.assert_allclose(bt.valid_scores(0).numpy(),
                                   bt.predict(Xv, raw_score=True),
                                   rtol=1e-5, atol=1e-5)


def test_predict_raw_categories(trained):
    """NaN, negative, fractional (truncated) and unseen categories on raw
    values, against the JAX package's predict."""
    _, bt, _, bj, _ = trained
    X, _ = cat_rows(300, 5)
    X[0:10, 0] = np.nan
    X[10:20, 0] = -1.0
    X[20:30, 0] = -0.5                # truncates to category 0
    X[30:40, 0] = 4.7                 # truncates to category 4
    X[40:50, 0] = 12.0                # unseen
    X[50:60, 4] = 1e9                 # far past every bitset
    X[60:70, 2] = np.nan
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-6,
                               atol=1e-9)


def test_model_text_round_trip(trained, tmp_path):
    _, bt, _, bj, _ = trained
    X, _ = cat_rows(500, 3)
    path = str(tmp_path / "cat.txt")
    bt.save_model(path)
    text = open(path).read()
    assert "cat_boundaries=" in text and "cat_threshold=" in text
    again = lt.Booster(params={"device_type": "cpu"}, model_file=path)
    np.testing.assert_array_equal(again.predict(X), bt.predict(X))
    for a, b in zip(again.models, bt.models):
        assert a.cat_threshold == b.cat_threshold
    # the JAX package reads the port's text, and the port the JAX one's
    np.testing.assert_allclose(lj.Booster(model_str=text).predict(X),
                               bt.predict(X), rtol=1e-6, atol=1e-9)
    loaded = booster_from_model_string(bj.model_to_string(), "cpu")
    np.testing.assert_allclose(loaded.predict(X), bj.predict(X), rtol=1e-6,
                               atol=1e-9)


def test_rollback_and_add_valid_route_categories(trained):
    """``add_valid`` replays every host tree onto new rows and
    ``rollback_one_iter`` subtracts the last, both through the bitsets
    decoded into bins."""
    body, bt, _, _, _ = trained
    Xv, yv = cat_rows(700, 13)
    dv = lt.Dataset(Xv, label=yv, reference=bt.train_set)
    bt.add_valid(dv, "late")
    i = len(bt.valid_sets) - 1
    np.testing.assert_allclose(bt.valid_scores(i).numpy(),
                               bt.predict(Xv, raw_score=True), rtol=1e-5,
                               atol=1e-5)
    before = bt.train_scores().clone()
    last = bt.models[-1]
    X, _ = cat_rows()
    bt.rollback_one_iter()
    delta = (before - bt.train_scores()).numpy()
    lt_last = lt.Booster(params={"device_type": "cpu"},
                         model_str=bt.model_to_string(num_iteration=-1))
    lt_last.models = [last]
    np.testing.assert_allclose(delta, lt_last.predict(X, raw_score=True),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bt.valid_scores(i).numpy(),
                               bt.predict(Xv, raw_score=True), rtol=1e-5,
                               atol=1e-5)


def test_device_tree_arrays_convert():
    """The JAX grower's TreeArrays with categorical nodes (cat_flag,
    cat_mask) come across through ``convert.tree_arrays_from_numpy``."""
    d = {"num_leaves": np.int32(3),
         "split_feature": np.array([0, 1], np.int32),
         "threshold_bin": np.array([0, 5], np.int32),
         "default_left": np.array([False, True]),
         "cat_flag": np.array([True, False]),
         "cat_mask": np.eye(2, 8, 3, dtype=bool),
         "left_child": np.array([-1, -2], np.int32),
         "right_child": np.array([1, -3], np.int32),
         "leaf_depth": np.array([1, 2, 2], np.int32)}
    for k in ("split_gain", "internal_value", "internal_count",
              "internal_weight"):
        d[k] = np.ones(2, np.float32)
    for k in ("leaf_value", "leaf_count", "leaf_weight"):
        d[k] = np.ones(3, np.float32)
    t = tree_arrays_from_numpy(d)
    assert t.cat_flag.tolist() == [True, False]
    np.testing.assert_array_equal(t.cat_mask.numpy(), d["cat_mask"])


def test_train_categorical_feature_argument():
    """``train(categorical_feature=...)`` sets the Dataset's, as the JAX
    package's does; the frontier engine degrades to the fused one."""
    X, y = cat_rows(1500, 4)
    ds = lt.Dataset(X, label=y)
    bst = lt.train(dict(PARAMS, device_type="cpu", tpu_engine="frontier"),
                   ds, 2, categorical_feature=CATS)
    assert ds.categorical_feature == CATS
    assert not bst._gbdt.use_frontier
    assert any((m.decision_type & 1).any() for m in bst.models)
