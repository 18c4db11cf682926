"""Valid sets through the port's ``train()`` against the JAX package.

``tests/test_torch_train.py``'s 2,000 x 6 rows (one 5% NaN column) train
8 rounds at num_leaves=15 and max_bin=15, binary and L2 with row
weights, with an 800-row valid set from the same labelling function
binned against the training set,
``lightgbm_tpu_torch.train(..., device_type="cpu")`` against
``lightgbm_tpu.train(..., tpu_engine="fused", tpu_fused_epilogue=False)``: valid bins equal, the per-round
``record_evaluation`` curves within rtol 1e-5 (f32 device sums taken in
another order), trees equal (``torch_parity.assert_same_trees``), the
valid scores equal ``predict`` (rtol and atol 1e-5), ``rollback_one_iter``
restores them, and init scores on both sets give the same trees.

max_bin=15, as test_torch_train.py has it: at 255 bins a split on these
rows can fall in a gap of empty training bins, where the two packages'
f32 gains tie and may pick different thresholds; the training rows then
split alike but valid rows inside the gap do not.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from torch_parity import assert_same_trees

torch.set_num_threads(1)

ROUNDS = 8
PARAMS = {"num_leaves": 15, "max_bin": 15, "verbose": -1}
JAX_ENGINE = {"tpu_engine": "fused", "tpu_fused_epilogue": False}
METRICS = {"binary": ["binary_logloss", "auc", "binary_error"],
           "regression": ["l2", "rmse", "l1", "huber"]}


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[rng.rand(n) < 0.05, 3] = np.nan
    f = X[:, 0] + 0.5 * np.nan_to_num(X[:, 3]) + 0.3 * rng.randn(n)
    return X, f


def _data(objective):
    """Train and valid rows from one labelling function; row weights on
    the L2 case."""
    X, f = _rows(2000, 0)
    Xv, fv = _rows(800, 11)
    if objective == "binary":
        y, yv = (f > 0).astype(float), (fv > 0).astype(float)
        w = wv = None
    else:
        y, yv = f, fv
        w = np.random.RandomState(1).uniform(0.5, 2.0, len(y))
        wv = np.random.RandomState(2).uniform(0.5, 2.0, len(yv))
    return X, y, w, Xv, yv, wv


def _train(pkg, objective, extra, init=False):
    X, y, w, Xv, yv, wv = _data(objective)
    init_t = init_v = None
    if init:
        init_t = 0.3 * np.tanh(np.nan_to_num(X[:, 1]))
        init_v = 0.3 * np.tanh(np.nan_to_num(Xv[:, 1]))
    ds = pkg.Dataset(X, label=y, weight=w, init_score=init_t)
    dv = pkg.Dataset(Xv, label=yv, weight=wv, init_score=init_v,
                     reference=ds)
    ev = {}
    p = dict(PARAMS, objective=objective, metric=METRICS[objective], **extra)
    bst = pkg.train(p, ds, ROUNDS, valid_sets=[dv], valid_names=["v"],
                    callbacks=[pkg.record_evaluation(ev)])
    bst.num_trees()                 # settles the JAX package's pipeline
    return bst, ds, dv, ev


@pytest.fixture(scope="module", params=["binary", "regression"],
                ids=["binary", "regression-weighted"])
def trained(request):
    obj = request.param
    bt, dt, dvt, et = _train(lt, obj, {"device_type": "cpu"})
    bj, dj, dvj, ej = _train(lj, obj, JAX_ENGINE)
    return obj, (bt, dt, dvt, et), (bj, dj, dvj, ej)


def test_valid_bins_equal_jax(trained):
    _, (_, dt, dvt, _), (_, dj, dvj, _) = trained
    assert dvt._inner.mappers is dt._inner.mappers
    np.testing.assert_array_equal(dvt._inner.bins, np.asarray(dvj._inner.bins))


def test_eval_curves_match_jax(trained):
    obj, (bt, *_, et), (bj, *_, ej) = trained
    assert list(et) == list(ej) == ["v"]
    assert list(et["v"]) == list(ej["v"]) == METRICS[obj]
    for m in METRICS[obj]:
        assert len(et["v"][m]) == ROUNDS
        np.testing.assert_allclose(et["v"][m], ej["v"][m], rtol=1e-5,
                                   err_msg=m)
    assert set(bt.best_score["v"]) == set(METRICS[obj])


def test_trees_match_jax(trained):
    X = _data(trained[0])[0]
    bt, bj = trained[1][0], trained[2][0]
    assert bt.num_trees() == bj.num_trees() == ROUNDS
    assert_same_trees(bt.models, bj.models, X)


def test_valid_scores_equal_predict_and_jax(trained):
    Xv = _data(trained[0])[3]
    bt, bj = trained[1][0], trained[2][0]
    got = bt.valid_scores(0).numpy()
    np.testing.assert_allclose(got, bt.predict(Xv, raw_score=True),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(bj._gbdt.valid_scores[0])[0],
                               rtol=1e-5, atol=1e-5)


def test_rollback_restores_valid_scores(trained):
    obj = trained[0]
    X, y, w, Xv, yv, wv = _data(obj)
    ds = lt.Dataset(X, label=y, weight=w)
    bst = lt.Booster(dict(PARAMS, objective=obj, metric=METRICS[obj],
                          device_type="cpu"), ds)
    bst.add_valid(lt.Dataset(Xv, label=yv, weight=wv, reference=ds), "v")
    seen = []
    for _ in range(3):
        seen.append((bst.valid_scores(0).clone(), bst.eval_valid()))
        bst.update()
    for k in (2, 1):
        bst.rollback_one_iter()
        assert bst.num_trees() == k
        np.testing.assert_allclose(bst.valid_scores(0).numpy(),
                                   seen[k][0].numpy(), rtol=0, atol=1e-6)
        # not AUC: the f32 add-then-subtract can part rows tied before
        # it by an ulp, which moves AUC's tie credit
        got = [v for _, m, v, _ in bst.eval_valid() if m != "auc"]
        want = [v for _, m, v, _ in seen[k][1] if m != "auc"]
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_init_scores_give_the_same_trees(trained):
    obj = trained[0]
    X, Xv = _data(obj)[0], _data(obj)[3]
    bt, _, _, et = _train(lt, obj, {"device_type": "cpu"}, init=True)
    bj, _, _, ej = _train(lj, obj, JAX_ENGINE, init=True)
    assert not bt._gbdt._boost_from_average()       # skipped over init
    assert_same_trees(bt.models, bj.models, X)
    init_v = 0.3 * np.tanh(np.nan_to_num(Xv[:, 1]))
    np.testing.assert_allclose(bt.valid_scores(0).numpy(),
                               bt.predict(Xv, raw_score=True) + init_v,
                               rtol=1e-5, atol=1e-5)
    for m in METRICS[obj]:
        np.testing.assert_allclose(et["v"][m], ej["v"][m], rtol=1e-5)


def test_dataset_fields_subset_and_create_valid():
    """The field accessors, a row subset (the bins sliced, the mappers
    shared) and create_valid, against the JAX package's."""
    X, y, w, Xv, yv, _ = _data("regression")
    rows = np.random.RandomState(3).permutation(len(y))[:700]
    out = {}
    for pkg, extra in ((lt, {"device_type": "cpu"}), (lj, {})):
        ds = pkg.Dataset(X, label=y, weight=w, params=dict(PARAMS, **extra))
        ds.set_init_score(np.linspace(-1, 1, len(y)))
        sub = ds.subset(rows)
        dv = ds.create_valid(Xv, label=yv).construct()
        out[pkg] = (ds, sub, dv)
    (dt, st, vt), (dj, sj, vj) = out[lt], out[lj]
    assert st._inner.mappers is dt._inner.mappers
    assert vt._inner.mappers is dt._inner.mappers
    assert st.num_data() == sj.num_data() == 700
    np.testing.assert_array_equal(st._inner.bins, np.asarray(sj._inner.bins))
    np.testing.assert_array_equal(vt._inner.bins, np.asarray(vj._inner.bins))
    for field in ("label", "weight", "init_score"):
        np.testing.assert_array_equal(st.get_field(field),
                                      sj.get_field(field))
    assert dt.get_init_score().dtype == np.float64
    np.testing.assert_array_equal(st.data, X[rows])
    dt.set_field("weight", None)
    assert dt.get_weight() is None and dt.get_label() is not None
    with pytest.raises(ValueError):
        dt.set_field("position", rows)
