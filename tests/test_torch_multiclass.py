"""Multiclass (softmax and one-vs-all) through the port's ``train()``
against the JAX package.

2,000 x 6 rows (one 5% NaN column) with 3 balanced classes from the
terciles of a noisy linear score, 6 rounds at num_leaves=15 and
max_bin=15, a 600-row valid set from the same labelling, on
``lightgbm_tpu_torch.train(..., device_type="cpu")`` and
``lightgbm_tpu.train(..., tpu_engine="fused", tpu_fused_epilogue=False)``:
3 trees per iteration, equal under ``torch_parity.assert_same_trees``;
``predict`` ``[n, 3]`` within rtol 1e-5 (rows summing to 1 under the
softmax); the recorded ``multi_logloss``, ``multi_error`` and ``auc_mu``
curves within rtol 1e-6 (host float64 metrics on f32 scores that agree
to the last bits); the model text through ``convert.py``; the class-major
``k * n`` init score; ``rollback_one_iter`` removing 3 trees; and ``cv``'s
stratified folds on the class labels.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.engine import _make_n_folds as j_folds
from lightgbm_tpu_torch.convert import booster_from_model_string
from lightgbm_tpu_torch.engine import _make_n_folds as t_folds
from torch_parity import assert_same_trees

torch.set_num_threads(1)

K = 3
ROUNDS = 6
PARAMS = {"num_class": K, "num_leaves": 15, "max_bin": 15, "verbose": -1,
          "min_data_in_leaf": 5}
JAX_ENGINE = {"tpu_engine": "fused", "tpu_fused_epilogue": False}
METRICS = ["multi_logloss", "multi_error", "auc_mu"]


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[rng.rand(n) < 0.05, 3] = np.nan
    z = X[:, 0] + 0.5 * np.nan_to_num(X[:, 3]) + 0.3 * rng.randn(n)
    y = np.digitize(z, [-0.45, 0.45]).astype(np.float64)
    return X, y


def _init_score(X):
    """Class-major [k * n] init score."""
    return np.concatenate([0.2 * np.tanh(np.nan_to_num(X[:, c]))
                           for c in range(K)])


def _train(pkg, objective, extra):
    X, y = _rows(2000, 0)
    Xv, yv = _rows(600, 11)
    init = _init_score(X) if objective == "multiclassova" else None
    ds = pkg.Dataset(X, label=y, init_score=init)
    dv = pkg.Dataset(Xv, label=yv, reference=ds)
    ev = {}
    p = dict(PARAMS, objective=objective, metric=METRICS, **extra)
    bst = pkg.train(p, ds, ROUNDS, valid_sets=[dv], valid_names=["v"],
                    callbacks=[pkg.record_evaluation(ev)])
    bst.num_trees()                 # settles the JAX package's pipeline
    return bst, ev


@pytest.fixture(scope="module", params=["multiclass", "multiclassova"],
                ids=["softmax", "ova-init-score"])
def trained(request):
    obj = request.param
    bt, et = _train(lt, obj, {"device_type": "cpu"})
    bj, ej = _train(lj, obj, JAX_ENGINE)
    return obj, bt, et, bj, ej


def test_trees_match_jax(trained):
    obj, bt, _, bj, _ = trained
    X = _rows(2000, 0)[0]
    assert bt.num_model_per_iteration() == bj.num_model_per_iteration() == K
    assert bt._gbdt.scores.shape == (K, 2000)
    assert bt.num_trees() == bj.num_trees() == K * ROUNDS
    assert_same_trees(bt.models, bj.models, X)
    assert bt._gbdt._fast_path_reason() is None     # the megastep body


def test_predict_matches_jax(trained):
    obj, bt, _, bj, _ = trained
    Xv = _rows(600, 11)[0]
    got, want = bt.predict(Xv), bj.predict(Xv)
    assert got.shape == want.shape == (600, K)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    raw = bt.predict(Xv, raw_score=True)
    np.testing.assert_allclose(raw, bj.predict(Xv, raw_score=True),
                               rtol=1e-5, atol=1e-6)
    if obj == "multiclass":
        np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-12)
    # the valid scores the trainer carries are the raw predictions
    np.testing.assert_allclose(bt.valid_scores(0).numpy().T, raw,
                               rtol=1e-5, atol=1e-5)


def test_metric_curves_match_jax(trained):
    _, _, et, _, ej = trained
    for m in METRICS:
        assert len(et["v"][m]) == ROUNDS
        np.testing.assert_allclose(et["v"][m], ej["v"][m], rtol=1e-6,
                                   err_msg=m)
    assert et["v"]["multi_logloss"][-1] < et["v"]["multi_logloss"][0]


def test_model_text_through_convert(trained):
    obj, bt, _, bj, _ = trained
    Xv = _rows(600, 11)[0]
    text = bj.model_to_string()
    assert f"num_class={K}" in text and f"num_tree_per_iteration={K}" in text
    loaded = booster_from_model_string(text, device_type="cpu")
    assert loaded.num_tree_per_iteration == K
    np.testing.assert_allclose(loaded.predict(Xv), bj.predict(Xv),
                               rtol=1e-12, atol=1e-12)
    # the port's own text round-trips too
    mine = lt.Booster(params={"device_type": "cpu"},
                      model_str=bt.model_to_string())
    np.testing.assert_allclose(mine.predict(Xv), bt.predict(Xv),
                               rtol=1e-12, atol=1e-12)
    # best-iteration predict counts k trees per iteration
    np.testing.assert_allclose(
        mine.predict(Xv, num_iteration=2),
        lt.Booster(params={"device_type": "cpu"},
                   model_str=bt.model_to_string(num_iteration=2)
                   ).predict(Xv), rtol=1e-12)


def test_rollback_removes_k_trees():
    X, y = _rows(2000, 0)
    p = dict(PARAMS, objective="multiclass", device_type="cpu")
    bst = lt.Booster(p, lt.Dataset(X, label=y))
    for _ in range(3):
        bst.update()
    before = bst.train_scores().clone()
    bst.update()
    bst.rollback_one_iter()
    assert bst.num_trees() == 3 * K and bst.current_iteration() == 3
    np.testing.assert_allclose(bst.train_scores().numpy(), before.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_multiclass_labels_are_checked():
    X, y = _rows(200, 0)
    with pytest.raises(lt.LightGBMError, match="Label must be in"):
        lt.train(dict(PARAMS, objective="multiclass", num_class=2,
                      device_type="cpu"), lt.Dataset(X, label=y), 1)


def test_cv_stratified_folds_match_jax():
    X, y = _rows(2000, 0)
    dt = lt.Dataset(X, label=y, params={"device_type": "cpu"})
    dj = lj.Dataset(X, label=y)
    ft = t_folds(dt, None, 3, {}, 0, True, True)
    fj = j_folds(dj, None, 3, {}, 0, True, True)
    for (tr_t, te_t), (tr_j, te_j) in zip(ft, fj):
        np.testing.assert_array_equal(tr_t, tr_j)
        np.testing.assert_array_equal(te_t, te_j)
        # each fold holds every class in its share
        counts = np.bincount(y[te_t].astype(int), minlength=K)
        np.testing.assert_allclose(counts / len(te_t),
                                   np.bincount(y.astype(int)) / len(y),
                                   atol=0.01)
    res = lt.cv(dict(PARAMS, objective="multiclass", device_type="cpu",
                     metric="multi_logloss"), dt, 3, nfold=3,
                return_cvbooster=True)
    assert len(res["valid multi_logloss-mean"]) == 3
    per_fold = [b.eval_valid()[0][2] for b in res["cvbooster"].boosters]
    np.testing.assert_allclose(res["valid multi_logloss-mean"][-1],
                               np.mean(per_fold), rtol=1e-12)
