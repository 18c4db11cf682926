"""DART and random-forest boosting through the port against the JAX package.

2,000 x 6 rows from a numpy seed with 5% NaN in column 2, a 600-row valid
set; 15 leaves, max_bin 15, min_data_in_leaf 40; the JAX side on
``tpu_engine="fused", tpu_fused_epilogue=False`` (both packages train DART
and RF on their synchronous bodies). ``Booster.update()`` x 8 on both:

- DART with skip_drop 0 and drop_rate 0.3 (drops every iteration), then
  ``uniform_drop``, ``xgboost_dart_mode`` and ``max_drop=2``: each
  iteration's drop set equal in both packages; the trees equal
  (``torch_parity.assert_same_trees``, leaf values within rtol/atol 1e-5);
  training and valid scores within rtol/atol 1e-5, predictions too.
- RF (bagging 0.632 every iteration, feature_fraction 0.8), binary,
  3-class multiclass and ``regression_l1`` (leaf renewal against the base
  score): trees equal as above; ``eval_train``/``eval_valid`` (averaged
  over the iterations) within rtol 1e-6; predictions within rtol/atol
  1e-5; ``average_output`` in the model text, and the model text of each
  package predicting in the other within rtol/atol 1e-9.
- The JAX package's fatal messages (RF without bagging, RF without an
  objective) and DART's early-stopping warning under ``train()``.
- LightGBM's own DART model (``tests/fixtures/ref_model_dart.txt``)
  predicting ``ref_pred_dart.npy`` within rtol 1e-6, atol 1e-9.
- DART on ``tpu_engine="frontier"`` (the JAX side's frontier engine forced
  on, as tests/test_torch_frontier.py does): drop sets equal, trees as
  above.
- DART through ``reset_parameter(learning_rate=...)``, and RF through
  ``rollback_one_iter`` and ``reset_training_data``: drop sets and
  shrinkage rates equal, trees and scores as above.
"""
import functools

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu.models.frontier as jfr
import lightgbm_tpu_torch as lt
from lightgbm_tpu.ops.pallas_histogram import build_histograms_pallas_cm
from lightgbm_tpu_torch.boosting.gbdt import DART, RF
from lightgbm_tpu_torch.utils import log as tlog
from torch_parity import assert_same_trees

torch.set_num_threads(1)

FIX = "tests/fixtures"
BASE = {"num_leaves": 15, "max_bin": 15, "min_data_in_leaf": 40,
        "verbose": -1}
JAX_ENGINE = {"tpu_engine": "fused", "tpu_fused_epilogue": False}
ROUNDS = 8
DART_CASES = {
    "drop": {},
    "uniform": {"uniform_drop": True},
    "xgboost": {"xgboost_dart_mode": True},
    "max_drop2": {"max_drop": 2},
}
RF_BAG = {"boosting": "rf", "bagging_fraction": 0.632, "bagging_freq": 1,
          "feature_fraction": 0.8}
RF_CASES = {
    "binary": {"objective": "binary", "metric": ["binary_logloss", "auc"]},
    "multiclass": {"objective": "multiclass", "num_class": 3,
                   "metric": ["multi_logloss"]},
    "l1": {"objective": "regression_l1", "metric": ["l1", "l2"]},
}


def _data():
    rng = np.random.RandomState(11)
    X = rng.randn(2600, 6)
    X[rng.rand(2600) < 0.05, 2] = np.nan
    z = X[:, 0] + 0.6 * X[:, 1] + 0.3 * np.nan_to_num(X[:, 2]) \
        + 0.4 * rng.randn(2600)
    labels = {"binary": (z > 0).astype(np.float64),
              "multiclass": np.digitize(z, [-0.5, 0.5]).astype(np.float64),
              "regression_l1": z}
    return X[:2000], X[2000:], {k: (v[:2000], v[2000:])
                                for k, v in labels.items()}


X, XV, LABELS = _data()


def _booster(pkg, params, objective="binary"):
    y, yv = LABELS[objective]
    ds = pkg.Dataset(X, label=y)
    bst = pkg.Booster(params=params, train_set=ds)
    bst.add_valid(pkg.Dataset(XV, label=yv, reference=ds), "valid")
    return bst


def _dart_run(pkg, extra, engine):
    p = dict(BASE, objective="binary", boosting="dart", skip_drop=0.0,
             drop_rate=0.3, **extra, **engine)
    bst = _booster(pkg, p)
    drops = []
    for _ in range(ROUNDS):
        bst.update()
        drops.append(list(bst._gbdt.drop_index))
    return bst, drops


def _scores(bst):
    g = bst._gbdt
    return [np.asarray(s, np.float64) for s in [g.scores] + g.valid_scores]


@pytest.fixture(scope="module", params=list(DART_CASES))
def dart(request):
    extra = DART_CASES[request.param]
    return (_dart_run(lt, extra, {"device_type": "cpu"}),
            _dart_run(lj, extra, JAX_ENGINE))


def test_dart_drop_sets_and_trees_match_jax(dart):
    (bt, dt), (bj, dj) = dart
    assert isinstance(bt._gbdt, DART)
    assert bt._gbdt._fast_path_reason() == "boosting:dart"
    assert dt == dj
    assert sum(len(d) for d in dt) > 0
    bj.num_trees()
    assert bt.num_trees() == bj.num_trees() == ROUNDS
    assert_same_trees(bt.models, bj.models, X, atol=1e-5)
    for a, b in zip(_scores(bt), _scores(bj)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for Xp in (X, XV):
        np.testing.assert_allclose(bt.predict(Xp, raw_score=True),
                                   bj.predict(Xp, raw_score=True),
                                   rtol=1e-5, atol=1e-5)


def test_dart_tree_weights_match_jax(dart):
    (bt, _), (bj, _) = dart
    gt, gj = bt._gbdt, bj._gbdt
    np.testing.assert_allclose(gt.tree_weight, gj.tree_weight, rtol=1e-12)
    assert gt.sum_weight == pytest.approx(gj.sum_weight, rel=1e-12)
    assert gt.shrinkage_rate == gj.shrinkage_rate


def _rf_run(pkg, case, engine):
    p = dict(BASE, **RF_BAG, **RF_CASES[case], **engine,
             is_provide_training_metric=True)
    bst = _booster(pkg, p, p["objective"])
    for _ in range(ROUNDS):
        bst.update()
    return bst


@pytest.fixture(scope="module", params=list(RF_CASES))
def rf(request):
    case = request.param
    return (case, _rf_run(lt, case, {"device_type": "cpu"}),
            _rf_run(lj, case, JAX_ENGINE))


def test_rf_trees_eval_and_predict_match_jax(rf):
    case, bt, bj = rf
    assert isinstance(bt._gbdt, RF) and bt.average_output
    bj.num_trees()
    k = bt.num_model_per_iteration()
    assert bt.num_trees() == bj.num_trees() == ROUNDS * k
    assert_same_trees(bt.models, bj.models, X, atol=1e-5)
    for et, ej in ((bt.eval_train(), bj.eval_train()),
                   (bt.eval_valid(), bj.eval_valid())):
        assert [e[:2] for e in et] == [e[:2] for e in ej]
        np.testing.assert_allclose([e[2] for e in et], [e[2] for e in ej],
                                   rtol=1e-6)
    for Xp in (X, XV):
        np.testing.assert_allclose(bt.predict(Xp), bj.predict(Xp),
                                   rtol=1e-5, atol=1e-5)
    # the scores hold the sum of the trees; prediction averages
    np.testing.assert_allclose(
        np.asarray(bt.predict(X, raw_score=True)).reshape(-1, k).T,
        bt._gbdt.scores.numpy() / ROUNDS, rtol=1e-5, atol=1e-5)


def test_rf_model_text_both_ways(rf):
    case, bt, bj = rf
    text_t, text_j = bt.model_to_string(), bj.model_to_string()
    assert "\naverage_output\n" in text_t and "\naverage_output\n" in text_j
    for text, pkg, src in ((text_t, lj, bt), (text_j, lt, bj)):
        kw = {"device_type": "cpu"} if pkg is lt else {}
        other = pkg.Booster(params=kw, model_str=text)
        for raw in (True, False):
            np.testing.assert_allclose(
                other.predict(XV, raw_score=raw),
                src.predict(XV, raw_score=raw), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(
            other.predict(XV, num_iteration=3, raw_score=True),
            src.predict(XV, num_iteration=3, raw_score=True), rtol=1e-9,
            atol=1e-9)


def test_dart_model_text_both_ways(dart):
    (bt, _), (bj, _) = dart
    for text, pkg, src in ((bt.model_to_string(), lj, bt),
                           (bj.model_to_string(), lt, bj)):
        kw = {"device_type": "cpu"} if pkg is lt else {}
        other = pkg.Booster(params=kw, model_str=text)
        np.testing.assert_allclose(other.predict(XV, raw_score=True),
                                   src.predict(XV, raw_score=True),
                                   rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("params,msg", [
    ({"objective": "binary", "boosting": "rf"}, "RF mode requires bagging"),
    ({"objective": "none", "boosting": "rf", "bagging_fraction": 0.5,
      "bagging_freq": 1}, "RF mode do not support custom objective"),
], ids=["no_bagging", "custom_objective"])
def test_rf_fatal_messages_match_jax(params, msg):
    y = LABELS["binary"][0]
    with pytest.raises(lt.LightGBMError) as et:
        lt.Booster(dict(params, device_type="cpu"), lt.Dataset(X, label=y))
    with pytest.raises(Exception) as ej:
        lj.Booster(params, lj.Dataset(X, label=y))
    assert msg in str(et.value)
    assert str(et.value) == str(ej.value)


def test_dart_train_early_stopping_warns_and_runs_every_round():
    said = []
    tlog.register_logger(said.append)
    try:
        y, yv = LABELS["binary"]
        ds = lt.Dataset(X, label=y)
        bst = lt.train(dict(BASE, objective="binary", boosting="dart",
                            device_type="cpu"), ds, 4,
                       valid_sets=[lt.Dataset(XV, label=yv, reference=ds)],
                       callbacks=[lt.early_stopping(1)])
    finally:
        tlog.register_logger(None)
    assert any("Early stopping is not available in dart mode" in s
               for s in said)
    assert bst.num_trees() == 4 and bst.best_iteration == -1


def test_reference_dart_model_predicts():
    Xr = np.load(f"{FIX}/parity2_X.npy")
    want = np.load(f"{FIX}/ref_pred_dart.npy")
    bst = lt.Booster(params={"device_type": "cpu"},
                     model_file=f"{FIX}/ref_model_dart.txt")
    np.testing.assert_allclose(bst.predict(Xr), want, rtol=1e-6, atol=1e-9)


def test_dart_frontier_engine_matches_jax(monkeypatch):
    monkeypatch.setattr(jfr, "build_histograms_pallas_cm", functools.partial(
        build_histograms_pallas_cm, interpret=True))
    p = dict(BASE, objective="binary", boosting="dart", skip_drop=0.0,
             drop_rate=0.3, tpu_engine="frontier")
    bj = _booster(lj, p)
    g = bj._gbdt
    g.on_tpu = True
    g._setup_engine(g.config)
    assert g.use_frontier
    bt = _booster(lt, dict(p, device_type="cpu"))
    assert bt._gbdt.use_frontier
    for _ in range(4):
        bt.update()
        bj.update()
        assert bt._gbdt.drop_index == bj._gbdt.drop_index
    bj.num_trees()
    assert_same_trees(bt.models, bj.models, X, atol=1e-5)
    for a, b in zip(_scores(bt), _scores(bj)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_dart_reset_parameter_keeps_the_drop_shrinkage():
    """``reset_parameter(learning_rate=...)`` between updates: DART's
    per-iteration ``shrinkage_rate`` is re-derived from the new rate at
    the next drop, in both packages (drop sets, trees and scores as
    above)."""
    runs = []
    for pkg, engine in ((lt, {"device_type": "cpu"}), (lj, JAX_ENGINE)):
        bst = _booster(pkg, dict(BASE, objective="binary", boosting="dart",
                                 skip_drop=0.0, drop_rate=0.3, **engine))
        drops = []
        for i in range(5):
            if i == 2:
                bst.reset_parameter({"learning_rate": 0.05})
            bst.update()
            drops.append((list(bst._gbdt.drop_index),
                          bst._gbdt.shrinkage_rate))
        runs.append((bst, drops))
    (bt, dt), (bj, dj) = runs
    assert dt == dj
    assert dt[2][1] == 0.05 / (1 + len(dt[2][0]))
    bj.num_trees()
    assert_same_trees(bt.models, bj.models, X, atol=1e-5)
    for a, b in zip(_scores(bt), _scores(bj)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_rf_rollback_and_reset_training_data_match_jax():
    """RF after ``rollback_one_iter`` and one more update, then
    ``reset_training_data`` on the same rows and two more updates: trees,
    summed scores and averaged predictions as the JAX package's."""
    runs = []
    y = LABELS["binary"][0]
    for pkg, engine in ((lt, {"device_type": "cpu"}), (lj, JAX_ENGINE)):
        p = dict(BASE, **RF_BAG, objective="binary", **engine)
        bst = _booster(pkg, p)
        for _ in range(4):
            bst.update()
        bst.rollback_one_iter()
        bst.update()
        bst.reset_training_data(pkg.Dataset(X, label=y, params=dict(p)))
        for _ in range(2):
            bst.update()
        runs.append(bst)
    bt, bj = runs
    bj.num_trees()
    assert bt.num_trees() == bj.num_trees() == 6
    assert bt.average_output and bj.average_output
    assert_same_trees(bt.models, bj.models, X, atol=1e-5)
    np.testing.assert_allclose(bt._gbdt.scores.numpy(),
                               np.asarray(bj._gbdt.scores), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(bt.predict(XV), bj.predict(XV), rtol=1e-5,
                               atol=1e-5)
