"""The rest of the Booster and Dataset API in the port against the JAX
package, on the same model text.

A binary and a 3-class model are trained by the port (``device_type=
"cpu"``, 6 rounds, num_leaves=15) on 3,000 x 5 rows: a column with 5% NaN,
a column with 30% exact zeros, six category codes, two normal columns. The
model text loads in both packages, and on it:

- ``predict(pred_leaf=True)``: equal int32 arrays, on rows with NaN,
  zeros and negative, fractional and unseen categories;
- ``pred_early_stop`` (binary and multiclass): equal within rtol 1e-6, and
  the rows the port stopped (``ops.predict.predict_raw_early_stop``) are
  those the JAX package's rule stops, replayed tree by tree on its host
  walk;
- ``dump_model()``: equal dicts; ``feature_importance``: equal for split
  and gain, all iterations and the first 3; ``pred_contrib`` within
  rtol/atol 1e-9 (the SHAP rules on every routing case);
- ``refit`` on fresh rows: leaf values within rtol 1e-6;
- ``reset_training_data`` then ``refit_by_leaf_preds``: equal model text,
  leaf values within rtol 1e-6; a trained booster's trees replay their
  scores on new data;
- ``Dataset.add_features_from``: bins, names and constraints equal;
- ``multi_logloss`` and ``multi_error``: the device forms against
  ``metric/traced.py`` within rtol 1e-6, and multiclass ``train()`` with a
  valid set arms the megastep body exactly where the JAX package does.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.metric import create_metric as j_create_metric
from lightgbm_tpu.metric.traced import build_traced_metric
from lightgbm_tpu_torch.metric import create_metric as t_create_metric
from lightgbm_tpu_torch.ops.predict import predict_raw_early_stop

torch.set_num_threads(1)

ROUNDS = 6
BASE = {"num_leaves": 15, "verbose": -1, "min_data_in_leaf": 5,
        "max_bin": 31, "min_data_per_group": 5, "cat_smooth": 1.0}
CATS = [2]


def rows(n=3000, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5)
    X[rng.rand(n) < 0.05, 0] = np.nan
    X[rng.rand(n) < 0.3, 1] = 0.0
    X[:, 2] = rng.randint(0, 6, n)
    z = np.nan_to_num(X[:, 0]) + 0.8 * X[:, 1] + 0.5 * (X[:, 2] % 3) \
        - 0.5 + 0.3 * X[:, 3] + 0.3 * rng.randn(n)
    y = (z > 0).astype(np.float64)
    y3 = np.digitize(z, [-0.5, 0.5]).astype(np.float64)
    return X, y, y3


def odd_rows():
    """Rows of every routing case: NaN, exact zeros, negative, fractional
    and unseen categories."""
    X, _, _ = rows(400, seed=9)
    X[:20, 0] = np.nan
    X[20:40, 1] = 0.0
    X[40:60, 2] = np.array([-1.0, 2.5, 7.0, 99.0, np.nan] * 4)
    return X


@pytest.fixture(scope="module")
def models():
    X, y, y3 = rows()
    out = {}
    for name, label, extra in (("binary", y, {"objective": "binary"}),
                               ("multiclass", y3, {"objective": "multiclass",
                                                   "num_class": 3})):
        bst = lt.train(dict(BASE, device_type="cpu", **extra),
                       lt.Dataset(X, label=label, categorical_feature=CATS),
                       ROUNDS)
        out[name] = bst.model_to_string()
    return out


def _both(text):
    return (lt.Booster(params={"device_type": "cpu"}, model_str=text),
            lj.Booster(model_str=text))


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_pred_leaf(models, kind):
    bt, bj = _both(models[kind])
    X = odd_rows()
    got = bt.predict(X, pred_leaf=True)
    want = bj.predict(X, pred_leaf=True)
    assert got.dtype == np.int32 and got.shape == (len(X), bt.num_trees())
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(bt.predict(X, pred_leaf=True,
                                             num_iteration=2), want[:, :2 * (
                                                 3 if kind != "binary"
                                                 else 1)])


@pytest.mark.parametrize("kind,margin", [("binary", 0.3),
                                         ("multiclass", 0.1)])
def test_pred_early_stop(models, kind, margin):
    bt, bj = _both(models[kind])
    X = odd_rows()
    kw = dict(pred_early_stop=True, pred_early_stop_freq=2,
              pred_early_stop_margin=margin, raw_score=True)
    np.testing.assert_allclose(bt.predict(X, **kw), bj.predict(X, **kw),
                               rtol=1e-6, atol=1e-12)
    # the stopped rows: the JAX rule replayed on its host walk
    k = bj.num_tree_per_iteration
    raw = np.zeros((k, len(X)))
    active = np.ones(len(X), bool)
    for i, t in enumerate(bj.models):
        raw[i % k, active] += t.predict_rows(X[active])
        if (i + 1) % (2 * k) == 0:
            part = np.sort(raw, axis=0)
            m = np.abs(raw[0]) if k == 1 else part[-1] - part[-2]
            active &= ~(m > margin)
    _, act = predict_raw_early_stop(bt.models, torch.as_tensor(X), k, 2,
                                    margin)
    assert 0 < int((~active).sum()) < len(X)
    np.testing.assert_array_equal(act.numpy(), active)


def test_dump_importance_contrib(models):
    bt, bj = _both(models["multiclass"])
    assert bt.dump_model() == bj.dump_model()
    assert json.dumps(bt.dump_model(num_iteration=2)) \
        == json.dumps(bj.dump_model(num_iteration=2))
    for kind in ("split", "gain"):
        for it in (None, 3):
            np.testing.assert_array_equal(
                bt.feature_importance(kind, iteration=it),
                bj.feature_importance(kind, iteration=it))
    assert bt.feature_name() == bj.feature_name()
    assert bt.num_feature() == bj.num_feature() == 5
    X = odd_rows()
    np.testing.assert_allclose(bt.predict(X, pred_contrib=True),
                               bj.predict(X, pred_contrib=True), rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_refit(models, kind):
    bt, bj = _both(models[kind])
    X, y, y3 = rows(2000, seed=4)
    label = y if kind == "binary" else y3
    rt = bt.refit(X, label, decay_rate=0.7)
    rj = bj.refit(X, label, decay_rate=0.7)
    assert rt.num_trees() == rj.num_trees()
    for a, b in zip(rt.models, rj.models):
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-6,
                                   atol=1e-12)
    # the source booster keeps its leaf values
    assert bt.model_to_string() == models[kind]


def _same_text(a: str, b: str):
    """Equal model texts up to the end of the trees (the parameter echo
    and the JAX package's data-profile blocks differ by design), leaf
    values and tree sizes within rtol 1e-6."""
    end = "end of trees"
    la = a[:a.index(end)].split("\n")
    lb = b[:b.index(end)].split("\n")
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if x.startswith("leaf_value="):
            np.testing.assert_allclose(
                np.array(x.split("=")[1].split(), float),
                np.array(y.split("=")[1].split(), float), rtol=1e-6)
        elif not x.startswith("tree_sizes="):
            assert x == y


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_reset_training_data_refit_by_leaf_preds(models, kind):
    X, y, y3 = rows(2500, seed=6)
    label = y if kind == "binary" else y3
    texts = []
    for pkg, params in ((lt, {"device_type": "cpu"}), (lj, {})):
        bst = pkg.Booster(params=dict(params), model_str=models[kind])
        ds = pkg.Dataset(X, label=label, categorical_feature=CATS,
                         params=dict(BASE, **params))
        bst.reset_training_data(ds)
        assert bst._gbdt.num_init_iteration == ROUNDS
        bst.refit_by_leaf_preds(bst.predict(X, pred_leaf=True))
        texts.append(bst.model_to_string(num_iteration=-1))
    _same_text(*texts)


def test_reset_training_data_replays_trained_trees():
    X, y, _ = rows()
    p = dict(BASE, objective="binary", device_type="cpu")
    bst = lt.train(p, lt.Dataset(X, label=y, categorical_feature=CATS), 3)
    X2, y2, _ = rows(1500, seed=8)
    ds2 = lt.Dataset(X2, label=y2, reference=bst.train_set)
    bst.reset_training_data(ds2)
    g = bst._gbdt
    assert g.num_init_iteration == 0 and g.iter == 3
    np.testing.assert_allclose(g.scores[0].numpy(),
                               bst.predict(X2, raw_score=True), rtol=1e-5,
                               atol=1e-6)
    bst.update()
    assert bst.num_trees() == 4


def test_add_features_from():
    X, y, _ = rows(1000)
    out = []
    for pkg, extra in ((lt, {"device_type": "cpu"}), (lj, {})):
        a = pkg.Dataset(X[:, :3], label=y, params=dict(
            BASE, monotone_constraints=[1, 0, 0], **extra))
        b = pkg.Dataset(X[:, 3:], label=y, params=dict(BASE, **extra))
        a.add_features_from(b)
        out.append(a)
    t, j = out[0]._inner, out[1]._inner
    np.testing.assert_array_equal(np.asarray(t.bins), np.asarray(j.bins))
    assert t.bins_dev.shape == (1000, 5)
    assert out[0].get_feature_name() == out[1].get_feature_name()
    assert t.used_features == j.used_features
    np.testing.assert_array_equal(t.monotone_constraints,
                                  j.monotone_constraints)
    assert t.feature_infos() == j.feature_infos()
    bst = lt.train(dict(BASE, objective="binary", device_type="cpu"),
                   out[0], 2)
    assert bst.num_feature() == 5


@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_multiclass_metric_device_forms(objective):
    _, _, y3 = rows(2000)
    rng = np.random.RandomState(3)
    score = rng.randn(3, 2000).astype(np.float32)
    w = rng.rand(2000).astype(np.float32)
    for weight in (None, w):
        pj = {"objective": objective, "num_class": 3,
              "multi_error_top_k": 2}
        tds = lt.Dataset(np.zeros((2000, 1)), label=y3, weight=weight,
                         params={"device_type": "cpu"}).construct()._inner
        jds = lj.Dataset(np.zeros((2000, 1)), label=y3,
                         weight=weight).construct()._inner
        bt = lt.Booster(dict(pj, device_type="cpu"), lt.Dataset(
            np.random.randn(2000, 2), label=y3))
        bj = lj.Booster(dict(pj), lj.Dataset(np.random.randn(2000, 2),
                                             label=y3))
        for name in ("multi_logloss", "multi_error"):
            mt = t_create_metric(name, bt.config)
            mt.init(tds.metadata, 2000)
            mj = j_create_metric(name, bj.config)
            mj.init(jds.metadata, 2000)
            assert mt.has_device_form(bt.objective)
            tm = build_traced_metric(mj, bj.objective)
            want = float(tm.fn(jnp.asarray(score), tm.ops)[0])
            got = float(mt.eval_device(torch.as_tensor(score),
                                       bt.objective)[0])
            np.testing.assert_allclose(got, want, rtol=1e-6)
            np.testing.assert_allclose(
                got, mt.eval(score.astype(np.float64), bt.objective)[0],
                rtol=1e-5)


@pytest.mark.parametrize("metric", [["multi_logloss", "multi_error"],
                                    ["auc_mu"]])
def test_multiclass_valid_arms_megastep(metric):
    X, _, y3 = rows(1000)
    p = {"objective": "multiclass", "num_class": 3, "metric": metric,
         "verbose": -1, "num_leaves": 7}
    armed = []
    for pkg, extra in ((lt, {"device_type": "cpu"}),
                       (lj, {"tpu_megastep": True, "tpu_engine": "fused"})):
        ds = pkg.Dataset(X, label=y3)
        bst = pkg.Booster(dict(p, **extra), ds)
        bst.add_valid(pkg.Dataset(X[:300], label=y3[:300], reference=ds),
                      "v")
        armed.append(bst._gbdt.megastep_eval_precheck(False))
    assert armed[0] == armed[1]
    assert armed[0][0] == (metric != ["auc_mu"])
