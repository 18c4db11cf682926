"""The port's metrics against the JAX package's, metric by metric.

Each ported metric evaluates the same seeded label, weight and raw scores
(1,000 rows) in both packages, under the objective whose output it
converts through: the host form (float64 numpy) within 1e-12, the device
form (f32 torch against f32 jnp, ``eval_device``) within rtol 1e-6, and
where the JAX package has no device form the port has none either. AUC
is also held on scores with many ties. Multiclass and ranking metrics
raise, naming their ROADMAP item.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import Metadata as JMetadata
from lightgbm_tpu.metric import create_metric as j_create_metric
from lightgbm_tpu.objective import create_objective as j_create_objective
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.metric import (METRIC_ALIASES,
                                       create_metric as t_create_metric,
                                       default_metric_for_objective)
from lightgbm_tpu_torch.objective import create_objective as t_create_objective

torch.set_num_threads(1)

N = 1000
REGRESSION = ["l2", "rmse", "l1", "quantile", "huber", "fair", "poisson",
              "mape", "gamma", "gamma_deviance", "tweedie"]
BINARY = ["binary_logloss", "binary_error", "auc", "average_precision"]
XENTROPY = ["cross_entropy", "cross_entropy_lambda", "kullback_leibler"]


def _inputs(name, weighted, ties=False):
    """(objective params, label, weight, score [1, N]) from a seed."""
    rng = np.random.RandomState(len(name) + 7 * weighted + 3 * ties)
    w = rng.uniform(0.5, 2.0, N) if weighted else None
    score = rng.randn(1, N)
    if ties:
        score = np.round(score * 2.0) / 2.0      # ~12 distinct values
    if name in REGRESSION:
        label = rng.uniform(0.1, 3.0, N)     # positive: poisson/gamma/...
        if name in ("poisson", "gamma", "gamma_deviance", "tweedie"):
            score = np.exp(0.3 * score)
        return {"objective": "regression"}, label, w, score
    if name in XENTROPY:
        return {"objective": "none"}, rng.uniform(0, 1, N), w, score
    label = (score[0] + rng.randn(N) > 0).astype(np.float64)
    return {"objective": "binary"}, label, w, score


def _pair(name, params, label, w):
    """The JAX and the port metric (and objective) bound to one metadata."""
    jcfg, tcfg = JConfig(dict(params)), TConfig(dict(params))
    jmd, tmd = JMetadata(N), TMetadata(N)
    for md in (jmd, tmd):
        md.set_label(label)
        md.set_weight(w)
    jobj, tobj = j_create_objective(jcfg), t_create_objective(tcfg)
    if jobj is not None:
        jobj.init(jmd, N)
        tobj.init(tmd, N)
    jm, tm = j_create_metric(name, jcfg), t_create_metric(name, tcfg)
    jm.init(jmd, N)
    tm.init(tmd, N)
    return jm, jobj, tm, tobj


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("name", REGRESSION + BINARY + XENTROPY)
def test_metric_matches_jax(name, weighted):
    import jax.numpy as jnp
    params, label, w, score = _inputs(name, weighted)
    jm, jobj, tm, tobj = _pair(name, params, label, w)
    assert tm.names == jm.names
    assert tm.is_bigger_better == jm.is_bigger_better
    np.testing.assert_allclose(tm.eval(score.copy(), tobj),
                               jm.eval(score.copy(), jobj), rtol=1e-12,
                               atol=1e-12)
    s32 = score.astype(np.float32)
    want = jm.eval_device(jnp.asarray(s32), jobj, {})
    got = tm.eval_device(torch.as_tensor(s32), tobj, {})
    assert (got is None) == (want is None)
    assert tm.has_device_form(tobj) == (want is not None)
    if want is not None:
        got = [float(v) for v in got]
        np.testing.assert_allclose(got, [float(v) for v in want],
                                   rtol=1e-6)
        # and the f32 device form against the float64 host form
        np.testing.assert_allclose(got, tm.eval(score, tobj), rtol=1e-5)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_auc_with_tied_scores_matches_jax(weighted):
    import jax.numpy as jnp
    params, label, w, score = _inputs("auc", weighted, ties=True)
    assert len(np.unique(score)) < 20
    jm, jobj, tm, tobj = _pair("auc", params, label, w)
    np.testing.assert_allclose(tm.eval(score, tobj), jm.eval(score, jobj),
                               rtol=1e-12, atol=1e-12)
    s32 = score.astype(np.float32)
    got = float(tm.eval_device(torch.as_tensor(s32), tobj)[0])
    np.testing.assert_allclose(
        got, float(jm.eval_device(jnp.asarray(s32), jobj)[0]), rtol=1e-6)
    np.testing.assert_allclose(got, tm.eval(score, tobj)[0], rtol=1e-6)


def test_one_class_auc_is_one_on_both_forms():
    params, label, w, score = _inputs("auc", False)
    _, _, tm, tobj = _pair("auc", params, np.ones(N), w)
    assert tm.eval(score, tobj) == [1.0]
    assert float(tm.eval_device(torch.as_tensor(score.astype(np.float32)),
                                tobj)[0]) == 1.0


def test_aliases_and_defaults_match_jax():
    from lightgbm_tpu.metric import METRIC_ALIASES as J_ALIASES
    from lightgbm_tpu.metric import \
        default_metric_for_objective as j_default
    assert METRIC_ALIASES == J_ALIASES
    for obj in ("regression", "binary", "huber", "multiclass", "lambdarank",
                "cross_entropy", "none"):
        assert default_metric_for_objective(obj) == j_default(obj)
    cfg = TConfig({})
    for alias in ("mse", "l2_root", "mae", "binary", "xentropy", "kldiv"):
        assert t_create_metric(alias, cfg).names == \
            j_create_metric(alias, JConfig({})).names
    assert t_create_metric("none", cfg) is None


@pytest.mark.parametrize("name", ["ndcg", "map", "ndcg@3", "lambdarank",
                                  "rank_xendcg", "mean_average_precision",
                                  "xendcg"])
def test_ranking_metric_names_match_jax(name):
    """The ranking metrics and their aliases resolve as the JAX package's
    do (``ndcg@3`` sets eval_at inline)."""
    cfg = {"eval_at": [1, 5]}
    m = t_create_metric(name, TConfig(cfg))
    j = j_create_metric(name, JConfig(cfg))
    assert type(m).__name__ == type(j).__name__
    assert m.names == j.names and m.is_bigger_better


@pytest.mark.parametrize("name", ["multi_logloss", "multi_error", "auc_mu",
                                  "softmax"])
def test_multiclass_metrics_are_host_only(name):
    # auc_mu is; multi_logloss (alias softmax) and multi_error have the
    # device forms of the JAX package's metric/traced.py
    cfg = {"num_class": 3}
    m = t_create_metric(name, TConfig(cfg))
    assert m.names == j_create_metric(name, JConfig(cfg)).names
    assert m.has_device_form(None) == (name != "auc_mu")
