"""``lightgbm_tpu_torch.cv`` against the JAX package's ``cv``.

``tests/test_torch_train.py``'s 2,000 x 6 binary rows at num_leaves=15,
max_bin=15, 3 stratified folds, 5 rounds, ``device_type="cpu"`` against
``tpu_engine="fused", tpu_fused_epilogue=False``: the same folds, the
same result keys and per-round means and standard deviations within rtol
1e-5, each fold booster's trees equal, each mean the mean of the fold
boosters' own ``eval_valid``, and early stopping cutting the curves at
the same round.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.engine import _make_n_folds as j_folds
from lightgbm_tpu_torch.engine import _make_n_folds as t_folds
from torch_parity import assert_same_trees

torch.set_num_threads(1)

PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 15,
          "verbose": -1, "metric": ["binary_logloss", "auc"]}
ENGINES = {lt: {"device_type": "cpu"},
           lj: {"tpu_engine": "fused", "tpu_fused_epilogue": False}}


def _data():
    rng = np.random.RandomState(0)
    X = rng.randn(2000, 6)
    X[rng.rand(2000) < 0.05, 3] = np.nan
    y = (X[:, 0] + 0.5 * np.nan_to_num(X[:, 3]) + 0.3 * rng.randn(2000)
         > 0).astype(np.float64)
    return X, y


@pytest.fixture(scope="module")
def results():
    X, y = _data()
    out = {}
    for pkg in (lt, lj):
        out[pkg] = pkg.cv(dict(PARAMS, **ENGINES[pkg]),
                          pkg.Dataset(X, label=y), num_boost_round=5,
                          nfold=3, stratified=True, seed=3,
                          return_cvbooster=True)
    return out


@pytest.mark.parametrize("stratified,shuffle", [(True, True), (False, True),
                                                (True, False)])
def test_folds_match_jax(stratified, shuffle):
    X, y = _data()
    ft = t_folds(lt.Dataset(X, label=y, params={"device_type": "cpu"}),
                 None, 3, {}, 3, stratified, shuffle)
    fj = j_folds(lj.Dataset(X, label=y), None, 3, {}, 3, stratified,
                 shuffle)
    assert len(ft) == len(fj) == 3
    for (a, b), (c, d) in zip(ft, fj):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_results_match_jax(results):
    rt, rj = results[lt], results[lj]
    keys = [k for k in rj if k != "cvbooster"]
    assert sorted(k for k in rt if k != "cvbooster") == sorted(keys)
    assert set(keys) == {f"valid {m}-{s}" for m in PARAMS["metric"]
                         for s in ("mean", "stdv")}
    for k in keys:
        assert len(rt[k]) == 5
        np.testing.assert_allclose(rt[k], rj[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_fold_trees_match_jax(results):
    X, _ = _data()
    bt = results[lt]["cvbooster"].boosters
    bj = results[lj]["cvbooster"].boosters
    for a, b in zip(bt, bj):
        b.num_trees()
        assert_same_trees(a.models, b.models, X)


def test_means_are_the_folds_eval_valid(results):
    r = results[lt]
    per_fold = r["cvbooster"].eval_valid()
    for i, (_, m, _, _) in enumerate(per_fold[0]):
        vals = [fold[i][2] for fold in per_fold]
        assert r[f"valid {m}-mean"][-1] == pytest.approx(np.mean(vals),
                                                         rel=1e-12)
        assert r[f"valid {m}-stdv"][-1] == pytest.approx(np.std(vals),
                                                         rel=1e-12)


def test_cv_early_stopping_matches_jax():
    X, y = _data()
    yp = np.random.RandomState(5).permutation(y)      # nothing to learn
    out = [pkg.cv(dict(PARAMS, **ENGINES[pkg], early_stopping_round=2),
                  pkg.Dataset(X, label=yp), num_boost_round=12, nfold=3,
                  seed=3) for pkg in (lt, lj)]
    assert len(out[0]["valid auc-mean"]) == len(out[1]["valid auc-mean"])
    assert len(out[0]["valid auc-mean"]) < 12
    for k in out[1]:
        np.testing.assert_allclose(out[0][k], out[1][k], rtol=1e-5,
                                   atol=1e-7)
