"""``reset_parameter``, a custom objective and metric, and continued
training through the port's ``train()`` against the JAX package (split
from ``tests/test_torch_callbacks.py``, whose rows, parameters and
helpers it shares, so that ``--dist loadfile`` runs the two side by side).

``reset_parameter(learning_rate=...)``, a custom ``fobj`` and
``init_model`` from the JAX package's model text give the same trees; a
custom ``feval`` gives the same values.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import convert
from test_torch_callbacks import (ENGINES, PARAMS, XV, X, Y,
                                  _assert_same_run, _logloss_feval, _train)
from torch_parity import assert_same_trees

torch.set_num_threads(1)


def test_reset_parameter_matches_jax():
    runs = [_train(pkg, 5, [lambda p: p.reset_parameter(
        learning_rate=lambda i: 0.2 * 0.7 ** i)], permuted=False)
        for pkg in (lt, lj)]
    _assert_same_run(*runs)
    assert runs[0][0].models[4].shrinkage == pytest.approx(0.2 * 0.7 ** 4)


def _logistic_fobj(score, dataset):
    y = dataset.get_label()
    p = 1.0 / (1.0 + np.exp(-score))
    return p - y, p * (1.0 - p)


def test_fobj_matches_jax():
    runs = []
    for pkg in (lt, lj):
        ds = pkg.Dataset(X, label=Y)
        p = dict(PARAMS, **ENGINES[pkg], objective="none", metric="none")
        bst = pkg.train(p, ds, 5, fobj=_logistic_fobj)
        bst.num_trees()
        runs.append(bst)
        with pytest.raises(Exception, match="objective='none'"):
            pkg.Booster(dict(PARAMS, **ENGINES[pkg]),
                        pkg.Dataset(X, label=Y)).update(fobj=_logistic_fobj)
    assert runs[0].num_trees() == 5
    assert_same_trees(runs[0].models, runs[1].models, X)
    np.testing.assert_allclose(runs[0].train_scores().numpy(),
                               np.asarray(runs[1]._gbdt.scores)[0],
                               rtol=1e-5, atol=1e-6)


def test_feval_matches_jax():
    runs = [_train(pkg, 5, permuted=False, feval=_logloss_feval)
            for pkg in (lt, lj)]
    _assert_same_run(*runs)
    ev = runs[0][1]["valid"]
    assert list(ev) == ["binary_logloss", "auc", "np_logloss"]
    np.testing.assert_allclose(ev["np_logloss"], ev["binary_logloss"],
                               rtol=1e-6)


def test_init_model_from_jax_model_text():
    first = lj.train(dict(PARAMS, **ENGINES[lj]), lj.Dataset(X, label=Y), 4)
    text = first.model_to_string()
    init = {lt: convert.booster_from_model_string(text, device_type="cpu"),
            lj: first}
    runs = [_train(pkg, 4, permuted=False, init_model=init[pkg])
            for pkg in (lt, lj)]
    _assert_same_run(*runs)
    bst = runs[0][0]
    np.testing.assert_allclose(
        bst.valid_scores(0).numpy(),
        bst.predict(XV, raw_score=True)
        + first.predict(XV, raw_score=True), rtol=1e-5, atol=1e-5)
