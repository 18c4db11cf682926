"""Callbacks, early stopping, custom objectives and metrics, and continued
training through the port's ``train()`` against the JAX package.

``tests/test_torch_train.py``'s 2,000 x 6 binary rows at num_leaves=15,
max_bin=15, ``device_type="cpu"``, against ``lightgbm_tpu.train(...,
tpu_engine="fused", tpu_fused_epilogue=False)``:

- ``early_stopping`` on two valid sets, the second with its labels
  permuted by a seeded generator (its metrics stop improving within a
  few rounds): the same ``best_iteration``, tree count and recorded
  curves (rtol 1e-5), plain, with ``first_metric_only`` and with
  ``min_delta``;
- ``reset_parameter``, ``fobj``, ``feval`` and ``init_model``:
  ``tests/test_torch_callbacks_train.py`` (a file of its own, so that
  ``--dist loadfile`` runs it beside this one);
- the iteration body: built-in callbacks keep the megastep body, while
  ``feval``, ``fobj``, a user callback, ``min_delta`` or a metric with no
  device form give the body a bare ``update()`` takes, the blocker named
  as the JAX package names it.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu import callback as jcb
from lightgbm_tpu_torch import callback as tcb
from lightgbm_tpu_torch.boosting.gbdt import GBDT
from torch_parity import assert_same_trees

torch.set_num_threads(1)

PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 15,
          "verbose": -1, "metric": ["binary_logloss", "auc"]}
ENGINES = {lt: {"device_type": "cpu"},
           lj: {"tpu_engine": "fused", "tpu_fused_epilogue": False}}


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[rng.rand(n) < 0.05, 3] = np.nan
    y = (X[:, 0] + 0.5 * np.nan_to_num(X[:, 3]) + 0.3 * rng.randn(n)
         > 0).astype(np.float64)
    return X, y


X, Y = _rows(2000, 0)
XV, YV = _rows(800, 11)
YP = np.random.RandomState(5).permutation(YV)       # labels of noise


def _train(pkg, rounds, callbacks=(), extra=None, permuted=True, **kw):
    ds = pkg.Dataset(X, label=Y)
    valid = [pkg.Dataset(XV, label=YV, reference=ds)]
    if permuted:
        valid.append(pkg.Dataset(XV, label=YP, reference=ds))
    ev = {}
    cbs = [pkg.record_evaluation(ev)] + [make(pkg) for make in callbacks]
    bst = pkg.train(dict(PARAMS, **ENGINES[pkg], **(extra or {})), ds,
                    rounds, valid_sets=valid,
                    valid_names=["valid", "permuted"][:len(valid)],
                    callbacks=cbs, **kw)
    bst.num_trees()                 # settles the JAX package's pipeline
    return bst, ev


def _assert_same_run(rt, rj):
    (bt, et), (bj, ej) = rt, rj
    assert bt.best_iteration == bj.best_iteration
    assert bt.num_trees() == bj.num_trees()
    assert_same_trees(bt.models, bj.models, X)
    assert list(et) == list(ej)
    for name in ej:
        for m in ej[name]:
            np.testing.assert_allclose(et[name][m], ej[name][m], rtol=1e-5,
                                       err_msg=f"{name} {m}")


def _es_rule(curve, bigger, rounds):
    """The best iteration (1-based) early_stopping's rule finds on one
    recorded curve, or None when it never stops."""
    best, best_i = None, 0
    for i, v in enumerate(curve):
        if best is None or (v > best if bigger else v < best):
            best, best_i = v, i
        if i - best_i >= rounds:
            return best_i + 1
    return None


@pytest.mark.parametrize("es", [
    {}, {"first_metric_only": True}, {"min_delta": 0.002},
    {"min_delta": [0.001, 0.0005]}],
    ids=["plain", "first_metric_only", "min_delta", "min_delta_list"])
def test_early_stopping_matches_jax(es):
    runs = [_train(pkg, 30, [lambda p: p.early_stopping(3, verbose=False,
                                                        **es)])
            for pkg in (lt, lj)]
    _assert_same_run(*runs)
    bst, ev = runs[0]
    assert 0 < bst.best_iteration < 27
    assert bst.num_trees() == bst.best_iteration + 3
    assert bst.best_score["permuted"]
    if not es:
        stops = [_es_rule(ev[n][m], m == "auc", 3)
                 for n in ev for m in ev[n]]
        assert bst.best_iteration == min(s for s in stops if s)
    # predict and the model text keep best_iteration trees by default
    assert lt.Booster(model_str=bst.model_to_string()).num_trees() == \
        bst.best_iteration
    np.testing.assert_allclose(
        bst.predict(XV, raw_score=True),
        bst.predict(XV, raw_score=True, num_iteration=bst.best_iteration))


def test_early_stopping_round_param_matches_jax():
    runs = [_train(pkg, 30, extra={"early_stopping_round": 3})
            for pkg in (lt, lj)]
    _assert_same_run(*runs)
    assert runs[0][0].best_iteration > 0


def _logloss_feval(score, dataset):
    y = dataset.get_label()
    p = np.clip(1.0 / (1.0 + np.exp(-score)), 1e-15, 1 - 1e-15)
    return ("np_logloss", float(-np.mean(y * np.log(p)
                                         + (1 - y) * np.log(1 - p))), False)


def _bodies(monkeypatch):
    """Counts of the fused bodies the port runs."""
    n = {"megastep": 0, "epilogue": 0}
    for name, attr in (("megastep", "_fused_iter_body"),
                       ("epilogue", "_epi_iter_body")):
        orig = getattr(GBDT, attr)

        def spy(self, *a, _orig=orig, _name=name):
            n[_name] += 1
            return _orig(self, *a)
        monkeypatch.setattr(GBDT, attr, spy)
    return n


def _user_callback(env):
    pass


@pytest.mark.parametrize("case,body,blocker", [
    ("builtin", "megastep", None),
    ("none", "megastep", None),
    ("feval", "epilogue", "feval"),
    ("user_callback", "epilogue", "callback:_user_callback"),
    ("min_delta", "epilogue", "callback:early_stopping(min_delta)"),
    ("host_metric", "epilogue", "metric:average_precision"),
    ("tpu_megastep_off", "epilogue", "config:tpu_megastep=false"),
])
def test_body_choice_follows_jax_engine(monkeypatch, case, body, blocker):
    def cbs(pkg):
        out = {"builtin": [pkg.early_stopping(50, verbose=False),
                           pkg.log_evaluation(1), pkg.record_evaluation({})],
               "user_callback": [_user_callback],
               "min_delta": [pkg.early_stopping(50, min_delta=0.1)]}
        return out.get(case, [pkg.log_evaluation(1)])
    extra = {"host_metric": {"metric": ["auc", "average_precision"]},
             "tpu_megastep_off": {"tpu_megastep": False}}.get(case, {})
    if case in ("user_callback", "min_delta", "builtin", "none", "feval"):
        assert tcb.drain_replay_blocker(cbs(lt)) == \
            jcb.drain_replay_blocker(cbs(lj))
    n = _bodies(monkeypatch)
    ds = lt.Dataset(X, label=Y)
    dv = lt.Dataset(XV, label=YV, reference=ds)
    bst = lt.train(dict(PARAMS, device_type="cpu", **extra), ds, 3,
                   valid_sets=[dv],
                   callbacks=None if case == "none" else cbs(lt),
                   feval=_logloss_feval if case == "feval" else None)
    assert n[body] == 3 and sum(n.values()) == 3, n
    assert not bst._gbdt._megastep_armed     # disarmed after train()
    if case not in ("none", "user_callback", "min_delta", "feval"):
        assert bst._gbdt.megastep_eval_precheck(False)[1] == blocker


@pytest.mark.parametrize("kw,params,item", [
    ({}, {"linear_tree": True}, "not supported for sparse input")],
    ids=["linear_tree"])
def test_unported_train_arguments_raise(kw, params, item):
    """``linear_tree`` trains, but, as in the JAX package, not on sparse
    input (no raw columns)."""
    import scipy.sparse as sp
    data = sp.csr_matrix(X) if params else X
    with pytest.raises(lt.LightGBMError, match=item):
        lt.train(dict(PARAMS, device_type="cpu", **params),
                 lt.Dataset(data, label=Y), 2, **kw)


def test_resume_from_trains(tmp_path):
    """The ``resume`` case above, now ported (ROADMAP item 10c): a run
    resumed from its checkpoint at 2 rounds (a 3-round run's last; early
    stopping's final-round stop comes before the cadence point, as in the
    JAX package) trains to the uninterrupted 4-round model, its
    early-stopping and recorded states restored."""
    ck = str(tmp_path / "ck")
    p = dict(PARAMS, device_type="cpu", checkpoint_dir=ck,
             checkpoint_period=2)

    def run(rounds, **kw):
        rec = {}
        ds = lt.Dataset(X, label=Y)
        b = lt.train(p, ds, rounds, valid_sets=[lt.Dataset(
            XV, label=YV, reference=ds)], callbacks=[
            lt.early_stopping(50, verbose=False),
            lt.record_evaluation(rec)], **kw)
        return b, rec
    want, rec_want = run(4)
    import shutil
    shutil.rmtree(ck)
    run(3)
    got, rec_got = run(4, resume_from=ck)
    assert got.model_to_string() == want.model_to_string()
    assert rec_got == rec_want and got.best_iteration == want.best_iteration
