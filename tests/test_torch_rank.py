"""Ranking (``lambdarank``, ``rank_xendcg``, the ``ndcg`` and ``map``
metrics, query groups) in the port against the JAX package.

Inputs come from numpy seeds, plus the committed 3,000-row ranking
fixture (``tests/fixtures/parity2_X.npy`` with ``_grp.npy`` and
``_rel.npy``: 60 queries of 50 documents). Tolerances:

- ``utils/dcg`` helpers: exact (the same numpy code);
- gradients and hessians per query: rtol 1e-6, atol 2.5e-7 (f32 sums of
  the same pairs in another order, and the last bits of ``exp``);
- the Gumbel draws of ``rank_xendcg``: exact, against ``jax.random``;
- ``ndcg@k``/``map@k``: host float64 forms at 1e-12; the ``ndcg`` device
  form (f32) at 1e-6 of the float64 one;
- trees: equal under ``torch_parity.assert_same_trees``, predictions
  within rtol 1e-5. On the fixture, whose labels are 99.5% one grade, most
  candidate gains of the first trees are f32 noise near 0 that the two
  packages round differently, so its parity runs at
  ``min_gain_to_split=1e-5`` (splits on signal); the seeded queries
  (graded 0-4 from a noisy score) grow full trees at the default 0.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import Metadata as JMetadata
from lightgbm_tpu.engine import _make_n_folds as j_folds
from lightgbm_tpu.metric import create_metric as j_create_metric
from lightgbm_tpu.objective import create_objective as j_create_objective
from lightgbm_tpu.utils import dcg as jdcg
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.engine import _make_n_folds as t_folds
from lightgbm_tpu_torch.metric import create_metric as t_create_metric
from lightgbm_tpu_torch.objective import create_objective as t_create_obj
from lightgbm_tpu_torch.utils import dcg as tdcg
from lightgbm_tpu_torch.utils import random as trandom
from torch_parity import assert_same_trees

torch.set_num_threads(1)

FIX = "tests/fixtures"
GRAD_TOL = dict(rtol=1e-6, atol=2.5e-7)
OBJECTIVES = ["lambdarank", "rank_xendcg"]
PARAMS = {"num_leaves": 15, "max_bin": 15, "verbose": -1,
          "min_data_in_leaf": 5, "tpu_engine": "fused"}


def _queries(seed, Q=60, F=6):
    """Q queries of 10-89 documents; grades 0-4 from the quantiles of a
    noisy linear score (half the documents grade 0)."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(10, 90, Q)
    X = rng.randn(int(sizes.sum()), F)
    z = X[:, 0] + 0.5 * X[:, 1] - 0.3 * X[:, 2] + 0.3 * rng.randn(len(X))
    y = np.digitize(z, np.quantile(z, [0.5, 0.8, 0.93, 0.98]))
    return X, y.astype(np.float32), sizes


def _fixture():
    y = np.load(f"{FIX}/parity2_rel.npy")
    X = np.load(f"{FIX}/parity2_X.npy")[:len(y)]
    return X, y, np.load(f"{FIX}/parity2_grp.npy")


# ---------------------------------------------------------------- dcg
def test_dcg_helpers_exact():
    rng = np.random.RandomState(0)
    for gains in ([], [0.0, 1.0, 3.0, 7.0, 15.0, 40.0]):
        np.testing.assert_array_equal(tdcg.default_label_gain(gains),
                                      jdcg.default_label_gain(gains))
    np.testing.assert_array_equal(tdcg.discounts(37), jdcg.discounts(37))
    table = jdcg.default_label_gain(None)
    for _ in range(20):
        n = rng.randint(1, 40)
        lab = rng.randint(0, 5, n).astype(np.float64)
        sc = np.round(rng.randn(n), 1)          # ties ride the stable sort
        for k in (1, 3, 10, 100):
            assert tdcg.max_dcg_at_k(k, lab, table) == \
                jdcg.max_dcg_at_k(k, lab, table)
        assert tdcg.dcg_at_k([1, 2, 5, 50], lab, sc, table) == \
            jdcg.dcg_at_k([1, 2, 5, 50], lab, sc, table)
    with pytest.raises(lt.LightGBMError, match="non-negative integers"):
        tdcg.check_label(np.array([0.0, 1.5]), 31)
    with pytest.raises(lt.LightGBMError, match="larger than the size"):
        tdcg.check_label(np.array([0.0, 31.0]), 31)


# ----------------------------------------------------------- gradients
def _objectives(name, y, sizes, weight=None, **params):
    n = len(y)
    jm, tm = JMetadata(n), TMetadata(n)
    for m in (jm, tm):
        m.set_label(y)
        m.set_group(sizes)
        m.set_weight(weight)
    jo = j_create_objective(JConfig(dict(params, objective=name)))
    jo.init(jm, n)
    to = t_create_obj(TConfig(dict(params, objective=name)))
    to.init(tm, n, "cpu")
    return jo, to


def _scores(n, seed):
    """Zeros (every score ties: the first iteration), then scores on a
    coarse grid (ties inside queries), then distinct ones."""
    rng = np.random.RandomState(seed)
    return [np.zeros(n, np.float32),
            (np.round(rng.randn(n) * 2) / 2).astype(np.float32),
            rng.randn(n).astype(np.float32)]


@pytest.mark.parametrize("name,params,weighted", [
    ("lambdarank", {}, False),
    ("lambdarank", {"lambdarank_norm": False, "sigmoid": 2.0}, False),
    ("lambdarank", {"lambdarank_truncation_level": 5,
                    "label_gain": [0, 1, 2, 5, 9]}, True),
    ("rank_xendcg", {}, False),
    ("rank_xendcg", {"objective_seed": 11}, True),
], ids=["lambdarank", "lambdarank-nonorm", "lambdarank-trunc5-weighted",
        "xendcg", "xendcg-seed11-weighted"])
def test_gradients_match_jax(name, params, weighted):
    """Per query gradients and hessians on one seeded set of queries, three
    calls in a row (xendcg draws a fresh Gumbel u on each)."""
    X, y, sizes = _queries(1)
    w = (np.random.RandomState(2).rand(len(y)) + 0.5).astype(np.float32) \
        if weighted else None
    jo, to = _objectives(name, y, sizes, w, **params)
    for s in _scores(len(y), 3):
        gj, hj = jo.get_gradients(jnp.asarray(s[None]))
        gt, ht = to.get_gradients(torch.as_tensor(s[None]))
        assert gt.shape == (1, len(y)) and gt.dtype == torch.float32
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **GRAD_TOL)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **GRAD_TOL)


def test_lambdarank_pair_chunks_give_the_same_lambdas(monkeypatch):
    """Chunking the queries (the card's memory bound) changes no bit."""
    from lightgbm_tpu_torch.objective import rank
    X, y, sizes = _queries(4)
    _, to = _objectives("lambdarank", y, sizes)
    s = torch.as_tensor(_scores(len(y), 5)[2][None])
    g0, h0 = to.get_gradients(s)
    monkeypatch.setattr(rank, "PAIR_CHUNK_ELEMS", 1)     # one query each
    g1, h1 = to.get_gradients(s)
    assert torch.equal(g0, g1) and torch.equal(h0, h1)


def test_xendcg_gumbel_bits_match_jax():
    """The key sequence and the [Q, D] uniforms of three iterations, bit
    for bit against jax.random.split/uniform on PRNGKey(objective_seed)."""
    X, y, sizes = _queries(6)
    jo, to = _objectives("rank_xendcg", y, sizes, objective_seed=9)
    Q, D = to._labels.shape
    key = jax.random.PRNGKey(9)
    tkey = trandom.prng_key(9)
    for _ in range(3):
        key, sub = jax.random.split(key)
        keys = trandom.split(tkey)
        tkey = keys[0]
        np.testing.assert_array_equal(
            keys.numpy(), np.stack([np.asarray(key), np.asarray(sub)]))
        u = np.asarray(jax.random.uniform(sub, (Q, D)))
        ut = trandom.uniform(keys[1], Q * D).reshape(Q, D).numpy()
        np.testing.assert_array_equal(ut, u)
    # the objective's own key advances the same way
    s = jnp.zeros((1, len(y)), jnp.float32)
    for _ in range(2):
        jo.get_gradients(s)
        to.get_gradients(torch.zeros(1, len(y)))
    np.testing.assert_array_equal(to._rng_key.numpy(),
                                  np.asarray(jo._rng_key))


# -------------------------------------------------------------- metrics
@pytest.mark.parametrize("name", ["ndcg", "map"])
@pytest.mark.parametrize("case", ["seeded", "all-zero-queries", "fixture"])
def test_rank_metrics_match_jax(name, case):
    """Host float64 forms at 1e-12; the ndcg device form (f32) at 1e-6 of
    the float64 one. ``all-zero-queries`` zeroes the grades of every third
    query (such a query counts as perfect under ndcg)."""
    if case == "fixture":
        _, y, sizes = _fixture()
    else:
        _, y, sizes = _queries(7)
    if case == "all-zero-queries":
        qb = np.concatenate([[0], np.cumsum(sizes)])
        y = y.copy()
        for q in range(0, len(sizes), 3):
            y[qb[q]:qb[q + 1]] = 0
    n = len(y)
    cfg = {"eval_at": [1, 3, 5, 10]}
    tm, jm = TMetadata(n), JMetadata(n)
    for md in (tm, jm):
        md.set_label(y)
        md.set_group(sizes)
    mt = t_create_metric(name, TConfig(cfg))
    mj = j_create_metric(name, JConfig(cfg))
    mt.init(tm, n)
    mj.init(jm, n)
    for s in _scores(n, 8):
        want = mj.eval(s[None].astype(np.float64), None)
        got = mt.eval(s[None].astype(np.float64), None)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        assert mt.has_device_form(None) == (name == "ndcg")
        if name == "ndcg":
            dev = mt.eval_device(torch.as_tensor(s[None]), None)
            np.testing.assert_allclose([float(v) for v in dev], want,
                                       rtol=0, atol=1e-6)


def test_rank_metrics_refuse_without_groups():
    md = TMetadata(4)
    md.set_label(np.zeros(4))
    for name in ("ndcg", "map"):
        with pytest.raises(lt.LightGBMError, match="query information"):
            t_create_metric(name, TConfig({})).init(md, 4)
    with pytest.raises(lt.LightGBMError, match="query information"):
        lt.train({"objective": "lambdarank", "device_type": "cpu",
                  "verbose": -1},
                 lt.Dataset(np.random.RandomState(0).randn(4, 2),
                            label=np.zeros(4)), 1)


# ---------------------------------------------------------------- trees
def _train(pkg, objective, extra):
    X, y, sizes = _queries(5)
    Xv, yv, sv = _queries(15, Q=20)
    ds = pkg.Dataset(X, label=y, group=sizes)
    dv = pkg.Dataset(Xv, label=yv, group=sv, reference=ds)
    ev = {}
    p = dict(PARAMS, objective=objective, metric=["ndcg", "map"],
             eval_at=[1, 3, 5], **extra)
    bst = pkg.train(p, ds, 5, valid_sets=[dv], valid_names=["v"],
                    callbacks=[pkg.record_evaluation(ev)])
    bst.num_trees()                 # settles the JAX package's pipeline
    return bst, ev


@pytest.fixture(scope="module", params=OBJECTIVES)
def trained(request):
    obj = request.param
    bt, et = _train(lt, obj, {"device_type": "cpu"})
    bj, ej = _train(lj, obj, {})
    return obj, bt, et, bj, ej


def test_train_trees_match_jax(trained):
    obj, bt, _, bj, _ = trained
    X = _queries(5)[0]
    assert [m.num_leaves for m in bt.models] == [15] * 5
    assert bt._gbdt._fast_path_reason() is None
    assert_same_trees(bt.models, bj.models, X)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-5,
                               atol=1e-6)


def test_train_eval_curves_match_jax(trained):
    """ndcg@1,3,5 (device form) and map@1,3,5 (host) per round on the
    valid queries, against the JAX package's at rtol 1e-5 (the valid
    scores agree to f32 rounding), and the last round against a float64
    recomputation from ``predict``."""
    obj, bt, et, bj, ej = trained
    names = [f"{m}@{k}" for m in ("ndcg", "map") for k in (1, 3, 5)]
    assert sorted(et["v"]) == sorted(ej["v"]) == sorted(names)
    for k in names:
        np.testing.assert_allclose(et["v"][k], ej["v"][k], rtol=1e-5)
    Xv, yv, sv = _queries(15, Q=20)
    md = TMetadata(len(yv))
    md.set_label(yv)
    md.set_group(sv)
    m = t_create_metric("ndcg", TConfig({"eval_at": [1, 3, 5]}))
    m.init(md, len(yv))
    want = m.eval(bt.predict(Xv, raw_score=True)[None], None)
    np.testing.assert_allclose([et["v"][f"ndcg@{k}"][-1] for k in (1, 3, 5)],
                               want, rtol=1e-5)


def test_train_takes_no_traced_metric_body(trained):
    """As in the JAX package, the ranking objectives' gradients are not
    traced: ``megastep_eval_precheck`` names them (the JAX side opts into
    its megastep, which its interpret mode on the CPU otherwise leaves
    off)."""
    obj, bt, _, _, _ = trained
    assert bt._gbdt.megastep_eval_precheck(False) == \
        (False, "objective_untraced_gradients:" + obj)
    X, y, sizes = _queries(5)
    bj = lj.Booster(dict(PARAMS, objective=obj, tpu_megastep=True),
                    lj.Dataset(X, label=y, group=sizes))
    assert bj._gbdt.megastep_eval_precheck(False)[1] == \
        "objective_untraced_gradients:" + obj


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_fixture_update_trees_match_jax(objective):
    """The committed fixture through bare ``update()``s (the body a
    ranking objective takes there: the megastep one, no epilogue form)."""
    X, y, g = _fixture()
    p = dict(PARAMS, objective=objective, min_gain_to_split=1e-5)
    bst = []
    for pkg, extra in ((lt, {"device_type": "cpu"}), (lj, {})):
        b = pkg.Booster(dict(p, **extra), pkg.Dataset(X, label=y, group=g))
        for _ in range(4):
            b.update()
        b.num_trees()
        bst.append(b)
    bt, bj = bst
    assert not bt._gbdt._use_epilogue()
    assert bt.num_trees() == 4 and max(m.num_leaves for m in bt.models) > 2
    assert_same_trees(bt.models, bj.models, X)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------ groups and folds
def test_subset_keeps_whole_queries_as_jax():
    X, y, sizes = _queries(3)
    rows = np.concatenate([np.arange(100, 300), np.arange(0, 40)])
    outs = []
    for pkg in (lt, lj):
        ds = pkg.Dataset(X, label=y, group=sizes,
                         params={"device_type": "cpu", "verbose": -1})
        outs.append(ds.subset(rows).construct().get_group())
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].sum() == len(rows)
    ds = lt.Dataset(X, label=y, group=sizes, params={"device_type": "cpu"})
    np.testing.assert_array_equal(ds.get_group(), sizes)
    np.testing.assert_array_equal(ds.get_field("group"),
                                  np.concatenate([[0], np.cumsum(sizes)]))
    ds.set_group(sizes[::-1])
    np.testing.assert_array_equal(ds.get_group(), sizes[::-1])


@pytest.mark.parametrize("shuffle", [True, False])
def test_cv_folds_hold_whole_queries(shuffle):
    """Without ``folds`` a grouped Dataset folds by whole queries, as the
    JAX package's ``_make_n_folds``; a splitter gets each row's query."""
    X, y, sizes = _queries(3)
    qb = np.concatenate([[0], np.cumsum(sizes)])
    folds = []
    for pkg, mk in ((lt, t_folds), (lj, j_folds)):
        ds = pkg.Dataset(X, label=y, group=sizes,
                         params={"device_type": "cpu", "verbose": -1})
        folds.append(mk(ds, None, 3, {}, 7, False, shuffle))
    for (a_tr, a_te), (b_tr, b_te) in zip(*folds):
        np.testing.assert_array_equal(a_tr, b_tr)
        np.testing.assert_array_equal(a_te, b_te)
        q = np.searchsorted(qb, a_te, side="right") - 1
        for qq in np.unique(q):
            assert (q == qq).sum() == sizes[qq]

    class Splitter:
        def split(self, X, y=None, groups=None):
            self.groups = groups
            yield np.arange(10), np.arange(10, 20)
    sp = Splitter()
    ds = lt.Dataset(X, label=y, group=sizes, params={"device_type": "cpu"})
    t_folds(ds, sp, 3, {}, 0, False, True)
    np.testing.assert_array_equal(sp.groups,
                                  np.repeat(np.arange(len(sizes)), sizes))


def test_cv_ranks_by_query_folds():
    X, y, sizes = _queries(3)
    ds = lt.Dataset(X, label=y, group=sizes)
    res = lt.cv(dict(PARAMS, objective="lambdarank", device_type="cpu",
                     metric="ndcg", eval_at=[3]), ds, 3, nfold=3,
                return_cvbooster=True)
    assert len(res["valid ndcg@3-mean"]) == 3
    assert all(0 < v <= 1 for v in res["valid ndcg@3-mean"])
    qb = np.concatenate([[0], np.cumsum(sizes)])
    for b in res["cvbooster"].boosters:
        te = b.valid_sets[0]
        q = np.searchsorted(qb, te.used_indices, side="right") - 1
        np.testing.assert_array_equal(te.get_group(), np.bincount(q)[
            np.unique(q)])


# ------------------------------------------------------ the model text
def test_reference_rank_model_predicts():
    """The reference's own lambdarank model (model text) predicts
    ``ref_pred_rank.npy``, as tests/test_ref_parity.py holds the JAX
    package to it."""
    X = np.load(f"{FIX}/parity2_X.npy")
    n = len(np.load(f"{FIX}/parity2_rel.npy"))
    want = np.load(f"{FIX}/ref_pred_rank.npy")
    bst = lt.Booster(params={"device_type": "cpu"},
                     model_file=f"{FIX}/ref_model_rank.txt")
    assert bst.objective.name == "lambdarank"
    np.testing.assert_allclose(bst.predict(X[:n]), want, rtol=1e-6,
                               atol=1e-9)


def test_trained_rank_model_text_round_trip(trained):
    """A JAX-trained ranking model loads into the port through its text
    and predicts the same; the port's own text round-trips."""
    from lightgbm_tpu_torch.convert import booster_from_model_string
    obj, bt, _, bj, _ = trained
    X = _queries(5)[0]
    loaded = booster_from_model_string(bj.model_to_string(), "cpu")
    assert loaded.objective.name == obj
    np.testing.assert_allclose(loaded.predict(X), bj.predict(X), rtol=1e-6,
                               atol=1e-9)
    again = lt.Booster(params={"device_type": "cpu"},
                       model_str=bt.model_to_string())
    np.testing.assert_array_equal(again.predict(X), bt.predict(X))
