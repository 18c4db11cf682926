"""Sparse (CSR/CSC) input end to end: lightgbm_tpu_torch against the JAX
package.

A scipy matrix goes through ``Dataset`` without being densified
(``BinnedDataset.from_sparse``: per-column mappers from the sample, the
exclusive columns bundled at ingestion, the bundle-column matrix encoded
from the CSC columns), trains through ``train()`` (megastep body) and a
bare ``update()`` loop (epilogue body), evaluates on a sparse valid set
with early stopping, rolls back, cross-validates (against the port's cv
of the same rows given dense) and predicts on the sparse matrix. Both packages see the same matrix: the bundle lists must be
equal, the trees equal under tests/torch_parity.py's near-tie rule, raw
predictions within 1e-6, and the port's model text must load and predict
the same. The data: 5,000 rows of 4 dense columns, three one-hot fields of
8 levels (value 1.0) and 4 mutually exclusive numerical columns, a binary
label from dense columns, two levels and one sparse column; 7 leaves, 3
rounds. One JAX configuration (``tpu_engine="fused",
tpu_fused_epilogue=False``) on one matrix shape, shared by every test, so
the interpret-mode compile is paid once in this file's worker.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from torch_parity import assert_same_trees

# small shapes: intra-op threads would only contend with the other test
# workers' processes
torch.set_num_threads(1)

ROUNDS = 3
BASE = {"objective": "binary", "num_leaves": 7, "verbose": -1}
JAX = dict(BASE, tpu_engine="fused", tpu_fused_epilogue=False)
PORT = dict(BASE, device_type="cpu")


def _data(n=5000, seed=3):
    rng = np.random.RandomState(seed)
    dense = rng.randn(n, 4)
    cols, levels = [dense], []
    for _ in range(3):
        k = rng.randint(0, 8, n)
        onehot = np.zeros((n, 8))
        onehot[np.arange(n), k] = 1.0
        cols.append(onehot)
        levels.append(k)
    num = np.zeros((n, 4))
    which = rng.randint(-1, 4, n)
    rows = np.nonzero(which >= 0)[0]
    num[rows, which[rows]] = rng.uniform(0.5, 3.0, rows.size)
    cols.append(num)
    X = np.hstack(cols)
    z = (dense[:, 0] + 1.2 * (levels[0] == 3) - 1.0 * (levels[1] == 5)
         + 0.8 * num[:, 1] + 0.3 * rng.randn(n))
    return X, (z > 0).astype(np.float64)


@pytest.fixture(scope="module")
def data():
    X, y = _data()
    Xv, yv = _data(2000, seed=4)
    return X, y, Xv, yv


@pytest.fixture(scope="module")
def jax_booster(data):
    X, y, _, _ = data
    bj = lj.train(JAX, lj.Dataset(sp.csr_matrix(X), label=y), ROUNDS)
    assert bj.num_trees() == ROUNDS
    return bj


def _assert_same(bt, bj, X, M):
    assert bt.num_trees() == bj.num_trees()
    assert_same_trees(bt.models, bj.models, X)
    np.testing.assert_allclose(bt.predict(M, raw_score=True),
                               bj.predict(M, raw_score=True), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_sparse_train_matches_jax(data, jax_booster, fmt):
    X, y, _, _ = data
    M = sp.csr_matrix(X) if fmt == "csr" else sp.csc_matrix(X)
    dj = lj.Dataset(M, label=y).construct()
    dt = lt.Dataset(M, label=y, params={"device_type": "cpu"}).construct()
    assert dt._inner.prebundled is not None
    assert dt._inner.prebundled.bundles == dj._inner.prebundled.bundles
    assert len(dt._inner.prebundled.bundles) < dt._inner.num_features
    np.testing.assert_array_equal(dt._inner.bins,
                                  np.asarray(dj._inner.bins))
    bt = lt.train(PORT, dt, ROUNDS)
    assert bt._gbdt.use_bundles and jax_booster._gbdt.use_bundles
    _assert_same(bt, jax_booster, X, M)
    # the trainer's scores are the sparse predictions
    np.testing.assert_allclose(bt._gbdt.scores[0].numpy(),
                               bt.predict(M, raw_score=True), rtol=0,
                               atol=1e-6)
    # the model text: logical feature indices, and a round trip
    text = bt.model_to_string()
    assert "max_feature_idx=%d" % (X.shape[1] - 1) in text
    loaded = lt.Booster(model_str=text, params={"device_type": "cpu"})
    np.testing.assert_array_equal(loaded.predict(M, raw_score=True),
                                  bt.predict(M, raw_score=True))


def test_sparse_update_body_matches_jax(data, jax_booster):
    X, y, _, _ = data
    M = sp.csr_matrix(X)
    bt = lt.Booster(PORT, lt.Dataset(M, label=y))
    assert bt._gbdt._use_epilogue()
    for _ in range(ROUNDS):
        bt.update()
    _assert_same(bt, jax_booster, X, M)


def test_sparse_valid_early_stopping_and_rollback(data):
    X, y, Xv, yv = data
    M, Mv = sp.csr_matrix(X), sp.csr_matrix(Xv)
    p = {"metric": ["binary_logloss", "auc"]}
    ev_j, ev_t = {}, {}
    dj = lj.Dataset(M, label=y)
    bj = lj.train(dict(JAX, **p), dj, 6,
                  valid_sets=[lj.Dataset(Mv, label=yv, reference=dj)],
                  callbacks=[lj.early_stopping(2, verbose=False),
                             lj.record_evaluation(ev_j)])
    dt = lt.Dataset(M, label=y)
    dv = lt.Dataset(Mv, label=yv, reference=dt)
    bt = lt.train(dict(PORT, **p), dt, 6, valid_sets=[dv],
                  callbacks=[lt.early_stopping(2, verbose=False),
                             lt.record_evaluation(ev_t)])
    # the valid set is routed on exact logical bins
    assert dv._inner.prebundled is None
    assert bt.best_iteration == bj.best_iteration
    for metric in ("binary_logloss", "auc"):
        np.testing.assert_allclose(ev_t["valid_0"][metric],
                                   ev_j["valid_0"][metric], rtol=1e-5)
    _assert_same(bt, bj, X, Mv)
    # rollback subtracts the last tree from the training and valid scores
    g = bt._gbdt
    k = bt.num_trees()
    before = g.scores[0].clone(), g.valid_scores[0][0].clone()
    bt.update()
    bt.rollback_one_iter()
    assert bt.num_trees() == k
    np.testing.assert_allclose(g.scores[0].numpy(), before[0].numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(g.valid_scores[0][0].numpy(),
                               before[1].numpy(), rtol=0, atol=1e-6)


def test_sparse_cv_matches_dense_cv(data):
    """cv folds of a sparse-built dataset slice its bundle rows. The JAX
    package's cv cannot take sparse input (its row subset drops the
    bundle layout and then bundles the bundle columns again), so the
    port's sparse cv is held to its own cv of the same rows given dense,
    which the JAX package's tests hold (tests/test_torch_cv.py)."""
    X, y, _, _ = data
    p = dict(PORT, metric="binary_logloss")
    rs = lt.cv(p, lt.Dataset(sp.csr_matrix(X), label=y), 2, nfold=3,
               stratified=False, seed=5)
    rd = lt.cv(p, lt.Dataset(X, label=y), 2, nfold=3, stratified=False,
               seed=5)
    assert set(rs) == set(rd)
    for key in rd:
        np.testing.assert_allclose(rs[key], rd[key], rtol=1e-6)


def test_sparse_zero_as_missing_matches_jax(data):
    """Zeros binned as missing: a member whose zeros leave its
    most-frequent bin expands densely into its bundle column."""
    X, y, _, _ = data
    M = sp.csr_matrix(X)
    p = {"zero_as_missing": True}
    dj = lj.Dataset(M, label=y, params=p).construct()
    dt = lt.Dataset(M, label=y, params=dict(p, device_type="cpu"))
    dt.construct()
    assert dt._inner.prebundled.bundles == dj._inner.prebundled.bundles
    np.testing.assert_array_equal(dt._inner.bins,
                                  np.asarray(dj._inner.bins))
    np.testing.assert_array_equal(dt._inner.most_freq_bins,
                                  np.asarray(dj._inner.most_freq_bins))


@pytest.mark.parametrize("params,kw", [
    ({}, dict(categorical_feature=[4])),
    ({"linear_tree": True}, {}),
])
def test_sparse_refusals(data, params, kw):
    X, y, _, _ = data
    ds = lt.Dataset(sp.csr_matrix(X[:200]), label=y[:200],
                    params=dict(params, device_type="cpu"), **kw)
    with pytest.raises(lt.basic.LightGBMError):
        ds.construct()
