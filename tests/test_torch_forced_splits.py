"""Forced splits through the port against the JAX package
(``lightgbm_tpu/boosting/gbdt.py:1359-1403``, the leaf-wise grower's
forced schedule ``models/learner.py:673-706``), on the CPU.

``tests/test_forced_splits.py``'s fixture (signal on feature 2 only, the
JSON forcing feature 0 at 0.5, then feature 1 at 0.3 on its left and 0.6
on its right) through both packages: equal trees under
``torch_parity``'s near-tie rule, predictions within rtol 1e-5 / atol
1e-6, the forced nodes first. The engine moves as the JAX package's, with
its log lines: forced splits take the leaf-wise XLA grower from the fused
engine and disable CEGB; a categorical forced feature is fatal, and so is
a sparse-built (prebundled) dataset.
"""
import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.utils import log as jlog
from lightgbm_tpu_torch.utils import log as tlog
from torch_parity import assert_same_trees

torch.set_num_threads(1)

PARAMS = {"objective": "binary", "num_leaves": 8, "verbose": 1,
          "min_data_in_leaf": 5}
FORCED = {"feature": 0, "threshold": 0.5,
          "left": {"feature": 1, "threshold": 0.3},
          "right": {"feature": 1, "threshold": 0.6}}


def _rows():
    rng = np.random.RandomState(0)
    X = rng.rand(2000, 3).astype(np.float32)
    y = (X[:, 2] > 0.5).astype(np.float32)     # signal on feature 2 only
    return X, y


@pytest.fixture
def forced_json(tmp_path):
    path = tmp_path / "forced.json"
    path.write_text(json.dumps(FORCED))
    return str(path)


def _logged(log, fn):
    lines = []
    log.register_logger(lines.append)
    try:
        return fn(), lines
    finally:
        log.register_logger(None)


def _train_port(params, X, y, rounds=1, cats="auto"):
    return lt.train(dict(params, device_type="cpu"),
                    lt.Dataset(X, label=y, categorical_feature=cats), rounds)


def test_forced_splits_match_jax(forced_json):
    X, y = _rows()
    p = dict(PARAMS, forcedsplits_filename=forced_json)
    bj = lj.train(dict(p), lj.Dataset(X, label=y), 3)
    bj.num_trees()
    bt = _train_port(dict(p, tpu_engine="xla"), X, y, 3)
    g = bt._gbdt
    assert g.n_forced == bj._gbdt.n_forced == 3
    np.testing.assert_array_equal(g.forced_leaf, [0, 0, 1])
    np.testing.assert_array_equal(g.forced_feat, [0, 1, 1])
    assert g.grow_policy == "leafwise"
    assert g._fast_path_reason() == "engine:xla"
    for t in bt.models:
        assert list(t.split_feature[:3]) == [0, 1, 1]
        np.testing.assert_allclose(t.threshold[:3], [0.5, 0.3, 0.6],
                                   atol=0.05)
        assert 2 in set(t.split_feature[:t.num_internal].tolist())
        assert int(t.leaf_count.sum()) == 2000
    assert_same_trees(bt.models, bj.models, X)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)


def test_forced_on_fused_takes_xla_leafwise(forced_json):
    X, y = _rows()
    p = dict(PARAMS, forcedsplits_filename=forced_json, tpu_engine="fused",
             grow_policy="depthwise")
    bt, lines = _logged(tlog, lambda: _train_port(p, X, y))
    g = bt._gbdt
    assert (g.use_fused, g.grow_policy) == (False, "leafwise")
    assert any("forced splits use the leaf-wise XLA engine" in s
               for s in lines)
    assert any("forced splits are implemented on the leaf-wise grower"
               in s for s in lines)
    assert list(bt.models[0].split_feature[:3]) == [0, 1, 1]


def test_forced_with_cegb_disables_cegb(forced_json):
    X, y = _rows()
    p = dict(PARAMS, forcedsplits_filename=forced_json,
             cegb_penalty_split=0.01)
    want = ("CEGB penalties are not applied when forced splits are enabled "
            "(leaf-wise grower); disabling CEGB")
    bt, t_lines = _logged(tlog, lambda: _train_port(p, X, y))
    bj, j_lines = _logged(jlog, lambda: lj.train(
        dict(p), lj.Dataset(X, label=y), 1))
    for g, lines in ((bt._gbdt, t_lines), (bj._gbdt, j_lines)):
        assert not g.use_cegb and g.grow_policy == "leafwise"
        assert any(want in s for s in lines)
    assert list(bt.models[0].split_feature[:3]) == [0, 1, 1]


def test_forced_on_categorical_is_fatal(forced_json):
    X, y = _rows()
    X[:, 0] = np.random.RandomState(1).randint(0, 5, len(X))
    with pytest.raises(lt.LightGBMError, match="categorical"):
        _train_port(dict(PARAMS, forcedsplits_filename=forced_json), X, y,
                    cats=[0])


def test_forced_on_prebundled_csr_is_fatal(forced_json):
    X, y = _rows()
    rng = np.random.RandomState(2)
    onehot = np.zeros((len(X), 12), np.float32)
    onehot[np.arange(len(X)), rng.randint(0, 12, len(X))] = 1.0
    csr = sp.csr_matrix(np.hstack([X, onehot]))
    ds = lt.Dataset(csr, label=y, params={"device_type": "cpu"})
    assert ds.construct()._inner.prebundled is not None
    with pytest.raises(lt.LightGBMError, match="prebundled"):
        lt.train(dict(PARAMS, forcedsplits_filename=forced_json,
                      device_type="cpu"), ds, 1)
