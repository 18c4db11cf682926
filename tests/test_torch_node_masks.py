"""Per-node feature masks (``feature_fraction_bynode`` and interaction
constraints) through the port's ``train()`` against the JAX package.

2,000 x 6 rows (one 5% NaN column), a binary label of three features,
6 rounds at num_leaves=15 and max_bin=15, on
``lightgbm_tpu_torch.train(..., device_type="cpu")`` and
``lightgbm_tpu.train(..., tpu_engine="fused", tpu_fused_epilogue=False)``:
the trees equal (``torch_parity.assert_same_trees``) for by-node sampling
alone, constraints alone and both; under constraints every root-to-leaf
path splits on the features of one group only. Both packages train these
on their synchronous bodies; the frontier-v1 engine degrades to the fused
one.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from torch_parity import assert_same_trees

torch.set_num_threads(1)

ROUNDS = 6
PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 15,
          "verbose": -1, "min_data_in_leaf": 5, "feature_fraction_seed": 7}
JAX_ENGINE = {"tpu_engine": "fused", "tpu_fused_epilogue": False}
GROUPS = [[0, 1, 2], [3, 4, 5]]
CASES = {"bynode": {"feature_fraction_bynode": 0.5},
         "constraints": {"interaction_constraints": GROUPS},
         "both": {"feature_fraction_bynode": 0.7,
                  "interaction_constraints": GROUPS}}


def _data():
    rng = np.random.RandomState(2)
    X = rng.randn(2000, 6)
    X[rng.rand(2000) < 0.05, 4] = np.nan
    z = X[:, 0] + 0.6 * X[:, 3] - 0.5 * np.nan_to_num(X[:, 4]) \
        + 0.3 * rng.randn(2000)
    return X, (z > 0).astype(np.float64)


def _train(pkg, extra):
    X, y = _data()
    bst = pkg.train(dict(PARAMS, **extra), pkg.Dataset(X, label=y), ROUNDS)
    bst.num_trees()
    return bst


@pytest.fixture(scope="module", params=list(CASES))
def trained(request):
    case = CASES[request.param]
    return (request.param, _train(lt, dict(case, device_type="cpu")),
            _train(lj, dict(case, **JAX_ENGINE)))


def test_trees_match_jax(trained):
    _, bt, bj = trained
    X, _ = _data()
    assert bt._gbdt.use_node_masks
    assert bt._gbdt._fast_path_reason() == \
        "config:interaction_constraints/feature_fraction_bynode"
    assert bt.num_trees() == bj.num_trees() == ROUNDS
    assert_same_trees(bt.models, bj.models, X)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-5,
                               atol=1e-7)


def _paths(tree, node=0, path=()):
    if node < 0:
        yield path
        return
    f = int(tree.split_feature[node])
    yield from _paths(tree, int(tree.left_child[node]), path + (f,))
    yield from _paths(tree, int(tree.right_child[node]), path + (f,))


@pytest.mark.parametrize("case", ["constraints", "both"])
def test_paths_stay_in_one_group(case):
    bt = _train(lt, dict(CASES[case], device_type="cpu"))
    n_paths = 0
    for t in bt.models:
        for path in _paths(t):
            assert any(set(path) <= set(g) for g in GROUPS), path
            n_paths += 1
    assert n_paths > ROUNDS


def test_bynode_samples_differ_per_node():
    bt = _train(lt, dict(CASES["bynode"], device_type="cpu"))
    # with half the features per node, no single feature wins every root
    roots = {int(t.split_feature[0]) for t in bt.models}
    assert len(roots) > 1


def test_frontier_engine_degrades_to_fused():
    X, y = _data()
    p = dict(PARAMS, **CASES["bynode"], device_type="cpu")
    bf = lt.train(dict(p, tpu_engine="frontier"), lt.Dataset(X, label=y), 3)
    bu = lt.train(p, lt.Dataset(X, label=y), 3)
    assert not bf._gbdt.use_frontier
    def trees(b):
        return b.model_to_string().split("parameters:")[0]
    assert trees(bf) == trees(bu)
