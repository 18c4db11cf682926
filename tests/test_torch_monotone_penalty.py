"""``monotone_penalty``, the synchronous body and a categorical column
beside a constrained one, through the port against the JAX package's fused
engine.

``test_torch_monotone``'s fixture, 20 rounds through ``train()``:
(penalty) ``monotone_penalty=2.0``, whose depth factor takes the net gain
of monotone splits near the root (the root then splits on x1); (bynode)
``feature_fraction_bynode=0.5`` in the intermediate mode, which both
packages train on their synchronous bodies; (categorical) the constant
column replaced by twelve category codes, category 0 shifting the label,
split one-vs-rest (``max_cat_to_onehot=16``), beside the constraint on x0.
A leaf left with two categories would tie {a} against its complement {b},
which f32 sums in another order break either way; a one-vs-rest split of
one shifted category leaves ten or more in a leaf. The trees equal
(``torch_parity.assert_same_trees``), predictions are monotone in x0 in
every category, and under the penalty the first root splits on x1. The
bynode case runs in ``tests/test_torch_monotone_bynode.py``.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from test_torch_monotone import (JAX_ENGINE, PARAMS, ROUNDS, adversarial,
                                 worst_step)
from torch_parity import assert_same_trees

torch.set_num_threads(1)

CASES = {
    "penalty": {"monotone_penalty": 2.0},
    "bynode": {"feature_fraction_bynode": 0.5, "feature_fraction_seed": 3,
               "monotone_constraints_method": "intermediate"},
    "categorical": {"categorical_feature": [0], "max_cat_to_onehot": 16},
}


def _data(case):
    X, y = adversarial()
    if case == "categorical":
        codes = np.random.RandomState(5).randint(0, 12, len(y))
        X[:, 0] = codes
        y = y + 0.5 * (codes == 0)
    return X, y


def train_both(case):
    """(case, X, the port's booster, the JAX package's) of one case."""
    X, y = _data(case)
    extra = dict(CASES[case])
    cats = extra.pop("categorical_feature", "auto")
    out = []
    for pkg, kw in ((lt, {"device_type": "cpu"}), (lj, JAX_ENGINE)):
        bst = pkg.train(dict(PARAMS, **extra, **kw),
                        pkg.Dataset(X, label=y, categorical_feature=cats),
                        ROUNDS)
        bst.num_trees()
        out.append(bst)
    return case, X, out[0], out[1]


# "bynode" runs in tests/test_torch_monotone_bynode.py, so that
# --dist loadfile trains it beside these
@pytest.fixture(scope="module", params=["penalty", "categorical"])
def trained(request):
    return train_both(request.param)


def test_trees_match_jax(trained):
    case, X, bt, bj = trained
    g = bt._gbdt
    assert g.use_mono_bounds
    assert (g._fast_path_reason() is not None) == (case == "bynode")
    if case == "categorical":
        assert g.cat_idx is not None
        assert any(((m.decision_type[:m.num_internal] & 1) != 0).any()
                   for m in bt.models)
    if case == "penalty":
        assert bt.models[0].split_feature[0] == 2
    assert bt.num_trees() == bj.num_trees() == ROUNDS
    assert_same_trees(bt.models, bj.models, X)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-5,
                               atol=1e-6)


def test_monotone_in_x0(trained):
    case, X, bt, bj = trained
    if case == "categorical":
        # every category: predict along x0 with x1 fixed
        for code in range(12):
            for other in (0.1, 0.9):
                grid = np.linspace(0.01, 0.99, 200)
                Xg = np.stack([np.full(200, code), grid,
                               np.full(200, other)], 1)
                for b in (bt, bj):
                    assert np.diff(b.predict(Xg)).min() >= -1e-6
        return
    assert worst_step(bt) >= -1e-6
    assert worst_step(bj) >= -1e-6

