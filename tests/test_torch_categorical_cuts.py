"""Categorical features under the adaptive-bins cut (``tpu_adaptive_bins``:
each feature's slab narrowed to its pow2 width, the route table's
categorical rows re-indexed onto the packed flat axis) against the JAX
package, on tests/test_torch_categorical.py's data and parameters:
``train()`` for 4 rounds, the trees equal (split features, decision
types, category bitsets; leaf values within rtol 1e-5) and predictions
within rtol 1e-5. A compiled configuration of its own, so
``--dist loadfile`` runs it beside the other file.
"""
import numpy as np
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from test_torch_categorical import (CATS, PARAMS, ROUNDS,
                                    assert_same_cat_trees, cat_rows)

torch.set_num_threads(1)


def test_adaptive_bins_categorical_trees_match_jax():
    X, y = cat_rows()
    bst = []
    for pkg, extra in ((lt, {"device_type": "cpu"}), (lj, {})):
        ds = pkg.Dataset(X, label=y, categorical_feature=CATS)
        b = pkg.train(dict(PARAMS, tpu_adaptive_bins=True, **extra), ds,
                      ROUNDS)
        b.num_trees()
        bst.append(b)
    bt, bj = bst
    assert bt._gbdt.fused_packed is not None and bj._gbdt.use_adaptive_bins
    assert all((m.decision_type & 1).sum() > 0 for m in bt.models)
    assert_same_cat_trees(bt.models, bj.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-5,
                               atol=1e-7)
