"""Exclusive feature bundling (EFB): the port trains unbundled where the
JAX package bundles, and gets the same trees.

``enable_bundle`` defaults to true, and the JAX package's fused engine
bundles whenever bundling cuts the column count
(``lightgbm_tpu/boosting/gbdt.py`` ``_setup_bundles``). The port does not
bundle yet. On mutually exclusive columns a bundle holds the same row
partitions as its unbundled columns, so both packages must grow the same
trees: 3,000 rows of 3 dense and 8 mutually exclusive columns, binary,
7 leaves, 3 rounds, ``enable_bundle`` left at its default. The test first
checks that the JAX side really bundled (else it proves nothing), then
equal trees under tests/torch_parity.py's near-tie rule and raw
predictions within 1e-6. Seven leaves keep every split on signal: at 15
leaves the last splits of the first tree tie exactly between a dense and
a bundled column (gain 2.644 both), and the bundled search order breaks
the tie the other way. One JAX configuration, in a file of its own, so its
interpret-mode compile runs beside the other files.
"""
import numpy as np
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from torch_parity import assert_same_trees

# small shapes: intra-op threads would only contend with the other test
# workers' processes
torch.set_num_threads(1)

ROUNDS = 3


def _data():
    """3 dense columns and 8 columns of which each row sets at most one."""
    rng = np.random.RandomState(11)
    n = 3000
    dense = rng.randn(n, 3)
    sparse = np.zeros((n, 8))
    which = rng.randint(-1, 8, n)                # -1: no sparse column set
    rows = np.nonzero(which >= 0)[0]
    sparse[rows, which[rows]] = rng.uniform(0.5, 3.0, rows.size)
    X = np.hstack([dense, sparse])
    y = (dense[:, 0] + 0.8 * sparse[:, 2] - 0.6 * sparse[:, 5]
         + 0.3 * rng.randn(n) > 0).astype(np.float64)
    return X, y


def test_port_trains_unbundled_with_the_jax_package_bundles():
    X, y = _data()
    assert ((X[:, 3:] != 0).sum(1) <= 1).all()   # mutually exclusive
    p = {"objective": "binary", "num_leaves": 7, "verbose": -1}
    assert "enable_bundle" not in p                 # the default: true
    bj = lj.train(dict(p, tpu_engine="fused", tpu_fused_epilogue=False),
                  lj.Dataset(X, label=y), num_boost_round=ROUNDS)
    assert bj._gbdt.use_bundles                     # the JAX side bundled
    bt = lt.train(dict(p, device_type="cpu"), lt.Dataset(X, label=y),
                  num_boost_round=ROUNDS)
    assert bj.num_trees() == bt.num_trees() == ROUNDS
    assert_same_trees(bt.models, bj.models, X)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=0,
                               atol=1e-6)
