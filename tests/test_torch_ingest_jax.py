"""One CSV through both packages: the same trees, and each package loads
the other's ``LGBMTPU2`` cache.

800 rows x 5 columns (a NaN-missing and an integer column), binary,
``num_leaves`` 7, 3 rounds. The JAX package trains once, on its fused
engine from the file (``Dataset(path)``); the port trains the same file
monolithic and streamed (``two_round``, chunks that split it unevenly),
and both grow the JAX package's trees under tests/torch_parity.py's
near-tie rule, with the same ``feature_importances:`` block of the model
text at ``importance_type="gain"`` (Queue C 8) and raw predictions within
1e-6. A sidecar cache that either package writes from the file
(``save_binary=true``) loads in the other with the same bins, mappers and
label; the port takes the JAX package's sidecar as a hit. One JAX
configuration, in a file of its own, so its interpret-mode compile runs
beside the other files.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.native import loader as native
from torch_parity import assert_same_trees

torch.set_num_threads(1)

ROUNDS = 3
N = 800
P = {"objective": "binary", "num_leaves": 7, "verbose": -1,
     "min_data_in_leaf": 10, "max_bin": 31}


def _write(path):
    rng = np.random.RandomState(5)
    X = rng.randn(N, 5).astype(np.float32)
    X[:, 2] = rng.randint(0, 4, N)
    X[rng.rand(N) < 0.05, 4] = np.nan
    y = (X[:, 0] - 0.7 * X[:, 1] + 0.3 * rng.randn(N) > 0).astype(
        np.float32)
    with open(path, "w") as fh:
        fh.write("label,a,b,c,d,e\n")
        for yi, row in zip(y, X):
            fh.write(",".join([f"{yi:g}"] + [
                "" if np.isnan(v) else f"{v:.9g}" for v in row]) + "\n")
    return X, y


@pytest.fixture(scope="module")
def csv(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ingest_jax") / "train.csv")
    X, y = _write(path)
    bj = lj.train(dict(P, tpu_engine="fused", tpu_fused_epilogue=False),
                  lj.Dataset(path), num_boost_round=ROUNDS)
    assert bj.num_trees() == ROUNDS
    return path, X, y, bj


def _importances(text):
    return text.split("feature_importances:\n")[1].split("\n\n")[0]


@pytest.mark.parametrize("extra", [{}, {"two_round": True,
                                        "ingest_chunk_rows": 333}],
                         ids=["monolithic", "streamed"])
def test_same_csv_same_trees(csv, extra):
    path, X, y, bj = csv
    ds = lt.Dataset(path, params=dict(P, device_type="cpu", **extra))
    bt = lt.train(dict(P, device_type="cpu", **extra), ds, ROUNDS)
    np.testing.assert_array_equal(ds.get_label(), y)
    assert bt.feature_name() == bj.feature_name()
    assert_same_trees(bt.models, bj.models, X.astype(np.float64))
    assert _importances(bt.model_to_string(importance_type="gain")) \
        == _importances(bj.model_to_string(importance_type="gain"))
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=0,
                               atol=1e-6)


def _same(inner_t, inner_j):
    np.testing.assert_array_equal(np.asarray(inner_t.bins),
                                  np.asarray(inner_j.bins))
    np.testing.assert_equal([m.to_dict() for m in inner_t.mappers],
                            [m.to_dict() for m in inner_j.mappers])
    np.testing.assert_array_equal(inner_t.metadata.label,
                                  inner_j.metadata.label)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sidecar_cache_crosses_packages(csv, tmp_path, writer):
    src, _, _, _ = csv
    path = str(tmp_path / "train.csv")
    with open(src) as a, open(path, "w") as b:
        b.write(a.read())
    params = dict(P, save_binary=True)
    if writer == "port":
        made = lt.Dataset(path, params=dict(
            params, device_type="cpu", two_round=True,
            ingest_chunk_rows=300)).construct()
        got = lj.Dataset(path + ".bin", params=dict(P)).construct()
        _same(made._inner, got._inner)
    else:
        made = lj.Dataset(path, params=dict(params)).construct()
        n0 = native.backend["native"] + native.backend["numpy"]
        got = lt.Dataset(path, params=dict(params, device_type="cpu"))
        got.construct()
        # the JAX package's sidecar is a hit: nothing parsed
        assert native.backend["native"] + native.backend["numpy"] == n0
        assert got._inner.ingest_stats["cache_hit"] == 1
        _same(got._inner, made._inner)
