"""The binary dataset cache across the two packages.

2,000 x 5 rows (5% NaN in one column, six category codes in another),
weights, query groups and ``monotone_constraints``: a cache written by
``lightgbm_tpu.Dataset.save_binary`` loads through
``lightgbm_tpu_torch.Dataset(path)`` and one written by the port loads in
the JAX package, each with the same bins (dtype included), mappers
(``to_dict``), label, weight, groups, constraints, feature names and
model-text ``feature_infos``; the JAX package's v1 pickle (``LGBMTPU1``)
loads too. A loaded dataset trains to the same model text as the dataset
it was saved from, and holds its bins on the host until a booster is
built; a corrupt file is refused.
"""
import os
import pickle

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.io.cache import CacheError

torch.set_num_threads(1)

PARAMS = {"max_bin": 31, "verbose": -1, "min_data_in_leaf": 5,
          "monotone_constraints": [1, 0, 0, -1, 0]}


def rows(n=2000, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5)
    X[rng.rand(n) < 0.05, 1] = np.nan
    X[:, 2] = rng.randint(0, 6, n)
    y = (X[:, 0] - X[:, 3] + 0.3 * rng.randn(n) > 0).astype(np.float64)
    w = rng.rand(n) + 0.5
    group = np.full(n // 50, 50)
    return X, y, w, group


def _dataset(pkg, extra=None):
    X, y, w, group = rows()
    return pkg.Dataset(X, label=y, weight=w, group=group,
                       categorical_feature=[2],
                       params=dict(PARAMS, **(extra or {}))).construct()


def _same_inner(a, b):
    np.testing.assert_array_equal(np.asarray(a.bins), np.asarray(b.bins))
    assert np.asarray(a.bins).dtype == np.asarray(b.bins).dtype
    # (assert_equal: a NaN-missing mapper's last bound is NaN)
    np.testing.assert_equal([m.to_dict() for m in a.mappers],
                            [m.to_dict() for m in b.mappers])
    assert list(a.used_features) == list(b.used_features)
    assert a.num_total_features == b.num_total_features
    assert list(a.feature_names) == list(b.feature_names)
    assert a.feature_infos() == b.feature_infos()
    for k in ("label", "weight", "query_boundaries"):
        np.testing.assert_array_equal(getattr(a.metadata, k),
                                      getattr(b.metadata, k), k)
    np.testing.assert_array_equal(a.monotone_constraints,
                                  b.monotone_constraints)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_crosses_packages(writer, tmp_path):
    path = str(tmp_path / "train.bin")
    dj = _dataset(lj)
    dt = _dataset(lt, {"device_type": "cpu"})
    _same_inner(dt._inner, dj._inner)
    if writer == "jax":
        dj.save_binary(path)
        loaded = lt.Dataset(path, params={"device_type": "cpu"}).construct()
        assert loaded._inner._bins_dev is None
        _same_inner(loaded._inner, dj._inner)
    else:
        dt.save_binary(path)
        loaded = lj.Dataset(path).construct()
        _same_inner(loaded._inner, dt._inner)
    assert loaded._inner.dataset_params["max_bin"] == 31


def test_legacy_v1_pickle(tmp_path):
    dj = _dataset(lj)._inner
    md = dj.metadata
    payload = {"bins": np.asarray(dj.bins),
               "mappers": [m.to_dict() for m in dj.mappers],
               "used_features": list(dj.used_features),
               "num_data": dj.num_data,
               "num_total_features": dj.num_total_features,
               "feature_names": dj.feature_names, "label": md.label,
               "weight": md.weight,
               "query_boundaries": md.query_boundaries,
               "init_score": md.init_score,
               "monotone_constraints": dj.monotone_constraints}
    path = str(tmp_path / "v1.bin")
    with open(path, "wb") as fh:
        fh.write(b"LGBMTPU1")
        pickle.dump(payload, fh)
    loaded = lt.Dataset(path, params={"device_type": "cpu"}).construct()
    _same_inner(loaded._inner, dj)


def test_loaded_trains_the_same_model(tmp_path):
    path = str(tmp_path / "train.bin")
    p = dict(PARAMS, objective="binary", num_leaves=15, device_type="cpu")
    X, y, _, _ = rows()
    ds = lt.Dataset(X, label=y, categorical_feature=[2], params=dict(p))
    want = lt.train(p, ds, 3).model_to_string()
    ds.save_binary(path)
    loaded = lt.Dataset(path, params={"device_type": "cpu"})
    got = lt.train(p, loaded, 3)
    assert loaded._inner._bins_dev is not None
    assert got.model_to_string() == want


def test_corrupt_cache_refused(tmp_path):
    path = str(tmp_path / "train.bin")
    _dataset(lt, {"device_type": "cpu"}).save_binary(path)
    with open(path, "r+b") as fh:
        fh.seek(100)
        b = fh.read(1)
        fh.seek(100)
        fh.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(CacheError, match="hash mismatch"):
        lt.Dataset(path, params={"device_type": "cpu"}).construct()
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) - 3)
    with pytest.raises(CacheError):
        lt.Dataset(path, params={"device_type": "cpu"}).construct()
