"""Binning on the device against ``BinMapper.value_to_bin``.

``binning.values_to_bins`` (one batched ``searchsorted`` over padded
per-column bounds, the missing rules, a sorted category table) bins the
rows of ``Booster.predict`` on the card. Its bins must equal the host's bit
for bit: here, on CPU tensors, against the port's ``value_to_bin`` and the
JAX package's on mappers that both packages build from the same rows
(numerical columns with NaN, zero-as-missing and no missing values, a
categorical column), on random rows and on edge rows: NaN, +-inf, -0.0,
every bin's exact upper bound and its neighbours, unseen, negative,
non-integer and out-of-range categories.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.binning import device_bin_tables, values_to_bins
from lightgbm_tpu_torch.models import predictor as tpred


def _rows(n, seed):
    """Column 0 categorical (codes 0-11 and 40), 1-2 NaN-heavy, 3 mostly
    zeros, 4-5 plain."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[:, 0] = rng.choice(np.r_[np.arange(12), 40], n)
    X[rng.rand(n) < 0.3, 1] = np.nan
    X[rng.rand(n) < 0.3, 2] = np.nan
    X[rng.rand(n) < 0.5, 3] = 0.0
    return X


def _edge_rows(mappers, used):
    """Rows whose every used column takes each edge value in turn."""
    F = max(used) + 1
    vals = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e-36, -1e-36, 1e300,
            -1e300, 2.0 ** 63, -2.0 ** 63, 9.3e18, -1.0, -0.5, 0.5, 2.5,
            11.0, 11.999, 12.0, 40.0, 41.0, 1e9]
    for j in used:
        b = np.asarray(mappers[j].bin_upper_bound, np.float64)
        b = b[np.isfinite(b)]
        vals += list(b) + list(np.nextafter(b, np.inf)) \
            + list(np.nextafter(b, -np.inf))
    return np.tile(np.asarray(vals)[:, None], (1, F))


@pytest.fixture(scope="module", params=[False, True],
                ids=["nan", "zero_as_missing"])
def mappers(request):
    X = _rows(3000, 0)
    y = (np.nan_to_num(X[:, 1]) + X[:, 4] > 0).astype(float)
    p = {"verbose": -1, "zero_as_missing": request.param}
    tds = lt.Dataset(X, label=y, categorical_feature=[0],
                     params=dict(p, device_type="cpu")).construct()._inner
    jds = jlgb.Dataset(X, label=y, categorical_feature=[0],
                       params=p).construct()._inner
    assert tds.used_features == list(jds.used_features)
    return tds, jds


def test_device_bins_equal_value_to_bin(mappers):
    tds, jds = mappers
    used = tds.used_features
    X = np.concatenate([_rows(4000, 1), _edge_rows(tds.mappers, used)])
    tables = device_bin_tables([tds.mappers[j] for j in used], "cpu")
    got = values_to_bins(torch.from_numpy(
        np.ascontiguousarray(X[:, used])), tables).numpy()
    assert got.dtype == np.int32
    for k, j in enumerate(used):
        want_t = tds.mappers[j].value_to_bin(X[:, j])
        want_j = np.asarray(jds.mappers[j].value_to_bin(X[:, j]))
        np.testing.assert_array_equal(want_t, want_j, err_msg=f"col {j}")
        np.testing.assert_array_equal(got[:, k], want_t, err_msg=f"col {j}")
    # the categorical column and both missing rules are covered
    kinds = {(m.bin_type, m.missing_type)
             for m in (tds.mappers[j] for j in used)}
    assert any(b == 1 for b, _ in kinds) and len(kinds) >= 2


def test_predictor_device_encode_equals_host_encode(mappers):
    """The predictor's device form (its used columns, float64, binned by
    the tables) equals its host ``encode`` on rows with extra columns."""
    tds, _ = mappers
    X = np.concatenate([_rows(500, 2), _edge_rows(tds.mappers,
                                                  tds.used_features)])
    p = tpred.DevicePredictor.__new__(tpred.DevicePredictor)
    p.ds = tds
    tables = device_bin_tables([tds.mappers[j] for j in tds.used_features],
                               "cpu")
    got = values_to_bins(torch.from_numpy(p.used_values(X)), tables)
    np.testing.assert_array_equal(got.numpy(), p.encode(X))


def test_values_to_bins_checks_its_input(mappers):
    tds, _ = mappers
    tables = device_bin_tables([tds.mappers[j] for j in tds.used_features],
                               "cpu")
    with pytest.raises(ValueError):
        values_to_bins(torch.zeros((3, tables.width), dtype=torch.float32),
                       tables)
    with pytest.raises(ValueError):
        values_to_bins(torch.zeros((3, tables.width + 1),
                                   dtype=torch.float64), tables)
