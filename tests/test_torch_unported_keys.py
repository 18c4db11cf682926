"""Keys and inputs the port does not honour yet are refused, never ignored.

The JAX trainer reads the observability and checkpoint keys below
(``lightgbm_tpu/boosting/gbdt.py:460-466, 532, 554-561, 1109-1111``) and
loads text data files (``lightgbm_tpu/io/file_loader.py``). Until the port
has them (ROADMAP Queue A item 10), ``train()``, ``Booster(params=...,
train_set=...)`` and ``Dataset(<path>)`` raise, naming that item. Port
only, on the CPU, tiny data.
"""
import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.utils.log import LightGBMError

CPU = {"device_type": "cpu", "verbose": -1}

# (key, a non-default value)
UNPORTED = [
    ("telemetry_out", "telemetry.jsonl"),
    ("trace_out", "trace.json"),
    ("health_check_period", 1),
    ("metrics_port", 9100),
    ("run_report_out", "report.json"),
    ("profile_dir", "profile"),
    ("perf_db", "perf.db"),
    ("slo_enabled", True),
    ("slo_config", "p99_ms=5"),
    ("checkpoint_dir", "ckpt"),
]


def _data(n=200, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4)
    return X, (X[:, 0] > 0).astype(float)


@pytest.mark.parametrize("key,value", UNPORTED,
                         ids=[k for k, _ in UNPORTED])
def test_unported_key_is_refused(key, value, tmp_path):
    X, y = _data()
    if isinstance(value, str):
        value = str(tmp_path / value)
    params = dict(CPU, objective="binary", num_leaves=4, **{key: value})
    with pytest.raises(LightGBMError, match="Queue A item 10"):
        lt.train(params, lt.Dataset(X, label=y), 1)
    with pytest.raises(LightGBMError, match=key):
        lt.Booster(params=params, train_set=lt.Dataset(X, label=y))
    # nothing was armed: no file or directory appeared
    assert list(tmp_path.iterdir()) == []


def test_defaults_and_unarmed_keys_still_train():
    """The defaults, and the keys that arm nothing in the port (memory
    watermarks, the cost ledger, the drift profile), train."""
    X, y = _data()
    params = dict(CPU, objective="binary", num_leaves=4,
                  memory_watermarks=True, cost_ledger="hlo",
                  drift_profile=True,
                  **{k: type(v)() for k, v in UNPORTED})
    bst = lt.train(params, lt.Dataset(X, label=y), 2)
    assert bst.num_trees() == 2


def test_text_data_file_is_refused(tmp_path):
    """A path that is not a binary dataset cache names the file loader's
    item, not a "not a binary dataset file" error."""
    X, y = _data(20)
    path = tmp_path / "t.csv"
    np.savetxt(path, np.column_stack([y, X]), delimiter=",")
    with pytest.raises(LightGBMError, match="Queue A item 10") as err:
        lt.Dataset(str(path), params=CPU).construct()
    assert "not a lightgbm_tpu binary" not in str(err.value)
