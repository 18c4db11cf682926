"""Keys and inputs the port does not honour are refused, never ignored.

The JAX trainer reads the observability keys below
(``lightgbm_tpu/boosting/gbdt.py:460-466, 532, 554-561``). Until the port
has them (ROADMAP Queue A items 10e and 10f), ``train()`` and
``Booster(params=..., train_set=...)`` raise, naming the item. The
checkpoint and host-collective keys of item 10c (``checkpoint_dir``,
``collective_timeout``, ``collective_retries``) are ported: they are
accepted and armed. With a data file the port refuses ``weight_column``,
``group_column`` and ``ignore_column`` (declared in the JAX package's
config and read nowhere there) and a ``header`` its layout scan
contradicts. A text data file itself now loads (``io/file_loader.py``).
Port only, on the CPU, tiny data.
"""
import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import param_default
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
]
# ported in item 10c: (key, a non-default value)
ARMED = [
    ("checkpoint_dir", "ckpt"),
    ("collective_timeout", 30.0),
    ("collective_retries", 5),
]
# refused only with a data file (key, value, what the message says)
FILE_REFUSED = [
    ("weight_column", "1", "sidecar files"),
    ("group_column", "name:q", "sidecar files"),
    ("ignore_column", "0,2", "sidecar files"),
    ("header", True, "contradicts the layout scan"),
]
REFUSED = ([(k, v, "array", "Queue A item 10") for k, v in UNPORTED]
           + [(k, v, "file", m) for k, v, m in FILE_REFUSED])


def _data(n=200, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4)
    return X, (X[:, 0] > 0).astype(float)


def _csv(tmp_path, n=20):
    X, y = _data(n)
    path = tmp_path / "t.csv"
    np.savetxt(path, np.column_stack([y, X]), delimiter=",")
    return str(path)


@pytest.mark.parametrize("key,value,source,match", REFUSED,
                         ids=[k for k, _, _, _ in REFUSED])
def test_unported_key_is_refused(key, value, source, match, tmp_path):
    if source == "file":
        path = _csv(tmp_path)

        def make():
            return lt.Dataset(path)
    else:
        X, y = _data()

        def make():
            return lt.Dataset(X, label=y)
    before = set(tmp_path.iterdir())
    if isinstance(value, str) and source == "array":
        value = str(tmp_path / value)
    params = dict(CPU, objective="binary", num_leaves=4, **{key: value})
    with pytest.raises(LightGBMError, match=match):
        lt.train(params, make(), 1)
    with pytest.raises(LightGBMError, match=key):
        lt.Booster(params=params, train_set=make())
    # nothing was armed: no file or directory appeared
    assert set(tmp_path.iterdir()) == before


@pytest.mark.parametrize("key,value", ARMED, ids=[k for k, _ in ARMED])
def test_resilience_key_is_accepted_and_armed(key, value, tmp_path):
    """The cases ``test_unported_key_is_refused`` had for these keys: each
    trains, and arms what it names (a checkpoint writer that commits; the
    host-collective policy)."""
    from lightgbm_tpu_torch.resilience import checkpoint, comms
    X, y = _data()
    if key == "checkpoint_dir":
        value = str(tmp_path / value)
    params = dict(CPU, objective="binary", num_leaves=4,
                  checkpoint_period=1, **{key: value})
    try:
        bst = lt.train(params, lt.Dataset(X, label=y), 2)
        assert bst.num_trees() == 2
        if key == "checkpoint_dir":
            assert bst._gbdt._ckpt.root == value
            assert checkpoint.select_checkpoint(value, 1).endswith(
                "ckpt_0000000002")
        else:
            assert (comms._TIMEOUT_S, comms._RETRIES) == (
                (30.0, 2) if key == "collective_timeout" else (0.0, 5))
    finally:
        comms.set_collective_policy(0.0, 2)


def test_defaults_and_unarmed_keys_still_train():
    """The defaults, and the keys that arm nothing in the port (memory
    watermarks, the cost ledger, the drift profile), train."""
    X, y = _data()
    params = dict(CPU, objective="binary", num_leaves=4,
                  memory_watermarks=True, cost_ledger="hlo",
                  drift_profile=True,
                  **{k: param_default(k) for k, _ in UNPORTED})
    bst = lt.train(params, lt.Dataset(X, label=y), 2)
    assert bst.num_trees() == 2


def test_text_data_file_loads(tmp_path):
    """The 20-row CSV that was refused constructs, and trains, as the same
    rows in memory do."""
    path = _csv(tmp_path)
    X, y = _data(20)
    params = dict(CPU, objective="binary", num_leaves=4, min_data_in_leaf=2)
    ds = lt.Dataset(path, params=dict(params)).construct()
    assert ds.num_data() == 20 and ds.num_feature() == 4
    np.testing.assert_array_equal(ds.get_label(), y)
    want = lt.train(params, lt.Dataset(X.astype(np.float32), label=y), 2)
    assert lt.train(params, ds, 2).model_to_string() \
        == want.model_to_string()
