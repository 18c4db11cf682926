"""The port's serving fleet against the JAX package's, on the CPU.

One model, trained by the port, is served from its model text by the JAX
package's ``PredictionService(serve_devices=2, routing="round_robin")`` on
two of the host devices ``tests/conftest.py`` forces, and by the port's
with ``devices=[cpu, cpu]`` (its counterpart of the forced host devices).
The two fleets must route the same requests to the same lanes and answer
within rtol 1e-6, atol 1e-7 (both sum the same float32 leaf values in tree
order), online and through ``predict_bulk``. One service per package for
the module, two buckets each.
"""
import numpy as np
import pytest
import torch

import jax
import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as lt

JAX_TOL = dict(rtol=1e-6, atol=1e-7)
F = 8
KW = dict(max_batch_rows=64, min_bucket_rows=32, max_delay_ms=1.0,
          batch_events=False, routing="round_robin")

pytestmark = pytest.mark.skipif(
    len(jax.local_devices()) < 2,
    reason="needs two host devices (tests/conftest.py forces 8)")


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    rng = np.random.RandomState(0)
    X = rng.rand(400, F).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 1.0).astype(np.float32)
    bst = lt.train({"objective": "binary", "num_leaves": 15,
                    "learning_rate": 0.2, "verbose": -1,
                    "min_data_in_leaf": 5, "device_type": "cpu"},
                   lt.Dataset(X, label=y), 6)
    path = str(tmp_path_factory.mktemp("fleet") / "m.txt")
    bst.save_model(path)
    jsvc = jlgb.serve.PredictionService({"m": path}, serve_devices=2, **KW)
    tsvc = lt.serve.PredictionService(
        {"m": path}, device_type="cpu",
        devices=[torch.device("cpu")] * 2, **KW)
    jsvc.warmup()
    tsvc.warmup()
    yield jsvc, tsvc
    jsvc.close()
    tsvc.close()


def test_fleets_route_alike_and_answer_within_tolerance(fleets):
    jsvc, tsvc = fleets
    assert jsvc.n_devices == tsvc.n_devices == 2
    rng = np.random.RandomState(3)
    for s in (1, 17, 33, 64, 5, 40):
        Xq = rng.rand(s, F).astype(np.float32)
        np.testing.assert_allclose(tsvc.predict("m", Xq),
                                   jsvc.predict("m", Xq), **JAX_TOL)
    jf, tf = jsvc.stats()["fleet"], tsvc.stats()["fleet"]
    assert [e["requests"] for e in tf["per_device"]] \
        == [e["requests"] for e in jf["per_device"]] == [3, 3]
    for e in tf["per_device"]:
        assert e["dispatches_per_request"] == 1.0
        assert e["compiles_per_1k_requests"] == 0.0


def test_predict_bulk_equal_across_packages(fleets):
    jsvc, tsvc = fleets
    X = np.random.RandomState(11).rand(1000, F).astype(np.float32)
    got = tsvc.predict_bulk("m", X)
    np.testing.assert_allclose(got, jsvc.predict_bulk("m", X), **JAX_TOL)
    np.testing.assert_allclose(got, tsvc.predict_bulk("m", X,
                                                      raw_score=False),
                               rtol=0, atol=0)
    assert tsvc.stats()["fleet"]["bulk_rows"] == 2 * X.shape[0]
