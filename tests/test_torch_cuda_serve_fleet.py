"""The serving fleet on the card: two lanes on ``cuda:0``.

Each lane of a fleet has its own replica engine, CUDA stream and worker
thread; on one card the replicas hold the base replica's tensors. These
tests hold that, ``predict_bulk`` over the two lanes against
``Booster.predict`` bit for bit (``predict_pass`` sums each row's trees in
tree order whatever rows share its call), and ``ops/predict``'s launch
counters against the lanes' dispatches under two lane threads.

Every test here needs an NVIDIA GPU and skips elsewhere. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_serve_fleet.py
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops import predict as tp
from lightgbm_tpu_torch.serve import PredictionService, ResidencyManager
from lightgbm_tpu_torch.serve.engine import lane_stream

pytestmark = pytest.mark.cuda
F = 8


@pytest.fixture(scope="module")
def bst():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    rng = np.random.RandomState(0)
    X = rng.rand(20_000, F).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 1.0).astype(np.float32)
    return lt.train({"objective": "binary", "num_leaves": 31,
                     "learning_rate": 0.2, "verbose": -1,
                     "min_data_in_leaf": 5},
                    lt.Dataset(X, label=y), 20)


def _lanes():
    return [torch.device("cuda", 0)] * 2


def test_two_lanes_on_one_card_have_distinct_streams(bst):
    dev = torch.device("cuda", 0)
    s0, s1 = lane_stream(dev, 0), lane_stream(dev, 1)
    assert s0 is not s1 and s0.cuda_stream != s1.cuda_stream
    assert lane_stream(dev, 1) is s1


def test_same_card_replica_aliases_and_is_charged_nothing(bst):
    rm = ResidencyManager(devices=_lanes(), max_batch_rows=256,
                          min_bucket_rows=64)
    rm.register("m", bst)
    base, rep = rm.get("m", 0), rm.get("m", 1)
    assert rep.pred is base.pred
    assert all(a is b for a, b in zip(rep._ops, base._ops))
    assert rep._tids is base._tids
    assert rep.packed_nbytes == 0 == rm.resident_bytes_on(1)
    assert base.packed_nbytes >= base.pred.packed_nbytes > 0


def test_predict_bulk_two_lanes_same_bits_as_booster_predict(bst):
    svc = PredictionService({"m": bst}, devices=_lanes(),
                            max_batch_rows=256, min_bucket_rows=64,
                            batch_events=False)
    try:
        svc.warmup()
        X = np.random.RandomState(5).rand(300_000, F).astype(np.float32)
        tp.reset_launch_counts()
        got = svc.predict_bulk("m", X)
        launches = tp.launches["predict_pass"]
        fl = svc.stats()["fleet"]
        # 300,000 rows: chunks of 2 x 65,536, one launch a lane each
        assert fl["bulk_dispatches"] == 3
        assert launches == 2 * fl["bulk_dispatches"]
        want = bst.predict(X.astype(np.float64))
        assert bst._device_predictor is not None
        np.testing.assert_array_equal(got, want)
    finally:
        svc.close()


def test_launch_counters_exact_under_two_lane_threads(bst):
    svc = PredictionService({"m": bst}, devices=_lanes(),
                            max_batch_rows=256, min_bucket_rows=64,
                            max_delay_ms=0.5, batch_events=False)
    try:
        svc.warmup()
        rng = np.random.RandomState(7)
        reqs = [rng.rand(int(s), F).astype(np.float32)
                for s in rng.randint(1, 257, size=400)]
        s0 = svc.stats()
        tp.reset_launch_counts()
        futs = [svc.submit("m", Xq) for Xq in reqs]
        outs = [f.result(timeout=120) for f in futs]
        n = tp.launches["predict_pass"]
        s1 = svc.stats()
        per = s1["fleet"]["per_device"]
        assert all(e["requests"] > 0 for e in per)
        assert n == tp.cuda_launches["predict_pass"] \
            == s1["dispatches"] - s0["dispatches"] \
            == sum(e["dispatches"] for e in per) \
            - sum(e["warmup_dispatches"] for e in per)
        want = bst.predict(np.concatenate(reqs).astype(np.float64))
        np.testing.assert_allclose(np.concatenate(outs), want, rtol=1e-5,
                                   atol=1e-6)
    finally:
        svc.close()
