"""Distributed training on the card: two port ranks on ``cuda:0`` over
gloo (NCCL refuses two ranks on one device).

Every test here needs an NVIDIA GPU and skips elsewhere. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_distributed.py

- ``record_psum`` / ``record_pmax`` on CUDA tensors (a bool goes over as
  int32 and comes back bool);
- a small 16-bit quantized data-parallel run is the serial run, bit for
  bit (int32 histogram sums do not depend on order).
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.parallel.spawn import run_ranks

import torch_dist_ranks as tdr

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the ranks train on the card)")
    from lightgbm_tpu_torch.ops import cuda_build
    cuda_build.library()          # built once here, loaded by the ranks
    return torch.device("cuda")


def test_collectives_on_cuda_tensors(cuda_device, tmp_path):
    res = run_ranks(tdr.__file__ + ":cuda_collective_rank", 2,
                    workdir=str(tmp_path), device_type="cuda",
                    backend="gloo", deadline_s=180)
    x = np.arange(6, dtype=np.float32)
    for r in res:
        assert r["cuda"] and r["count"] == 3
        np.testing.assert_array_equal(r["sum"], 3 * x)
        np.testing.assert_array_equal(r["max"], 2 * x)
        np.testing.assert_array_equal(r["bool"], [True, False, True])


def test_quantized_data_parallel_is_the_serial_run(cuda_device, tmp_path):
    params = {"objective": "binary", "num_leaves": 31, "verbose": -1,
              "min_data_in_leaf": 5, "tpu_quantized_grad": 16}
    res = run_ranks(tdr.__file__ + ":cuda_train_rank", 2,
                    (dict(params, tree_learner="data"), 5),
                    workdir=str(tmp_path), device_type="cuda",
                    backend="gloo", deadline_s=300)
    assert res[0]["text"] == res[1]["text"]
    X, y = tdr.train_data()
    serial = lt.train(dict(params, device_type="cuda"),
                      lt.Dataset(X, label=y), 5)
    assert len(res[0]["models"]) == len(serial.models) == 5
    for a, b in zip(res[0]["models"], serial.models):
        for k in ("split_feature", "threshold", "left_child", "right_child",
                  "leaf_count", "leaf_value"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
