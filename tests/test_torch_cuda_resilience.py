"""Checkpoints and resume on the card (``lightgbm_tpu_torch/resilience/``).

- Train straight through against train, stop and resume gives byte-equal
  model text on the megastep body, the epilogue body (its resume drops the
  carried root histogram, and the first resumed tree takes its root from
  ``level_pass``'s path instead of ``epilogue_pass``'s tiles) and the
  synchronous body (GOSS, DART), at small shapes;
- ``capture`` hands the writer numpy arrays and a JSON payload only: no
  torch tensor, on the card or off it, is referenced by the job;
- the writer thread commits a checkpoint while the training thread runs
  the next iteration.

Every test here needs an NVIDIA GPU and skips elsewhere. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_resilience.py
"""
import json
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.resilience import checkpoint as ckpt_mod
from lightgbm_tpu_torch.resilience import state as rstate

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the fused kernels run on the card)")
    return "cuda"


def _data(n=20_000, f=10, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    y = (X[:, 0] + X[:, 1] + 0.3 * rng.randn(n) > 1).astype(np.float32)
    return X, y


BASE = {"objective": "binary", "num_leaves": 31, "verbose": -1,
        "min_data_in_leaf": 5, "bagging_fraction": 0.7, "bagging_freq": 1,
        "feature_fraction": 0.8}
CASES = {
    "megastep": {},
    "epilogue": {"tpu_megastep": False},
    "goss": {"boosting": "goss", "learning_rate": 0.2, "bagging_freq": 0},
    "dart": {"boosting": "dart", "drop_rate": 0.5},
}


def _train(params, X, y, rounds, resume=None):
    return lt.train(dict(params), lt.Dataset(X, label=y), rounds,
                    resume_from=resume)


@pytest.mark.parametrize("case", list(CASES))
def test_resume_identity_on_the_card(case, cuda_device, tmp_path):
    ck = str(tmp_path / "ck")
    params = dict(BASE, device_type=cuda_device, checkpoint_dir=ck,
                  checkpoint_period=3, **CASES[case])
    X, y = _data()
    ref = _train(params, X, y, 10).model_to_string(num_iteration=-1)
    shutil.rmtree(ck)
    _train(params, X, y, 6)
    got = _train(params, X, y, 10, resume=ck)
    assert got.model_to_string(num_iteration=-1) == ref


def _tensors(obj):
    """Every torch tensor reachable from ``obj`` through containers."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    return []


def test_capture_hands_the_writer_numpy_only(cuda_device, tmp_path):
    X, y = _data()
    rec = {}
    ds = lt.Dataset(X, label=y)
    bst = lt.train(dict(BASE, device_type=cuda_device,
                        tpu_gain_screening=True,
                        checkpoint_dir=str(tmp_path / "ck"),
                        checkpoint_period=2), ds, 4,
                   valid_sets=[lt.Dataset(X[:2000], label=y[:2000],
                                          reference=ds)],
                   callbacks=[lt.record_evaluation(rec)])
    gb = bst._gbdt
    assert gb.scores.is_cuda
    payload, arrays = rstate.capture(gb)
    assert not _tensors(payload) and not _tensors(arrays)
    assert all(type(a) is np.ndarray for a in arrays.values())
    json.dumps(payload)
    # the copies own their memory: a later in-place update is not seen
    before = arrays["scores"].copy()
    gb.scores += 1.0
    np.testing.assert_array_equal(arrays["scores"], before)
    assert {"scores", "vscore0", "bag_weight", "gain_ema"} <= set(arrays)


def test_writer_commits_while_the_next_iteration_runs(cuda_device, tmp_path,
                                                      monkeypatch):
    spans = {"write": [], "iter": []}
    real_write = ckpt_mod.CheckpointManager._write

    def slow_write(self, *a):
        t0 = time.perf_counter()
        assert threading.current_thread().name.startswith("ckpt-writer")
        time.sleep(0.3)
        real_write(self, *a)
        spans["write"].append((t0, time.perf_counter()))
    monkeypatch.setattr(ckpt_mod.CheckpointManager, "_write", slow_write)
    X, y = _data()
    bst = lt.Booster(params=dict(BASE, device_type=cuda_device,
                                 checkpoint_dir=str(tmp_path / "ck"),
                                 checkpoint_period=2),
                     train_set=lt.Dataset(X, label=y))
    for _ in range(6):
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        spans["iter"].append((t0, time.perf_counter()))
        bst._gbdt.maybe_checkpoint()
    bst._gbdt.wait_checkpoints()
    assert len(spans["write"]) == 3
    assert ckpt_mod.select_checkpoint(str(tmp_path / "ck"), 1) \
        .endswith("ckpt_0000000006")
    # an iteration ran on the training thread inside a write's span
    assert any(w0 < i0 < w1 for w0, w1 in spans["write"]
               for i0, _ in spans["iter"])
