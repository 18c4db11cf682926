"""lightgbm_tpu_torch on the card: the CUDA kernels against their plain
PyTorch versions, and CUDA training against CPU training.

Every test here needs an NVIDIA GPU and skips elsewhere. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops import fused_level as tfl
from lightgbm_tpu_torch.ops.layout import feature_layout

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _operands(R, F, B, nch, seed):
    """Random level operands: rows in leaves 0..2, three active slots on
    features with no, zero and NaN missing types, five inactive slots."""
    rng = np.random.RandomState(seed)
    nb = np.array([B, B - 3, B, 7, B], np.int32)[:F]
    mt = np.array([0, 1, 2, 0, 2], np.int32)[:F]
    db = np.array([0, 4, 0, 0, 0], np.int32)[:F]
    bins = np.stack([rng.randint(0, nb[f], size=R) for f in range(F)])
    F_oh, _ = feature_layout(F, B)
    bins_T = np.zeros((max(F_oh, 8), R), np.int64)
    bins_T[:F] = bins
    t = torch.as_tensor
    dt = torch.int8 if B <= 128 else torch.int16
    leaf = t(rng.randint(0, 3, R).astype(np.int32)[None, :])
    gh = tfl.pack_gh(t(rng.randn(R).astype(np.float32)),
                     t(rng.rand(R).astype(np.float32)),
                     torch.ones(R), nch)
    feat = t(np.array([1, 2, 3, -1, -1, -1, -1, -1], np.int32))
    thr = t(np.array([5, 7, 2, 0, 0, 0, 0, 0], np.int32))
    dl = t(np.array([1, 0, 1, 0, 0, 0, 0, 0], bool))
    W = tfl.build_route_table(feat, thr, dl, t(nb), t(mt), t(db), 8, F_oh, B)
    tbl = np.zeros((8, 128), np.int32)
    tbl[:, 0] = [0, 1, 2, -2, -2, -2, -2, -2]
    tbl[:3, 1] = 3
    tbl[:3, 2] = [1, 0, 1]
    return (t(bins_T).to(dt), leaf, gh, W, t(tbl)), F_oh


@pytest.mark.parametrize("nch,B", [(5, 16), (3, 16), (5, 256)])
def test_kernels_match_plain(cuda_device, nch, B):
    ops, F_oh = _operands(4096, 5, B, nch, seed=B + nch)
    ops_c = [a.to(cuda_device) for a in ops]
    bins, leaf, gh, W, tbl = ops
    n0 = dict(tfl.launches)
    hist_c, leaf_c = tfl.level_pass(*ops_c, num_bins=B, f_oh=F_oh, nch=nch)
    route_c = tfl.route_pass(ops_c[0], ops_c[1], ops_c[3], ops_c[4],
                             num_bins=B, f_oh=F_oh)
    table = torch.randn(3, generator=torch.Generator().manual_seed(0))
    look_c = tfl.table_lookup(leaf_c, table.to(cuda_device))
    torch.cuda.synchronize()
    hist_p, leaf_p = tfl.level_pass_plain(*ops, num_bins=B, f_oh=F_oh,
                                          nch=nch)
    assert {k: tfl.launches[k] - n0[k] for k in n0} == \
        {"level_pass": 1, "route_pass": 1, "table_lookup": 1}
    assert torch.equal(leaf_c.cpu(), leaf_p)
    assert torch.equal(route_c.cpu(), leaf_p)
    assert torch.equal(look_c.cpu(), tfl.table_lookup_plain(leaf_p, table))
    # atomics reorder the f32 sums; the weight channel counts rows exactly
    np.testing.assert_allclose(hist_c.cpu().numpy(), hist_p.numpy(),
                               rtol=1e-5, atol=1e-5)
    w = slice((nch - 1) * 8, nch * 8)
    assert torch.equal(hist_c[:, w].cpu(), hist_p[:, w])


def test_wrappers_refuse_mixed_devices(cuda_device):
    ops, F_oh = _operands(1024, 5, 16, 5, seed=0)
    bins, leaf, gh, W, tbl = ops
    with pytest.raises(ValueError):
        tfl.level_pass(bins.to(cuda_device), leaf, gh, W, tbl, num_bins=16,
                       f_oh=F_oh)


def test_cuda_training_matches_cpu(cuda_device):
    rng = np.random.RandomState(0)
    X = rng.randn(5000, 8)
    X[rng.rand(5000) < 0.05, 2] = np.nan
    y = (X[:, 0] + 0.5 * np.nan_to_num(X[:, 2]) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
         "verbose": -1}
    bc = lt.train(dict(p, device_type="cpu"), lt.Dataset(X, label=y), 3)
    tfl.reset_launch_counts()
    bg = lt.train(dict(p, device_type="cuda"), lt.Dataset(X, label=y), 3)
    assert all(n > 0 for n in tfl.launches.values())
    for a, b in zip(bc.models, bg.models):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold_bin, b.threshold_bin)
    np.testing.assert_allclose(bg.predict(X, raw_score=True),
                               bc.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)
