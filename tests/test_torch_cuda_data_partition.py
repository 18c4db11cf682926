"""The leaf-wise grower's list kernels on the card (``csrc/
data_partition.cu``: ``leaf_partition``'s two CUDA kernels and
``leaf_hist``) against their plain PyTorch versions, and the leaf-wise
grower on the card through them.

Every test here needs an NVIDIA GPU and skips elsewhere. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_data_partition.py
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops import data_partition as dp
from lightgbm_tpu_torch.ops import fused_level as tfl

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _state(row_leaf, L):
    order = np.argsort(row_leaf, kind="stable").astype(np.int32)
    rows = np.bincount(row_leaf, minlength=L).astype(np.int32)
    begin = np.concatenate([[0], np.cumsum(rows)[:-1]]).astype(np.int32)
    return [torch.as_tensor(a) for a in (order, begin, rows)]


def _one(v, dev="cpu"):
    return torch.tensor([v], dtype=torch.int64, device=dev)


# (rows, share of the rows in the split leaf, Fp, Bk, table: random, all
# left, all right or no split)
PARTITION_CASES = {
    "small": (20_000, 0.15, 28, 64, "random"),
    "large": (1_000_000, 0.5, 28, 64, "random"),
    "one_row": (5_000, 0.0002, 8, 16, "random"),
    "empty": (5_000, 0.0, 8, 16, "random"),
    "all_left": (50_000, 0.3, 8, 16, "left"),
    "all_right": (50_000, 0.3, 8, 16, "right"),
    "bundled": (200_000, 0.4, 96, 300, "random"),
    "no_split": (50_000, 0.3, 8, 16, "no_split"),
}


@pytest.mark.parametrize("case", list(PARTITION_CASES))
def test_leaf_partition_matches_plain(cuda_device, case):
    R, frac, Fp, Bk, kind = PARTITION_CASES[case]
    rng = np.random.RandomState(R % 97)
    leaf, new, L = 1, 3, 4
    row_leaf = np.where(rng.rand(R) < frac, leaf, 0)
    row_leaf[rng.rand(R) < 0.2] = 2
    order, begin, rows = _state(row_leaf, L)
    bins = torch.as_tensor(rng.randint(0, Bk, (R, Fp)).astype(np.int32))
    table = torch.as_tensor(rng.rand(Bk) < 0.45)
    if kind in ("left", "right"):
        table[:] = kind == "left"
    ds = torch.tensor([kind != "no_split"])
    col = _one(Fp // 2)
    want = [t.clone() for t in (order, begin, rows)]
    dp.leaf_partition_plain(want[0], want[1], want[2], _one(leaf),
                            _one(new), ds, bins, col, table)
    outs = []
    for _ in range(2):
        got = [t.to(cuda_device) for t in (order, begin, rows)]
        n0 = dict(dp.launches)
        c0 = dict(dp.cuda_launches)
        dp.leaf_partition(got[0], torch.empty(R, dtype=torch.int32,
                                              device=cuda_device),
                          got[1], got[2], _one(leaf, cuda_device),
                          _one(new, cuda_device), ds.to(cuda_device),
                          bins.to(cuda_device), col.to(cuda_device),
                          table.to(cuda_device))
        torch.cuda.synchronize()
        assert dp.launches["leaf_partition"] - n0["leaf_partition"] == 1
        assert {k: dp.cuda_launches[k] - c0[k]
                for k in dp.PARTITION_KERNELS} == \
            dict.fromkeys(dp.PARTITION_KERNELS, 1)
        outs.append([t.cpu() for t in got])
    for got in outs:                     # integer work: exact, both calls
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    if kind == "no_split":
        assert torch.equal(outs[0][0], order)


# (rows, listed rows of the leaf, Fp, Bk, zero-weight share, flag)
HIST_CASES = {
    "child": (1_000_000, 3_041, 28, 64, 0.0, True),
    "half": (1_000_000, 500_000, 28, 64, 0.3, True),
    "one_row": (10_000, 1, 28, 64, 0.0, True),
    "empty": (10_000, 0, 28, 64, 0.0, True),
    "tiles": (100_000, 20_000, 88, 256, 0.0, True),
    "ragged": (50_000, 7_000, 40, 300, 0.5, True),
    "no_split": (10_000, 2_000, 28, 64, 0.0, False),
    # 14d's widths, 95% of the rows in bin 0 of every column (a bundle
    # column's default bin): one cell takes most of a 60,000-row child
    "one_bin": (200_000, 60_000, 94, 255, 0.0, True),
}


def _hist_case(case):
    """(CPU operands of leaf_hist, Bk) of ``HIST_CASES[case]``."""
    R, n, Fp, Bk, zero, flag = HIST_CASES[case]
    rng = np.random.RandomState(n % 89 + 1)
    leaf, L = 2, 4
    row_leaf = np.zeros(R, np.int64)
    row_leaf[rng.choice(R, n, replace=False)] = leaf
    order, begin, rows = _state(row_leaf, L)
    bins = torch.as_tensor(rng.randint(0, Bk, (R, Fp)).astype(np.int32))
    if case == "one_bin":
        bins[torch.as_tensor(rng.rand(R) < 0.95)] = 0
    bins[torch.as_tensor(rng.rand(R) < 0.01), 0] = Bk   # outside: nothing
    gh = np.stack([rng.randn(R), rng.rand(R) * 0.25, np.ones(R)],
                  1).astype(np.float32)
    gh[rng.rand(R) < zero] = 0.0
    gh = torch.as_tensor(gh)
    ds = torch.tensor([flag])
    return (bins, gh, order, begin, rows, _one(leaf), ds), Bk


@pytest.mark.parametrize("case", list(HIST_CASES))
def test_leaf_hist_matches_plain(cuda_device, case):
    _, n, _, _, _, flag = HIST_CASES[case]
    args, Bk = _hist_case(case)
    want = dp.leaf_hist_plain(*args, num_bins=Bk)
    abs_sum = dp.leaf_hist_plain(args[0], args[1].abs(), *args[2:],
                                 num_bins=Bk)
    dev_args = [a.to(cuda_device) for a in args]
    c0 = dict(dp.cuda_launches)
    got = dp.leaf_hist(*dev_args, num_bins=Bk)
    again = dp.leaf_hist(*dev_args, num_bins=Bk)
    torch.cuda.synchronize()
    assert dp.cuda_launches["leaf_hist"] - c0["leaf_hist"] == 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    got = got.cpu()
    for c in range(2):
        err = float((got[c] - want[c]).abs().max())
        assert err <= 1e-5 * max(float(abs_sum[c].max()), 1e-30), (c, err)
    assert torch.equal(got[2], want[2])
    if not flag or n == 0:
        assert not got.any()


def test_leaf_hist_calls_stand_alone(cuda_device):
    """Every leaf_hist call zeroes its own arrival counters on its stream:
    calls overlapping on two streams, and a call captured in a CUDA graph
    and replayed between eager calls, all give the eager call's bits."""
    args, Bk = _hist_case("tiles")
    dev_args = [a.to(cuda_device) for a in args]
    want = dp.leaf_hist(*dev_args, num_bins=Bk).view(torch.int32)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for k in range(8):
        with torch.cuda.stream(streams[k % 2]):
            outs.append(dp.leaf_hist(*dev_args, num_bins=Bk))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dp.leaf_hist(*dev_args, num_bins=Bk)          # warm-up off-graph
        with torch.cuda.graph(graph, stream=side):
            captured = dp.leaf_hist(*dev_args, num_bins=Bk)
    torch.cuda.synchronize()
    for _ in range(3):
        graph.replay()
        outs.append(dp.leaf_hist(*dev_args, num_bins=Bk))
        torch.cuda.synchronize()
        outs.append(captured.clone())
    for out in outs:
        assert torch.equal(out.view(torch.int32), want)


def test_list_wrappers_on_cuda_never_run_the_plain_version(cuda_device,
                                                          monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain version ran on CUDA tensors")
    monkeypatch.setattr(dp, "leaf_partition_plain", refuse)
    monkeypatch.setattr(dp, "leaf_hist_plain", refuse)
    R, Fp, Bk = 4096, 8, 16
    rng = np.random.RandomState(0)
    order, begin, rows = [t.to(cuda_device) for t in
                          _state(rng.randint(0, 2, R), 4)]
    bins = torch.as_tensor(rng.randint(0, Bk, (R, Fp)).astype(np.int32),
                           device=cuda_device)
    gh = torch.ones(R, 3, device=cuda_device)
    one = torch.ones(1, dtype=torch.bool, device=cuda_device)
    dp.leaf_partition(order, torch.empty_like(order), begin, rows,
                      _one(1, cuda_device), _one(2, cuda_device), one, bins,
                      _one(0, cuda_device),
                      torch.ones(Bk, dtype=torch.bool, device=cuda_device))
    out = dp.leaf_hist(bins, gh, order, begin, rows, _one(1, cuda_device),
                       one, num_bins=Bk)
    torch.cuda.synchronize()
    assert out.is_cuda and float(out[2].sum()) == float(rows[1]) * Fp
    with pytest.raises(ValueError):
        dp.leaf_hist(bins, gh.cpu(), order, begin, rows,
                     _one(1, cuda_device), one, num_bins=Bk)


def test_cuda_leafwise_grower_goes_through_the_list_kernels(cuda_device):
    """Leaf-wise training on the card: each step of each tree launches
    leaf_partition (its two CUDA kernels) and leaf_hist once; the root's
    histogram stays on hist_pass; the trees equal the CPU's and two runs
    give the same model text."""
    rng = np.random.RandomState(5)
    X = rng.randn(20_000, 8)
    X[rng.rand(20_000) < 0.05, 3] = np.nan
    y = (X[:, 0] + 0.5 * np.nan_to_num(X[:, 3]) - 0.3 * X[:, 5]
         + 0.3 * rng.randn(20_000) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
         "min_data_in_leaf": 20, "verbose": -1, "tpu_engine": "xla",
         "bagging_fraction": 0.7, "bagging_freq": 1}
    rounds = 3
    texts, boosters = [], {}
    for dev in ("cuda", "cuda", "cpu"):
        tfl.reset_launch_counts()
        dp.reset_launch_counts()
        bst = lt.train(dict(p, device_type=dev), lt.Dataset(X, label=y),
                       rounds)
        if dev == "cuda":
            texts.append(bst.model_to_string())
            steps = rounds * (p["num_leaves"] - 1)
            assert dp.launches == {"leaf_partition": steps,
                                   "leaf_hist": steps}
            assert dp.cuda_launches == dict.fromkeys(
                dp.PARTITION_KERNELS + dp.LEAF_HIST_KERNELS, steps)
            assert tfl.launches["hist_pass"] == rounds      # the roots
        else:
            assert not any(dp.launches.values())
        boosters[dev] = bst
    assert texts[0] == texts[1]
    bg, bc = boosters["cuda"], boosters["cpu"]
    for a, b in zip(bc.models, bg.models):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold_bin, b.threshold_bin)
    np.testing.assert_allclose(bg.predict(X, raw_score=True),
                               bc.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)
