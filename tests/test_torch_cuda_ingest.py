"""The bins' chunked prefetch to the card (``ingest/prefetch.py``).

On the card ``stream_to_device`` must give the one-shot widened copy's
tensor (``torch.equal``) at a chunk size that splits the matrix unevenly,
for uint8 and uint16 bins; its staging buffers are pinned and its copies
run on a side stream; and a chunk's staging buffer is refilled only after
the event of that buffer's previous chunk was waited on (the host trace of
fills and waits). A CSV loaded through ``save_binary``, and an array in
memory, reach the card through it; ``ingest_prefetch=false`` copies in one
shot.

Every test here needs an NVIDIA GPU and skips elsewhere. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_ingest.py
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ingest import prefetch as pf

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the prefetch copies to the card)")
    return torch.device("cuda")


def _place(bins, device):
    wide = np.int16 if bins.dtype == np.uint8 else np.int32
    return torch.from_numpy(bins.astype(wide)).to(device)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("rows,chunk", [(100_003, 4096), (1_000, 7),
                                        (50, 64)])
def test_prefetch_equals_place(cuda_device, dtype, rows, chunk):
    rng = np.random.RandomState(rows)
    hi = 256 if dtype == np.uint8 else 65536
    bins = rng.randint(0, hi, (rows, 28)).astype(dtype)
    stats = pf.IngestStats(source="prefetch")
    got = pf.stream_to_device(bins, chunk, cuda_device, stats, trace=True)
    torch.cuda.synchronize()
    want = _place(bins, cuda_device)
    assert got.dtype == want.dtype and got.is_cuda
    assert torch.equal(got, want)
    n_chunks = -(-rows // chunk)
    assert stats.chunks == n_chunks and stats.rows == rows
    assert stats.pinned and stats.side_stream
    assert 1 <= stats.max_live_chunks <= 2 and stats.live_chunks == 0
    # every refill of a buffer comes after the wait on its previous chunk
    done = set()
    for op, buf, i in stats.trace:
        if op == "wait":
            done.add(i)
        elif i >= 2:
            assert i - 2 in done, (buf, i)


def test_csv_cache_reaches_the_card_through_the_prefetch(cuda_device,
                                                         tmp_path):
    rng = np.random.RandomState(0)
    X = rng.rand(5000, 6).astype(np.float32)
    y = (X[:, 0] > 0.5).astype(np.float32)
    path = str(tmp_path / "t.csv")
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.9g")
    p = {"objective": "binary", "num_leaves": 7, "verbose": -1,
         "save_binary": True, "ingest_chunk_rows": 999}
    lt.Dataset(path, params=dict(p)).construct()
    ds = lt.Dataset(path, params=dict(p)).construct()
    inner = ds._inner
    assert inner.ingest_stats["cache_hit"] == 1 and inner._bins_dev is None
    got = inner.bins_dev
    assert torch.equal(got, _place(np.asarray(inner.bins), cuda_device))
    pre = inner.ingest_stats["prefetch"]
    assert pre["chunks"] == 6 and pre["pinned"] and pre["max_live_chunks"] <= 2
    bst = lt.train(dict(p), ds, 3)
    assert bst.num_trees() == 3


def test_array_dataset_reaches_the_card_through_the_prefetch(cuda_device):
    rng = np.random.RandomState(1)
    X = rng.rand(3001, 5).astype(np.float32)
    y = (X[:, 1] > 0.5).astype(np.float32)
    p = {"objective": "binary", "num_leaves": 7, "verbose": -1,
         "ingest_chunk_rows": 1000}
    on = lt.Dataset(X, label=y, params=dict(p)).construct()._inner
    assert on._bins_dev is None and on.ingest_stats is None
    got = on.bins_dev
    assert got.is_cuda and torch.equal(got, _place(on.bins, cuda_device))
    pre = on.ingest_stats["prefetch"]
    assert pre["chunks"] == 4 and pre["pinned"] and pre["side_stream"]
    off = lt.Dataset(X, label=y, params=dict(p, ingest_prefetch=False)
                     ).construct()._inner
    assert torch.equal(off.bins_dev, got) and off.ingest_stats is None
