"""The port's file routing, streamed ingest, sidecar cache and prefetch.

Port only, on the CPU, a few hundred rows, ``num_leaves`` 7, 2 rounds:

- the streamed build (``two_round``, chunks that split the file unevenly)
  gives the monolithic build's bins and mappers, a categorical column
  included, and the streamed, cache-loaded and monolithic models have the
  same text byte for byte;
- a corrupt, truncated or version-mismatched cache is refused;
- the ``save_binary`` sidecar hits (nothing is parsed: the parser's call
  counter stands still), goes stale when the file changes, misses on a
  provenance or categorical change, and a failed write only warns;
- the prefetch on the CPU equals the one-shot widened copy with its
  counters; every dataset, a cache-loaded or an in-memory one, copies its
  bins through it, and ``ingest_prefetch=false`` takes the one-shot copy;
- ``Sequence`` input gives the ndarray's bins;
- Queue C 8 (``importance_type``) and 9 (``free_raw_data``).
"""
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ingest import prefetch as pf
from lightgbm_tpu_torch.io import cache as tcache
from lightgbm_tpu_torch.io.cache import CacheError
from lightgbm_tpu_torch.native import loader as native
from lightgbm_tpu_torch.utils import log

torch.set_num_threads(1)

N = 400
BASE = {"device_type": "cpu", "verbose": -1, "objective": "binary",
        "num_leaves": 7, "min_data_in_leaf": 5, "max_bin": 31}


def _rows(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(N, 5).astype(np.float32)
    X[:, 3] = rng.randint(0, 6, N)
    X[rng.rand(N) < 0.05, 1] = np.nan
    y = (X[:, 0] + 0.1 * X[:, 3] + 0.2 * rng.randn(N) > 0.7).astype(
        np.float32)
    return X, y


def _csv(tmp_path, name="train.csv", seed=0):
    X, y = _rows(seed)
    path = str(tmp_path / name)
    with open(path, "w") as fh:
        for yi, row in zip(y, X):
            fh.write(",".join([f"{yi:g}"] + [
                "" if np.isnan(v) else f"{v:.9g}" for v in row]) + "\n")
    return path


def _text(ds, params=None, rounds=2, importance_type="split"):
    p = dict(BASE, **(params or {}))
    return lt.train(p, ds, rounds).model_to_string(
        importance_type=importance_type)


def _same_bins(a, b):
    np.testing.assert_array_equal(np.asarray(a.bins), np.asarray(b.bins))
    assert np.asarray(a.bins).dtype == np.asarray(b.bins).dtype
    np.testing.assert_equal([m.to_dict() for m in a.mappers],
                            [m.to_dict() for m in b.mappers])
    assert a.used_features == b.used_features


@pytest.mark.parametrize("cats", [None, [3]], ids=["numerical", "categorical"])
def test_streamed_equals_monolithic(tmp_path, cats):
    path = _csv(tmp_path)
    kw = {} if cats is None else {"categorical_feature": cats}
    mono = lt.Dataset(path, params=dict(BASE), **kw).construct()
    streamed = lt.Dataset(path, params=dict(BASE, two_round=True,
                                            ingest_chunk_rows=37),
                          **kw).construct()
    _same_bins(streamed._inner, mono._inner)
    np.testing.assert_array_equal(streamed.get_label(), mono.get_label())
    stats = streamed._inner.ingest_stats
    assert stats["chunks"] == 2 * -(-N // 37) and stats["max_live_chunks"] \
        == 1 and stats["sample_rows"] == N
    assert _text(streamed) == _text(mono)
    # and the same rows as an array
    X, y = _rows()
    assert _text(lt.Dataset(X, label=y, params=dict(BASE), **kw)) \
        == _text(mono)


def test_streamed_cached_and_monolithic_models_are_byte_equal(tmp_path):
    path = _csv(tmp_path)
    np.savetxt(path + ".weight", np.linspace(0.5, 1.5, N), fmt="%.9g")
    want = _text(lt.Dataset(path, params=dict(BASE)))
    # the streamed build writing the sidecar as it goes, then its hit
    sp = dict(BASE, two_round=True, ingest_chunk_rows=64, save_binary=True)
    first = lt.Dataset(path, params=dict(sp)).construct()
    assert first._inner.ingest_stats["source"] == "text+cache"
    assert _text(first) == want
    hit = lt.Dataset(path, params=dict(sp)).construct()
    assert hit._inner.ingest_stats["source"] == "cache"
    np.testing.assert_array_equal(
        hit.get_weight(), np.loadtxt(path + ".weight").astype(np.float32))
    assert _text(hit) == want
    # an explicit cache
    explicit = str(tmp_path / "explicit.bin")
    lt.Dataset(path, params=dict(BASE)).save_binary(explicit)
    assert _text(lt.Dataset(explicit, params=dict(BASE))) == want


def test_bad_caches_are_refused(tmp_path):
    path = str(tmp_path / "c.bin")
    X, y = _rows()
    lt.Dataset(X, label=y, params=dict(BASE)).save_binary(path)
    good = open(path, "rb").read()
    flipped = bytearray(good)
    flipped[100] ^= 0xFF
    cases = {"hash mismatch": bytes(flipped),
             "truncated": good[:-5],
             "too short": good[:10]}
    for what, blob in cases.items():
        with open(path, "wb") as fh:
            fh.write(blob)
        with pytest.raises(CacheError, match=what):
            lt.Dataset(path, params=dict(BASE)).construct()
    w = tcache.CacheWriter(path, 2, 1, [0], np.uint8)
    w.append_rows(np.zeros((2, 1), np.uint8))
    w.finalize({}, extra={"format_version": 3})
    with pytest.raises(CacheError, match="format version 3"):
        lt.Dataset(path, params=dict(BASE)).construct()
    # a writer that overflows or stops short leaves no file
    os.remove(path)
    w = tcache.CacheWriter(path, 2, 1, [0], np.uint8)
    with pytest.raises(CacheError, match="overflow"):
        w.append_rows(np.zeros((3, 1), np.uint8))
    w.abort()
    assert not os.path.exists(path) and os.listdir(tmp_path) == []


def _parses():
    return native.backend["native"] + native.backend["numpy"]


def test_sidecar_cache_hits_and_misses(tmp_path):
    path = _csv(tmp_path)
    sp = dict(BASE, save_binary=True)
    built = lt.Dataset(path, params=dict(sp)).construct()
    assert os.path.exists(path + ".bin")
    n0 = _parses()
    hit = lt.Dataset(path, params=dict(sp)).construct()
    assert _parses() == n0 and hit._inner.ingest_stats["cache_hit"] == 1
    _same_bins(hit._inner, built._inner)
    # a categorical change is a miss (the params digest)
    cat = lt.Dataset(path, params=dict(sp),
                     categorical_feature=[3]).construct()
    assert _parses() > n0 and cat._inner.ingest_stats is None
    assert cat._inner.is_categorical.any()
    # a valid file binned against a reference writes a reference-binned
    # sidecar; standalone it is a miss (provenance), and rebuilt
    vpath = _csv(tmp_path, "valid.csv", seed=1)
    lt.Dataset(vpath, reference=built, params=dict(sp)).construct()
    n1 = _parses()
    again = lt.Dataset(vpath, reference=built, params=dict(sp)).construct()
    assert _parses() == n1 and again._inner.reference_binned
    alone = lt.Dataset(vpath, params=dict(sp)).construct()
    assert _parses() > n1 and not alone._inner.reference_binned
    # the source changes: stale, rebuilt
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    n2 = _parses()
    stale = lt.Dataset(path, params=dict(sp)).construct()
    assert _parses() > n2 and stale._inner.ingest_stats is None
    manifest = tcache.read_manifest(path + ".bin")
    assert manifest["source"]["mtime_ns"] == st.st_mtime_ns + 10**9


@pytest.mark.parametrize("streamed", [False, True], ids=["mono", "streamed"])
def test_failed_cache_write_only_warns(tmp_path, monkeypatch, streamed):
    path = _csv(tmp_path)

    class Full(tcache.CacheWriter):
        def __init__(self, *a, **k):
            raise OSError("No space left on device")
    monkeypatch.setattr(tcache, "CacheWriter", Full)
    said = []
    log.register_logger(said.append)
    try:
        p = dict(BASE, save_binary=True, two_round=streamed)
        ds = lt.Dataset(path, params=p).construct()
    finally:
        log.register_logger(None)
    assert any("binary cache not written" in m for m in said)
    assert not os.path.exists(path + ".bin")
    assert _text(ds) == _text(lt.Dataset(path, params=dict(BASE)))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_prefetch_equals_place(dtype):
    rng = np.random.RandomState(3)
    hi = 256 if dtype == np.uint8 else 65536
    bins = rng.randint(0, hi, (101, 6)).astype(dtype)
    stats = pf.IngestStats(source="prefetch")
    got = pf.stream_to_device(bins, 16, "cpu", stats, trace=True)
    want = torch.from_numpy(bins.astype(np.int16 if dtype == np.uint8
                                        else np.int32))
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert stats.chunks == 7 and stats.rows == 101
    assert 1 <= stats.max_live_chunks <= 2 and stats.live_chunks == 0
    assert [t[2] for t in stats.trace if t[0] == "fill"] == list(range(7))


@pytest.mark.parametrize("source", ["cache", "memory"])
def test_dataset_prefetch_switch(tmp_path, source):
    path = str(tmp_path / "c.bin")
    X, y = _rows()
    lt.Dataset(X, label=y, params=dict(BASE)).save_binary(path)

    def build(**kw):
        if source == "cache":
            return lt.Dataset(path, params=dict(BASE, **kw)).construct()
        return lt.Dataset(X, label=y, params=dict(BASE, **kw)).construct()

    on = build(ingest_chunk_rows=64)
    assert on._inner._bins_dev is None
    dev = on._inner.bins_dev
    assert on._inner.ingest_stats["prefetch"]["chunks"] == -(-N // 64)
    # a row subset keeps its parent's prefetch settings
    sub = on._inner.subset(np.arange(0, N, 3))
    assert torch.equal(sub.bins_dev, dev[::3])
    assert sub.ingest_stats["prefetch"]["chunks"] == -(-len(sub.bins) // 64)
    off = build(ingest_prefetch=False)
    ref = off._inner.bins_dev
    assert "prefetch" not in (off._inner.ingest_stats or {})
    assert torch.equal(dev, ref)


class _Rows(lt.Sequence):
    def __init__(self, X, batch_size):
        self.X, self.batch_size = X, batch_size

    def __len__(self):
        return len(self.X)

    def __getitem__(self, idx):
        return self.X[idx]


def test_sequence_input_gives_the_ndarray_bins():
    X, y = _rows()
    X = X.astype(np.float64)
    want = lt.Dataset(X, label=y, params=dict(BASE)).construct()
    one = lt.Dataset(_Rows(X, 64), label=y, params=dict(BASE)).construct()
    two = lt.Dataset([_Rows(X[:150], 32), _Rows(X[150:], 1000)], label=y,
                     params=dict(BASE)).construct()
    for got in (one, two):
        _same_bins(got._inner, want._inner)
        assert isinstance(got.data, np.ndarray)


def test_importance_type_in_model_text(tmp_path):
    """Queue C 8: ``model_to_string`` and ``save_model`` take
    ``importance_type``; gain writes the gain importances."""
    X, y = _rows()
    bst = lt.train(dict(BASE), lt.Dataset(X, label=y, params=dict(BASE)), 3)
    gain = bst.model_to_string(importance_type="gain")
    assert gain != bst.model_to_string()
    assert bst.model_to_string(importance_type=1) == gain
    out = str(tmp_path / "m.txt")
    bst.save_model(out, importance_type="gain")
    assert open(out).read() == gain
    block = gain.split("feature_importances:\n")[1].split("\n\n")[0]
    got = {ln.split("=")[0]: float(ln.split("=")[1])
           for ln in block.splitlines() if "=" in ln}
    imp = bst.feature_importance("gain")
    for j, name in enumerate(bst.feature_name()):
        if imp[j] > 0:
            assert got[name] == int(imp[j])


def test_free_raw_data_is_taken_and_carried():
    """Queue C 9: ``free_raw_data`` is taken, stored and carried to a
    subset; as in the JAX package nothing is freed."""
    X, y = _rows()
    ds = lt.Dataset(X, label=y, params=dict(BASE),
                    free_raw_data=False).construct()
    assert ds.free_raw_data is False and ds.data is X
    sub = ds.subset(np.arange(0, N, 2))
    assert sub.free_raw_data is False
    assert lt.Dataset(X, label=y).free_raw_data is True
    assert sub.num_data() == N // 2
