"""Text data files: the port's parser and loader against the JAX package's.

The same small files, made from a seed with numpy, go through
``lightgbm_tpu_torch.io.file_loader.load_text_file`` and
``lightgbm_tpu_torch.ingest.chunker`` (``scan_layout``, ``iter_chunks``)
and through ``lightgbm_tpu.io.file_loader`` / ``lightgbm_tpu.ingest.
chunker``; parsed values, labels and sidecars are equal bit for bit. The
files cover CSV and TSV with and without a header, LibSVM, ``label_column``
as an index, as ``name:`` and as -1, whitespace-only and ``#`` comment
lines, empty and NA fields, every sidecar (``.weight``, ``.query``,
``.group``, ``.init``), query-aligned rank slices and slices clamped where
there are more ranks than rows. The port's numpy fallback parser is held
to its native one, and ``Dataset``'s reading of the ``label`` alias is
pinned against the JAX package's. No training; a few hundred rows.
"""
import os

import numpy as np
import pytest

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.ingest import chunker as jchunk
from lightgbm_tpu.io import file_loader as jfl
from lightgbm_tpu_torch.ingest import chunker as tchunk
from lightgbm_tpu_torch.io import file_loader as tfl
from lightgbm_tpu_torch.native import loader as tnative

N, F = 120, 4


def _bits_equal(a, b):
    """Equal arrays, float32 compared by their bits (NaNs included)."""
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype == np.float32:
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    else:
        np.testing.assert_array_equal(a, b)


def _dense_file(tmp_path, sep, header, seed=0, junk=True):
    """A dense file of N rows x (label + F columns): NaN, empty and NA
    fields, negative and integer values, with (``junk``) a comment line, a
    whitespace-only line (a data row of NaNs to every parser) and CRLF."""
    rng = np.random.RandomState(seed)
    X = rng.randn(N, F).astype(np.float32)
    X[:, 2] = rng.randint(0, 5, N)
    y = (rng.rand(N) > 0.5).astype(np.float32)
    lines = []
    if header:
        lines.append(sep.join(["y"] + [f"c{j}" for j in range(F)]))
    for i in range(N):
        fields = [repr(float(y[i]))] + [f"{v:.9g}" for v in X[i]]
        if i % 17 == 3:
            fields[1] = ""
        if i % 23 == 5:
            fields[2] = "NA"
        if i % 29 == 7:
            fields[3] = "nan"
        lines.append(sep.join(fields))
    if junk:
        lines.insert(5, "# a comment line")
        lines.insert(9, "   ")
        lines[12] = lines[12] + "\r"
    ext = "tsv" if sep == "\t" else "csv"
    path = str(tmp_path / f"data_{int(header)}.{ext}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def _libsvm_file(tmp_path, seed=1):
    rng = np.random.RandomState(seed)
    lines = ["# libsvm"]
    for i in range(N):
        cols = sorted(rng.choice(7, size=rng.randint(1, 6), replace=False))
        toks = [f"{rng.randint(0, 3)}"] + [
            f"{c}:{rng.randn():.7g}" for c in cols]
        lines.append(" ".join(toks))
    path = str(tmp_path / "data.svm")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def _sidecars(path, rows, query_suffix=".query", seed=2):
    rng = np.random.RandomState(seed)
    np.savetxt(path + ".weight", rng.rand(rows) + 0.5, fmt="%.9g")
    np.savetxt(path + ".init", rng.randn(rows), fmt="%.9g")
    sizes, left = [], rows
    while left > 0:
        s = min(left, int(rng.randint(1, 15)))
        sizes.append(s)
        left -= s
    np.savetxt(path + query_suffix, np.array(sizes), fmt="%d")
    return np.array(sizes)


def _same_load(path, **kw):
    got = tfl.load_text_file(path, **kw)
    want = jfl.load_text_file(path, **kw)
    _bits_equal(got[0], want[0])
    _bits_equal(got[1], want[1])
    assert sorted(got[2]) == sorted(want[2])
    for k in got[2]:
        _bits_equal(got[2][k], want[2][k])
    return got


def _same_layout(path):
    a, b = tchunk.scan_layout(path), jchunk.scan_layout(path)
    for k in ("sep", "n_rows", "n_cols", "is_libsvm", "has_header",
              "header_names"):
        assert getattr(a, k) == getattr(b, k), k
    return a, b


DENSE = [(",", False), (",", True), ("\t", False), ("\t", True)]


@pytest.mark.parametrize("sep,header", DENSE,
                         ids=["csv", "csv_header", "tsv", "tsv_header"])
@pytest.mark.parametrize("label_column", [None, "2", -1, "name:c1"],
                         ids=["default", "index", "none", "name"])
def test_dense_files_parse_as_the_jax_package(tmp_path, sep, header,
                                              label_column):
    path = _dense_file(tmp_path, sep, header)
    a, b = _same_layout(path)
    assert a.n_rows == N + 1          # the whitespace-only line is a row
    if label_column == "name:c1" and not header:
        with pytest.raises(ValueError, match="not in header"):
            tfl.load_text_file(path, label_column=label_column)
        return
    X, y, side = _same_load(path, label_column=label_column)
    assert side == {}
    assert X.shape[1] == (F + 1 if label_column == -1 else F)
    assert (y is None) == (label_column == -1)
    for start, stop, rows in ((0, None, 16), (7, 50, 11), (40, 41, 5)):
        got = list(tchunk.iter_chunks(a, rows, start, stop))
        want = list(jchunk.iter_chunks(b, rows, start, stop))
        assert [g[0] for g in got] == [w[0] for w in want]
        for g, w in zip(got, want):
            _bits_equal(g[1], w[1])
        assert tchunk.slice_start_offset(a, start) \
            == jchunk.slice_start_offset(b, start)


def test_libsvm_and_every_sidecar(tmp_path):
    path = _libsvm_file(tmp_path)
    a, b = _same_layout(path)
    assert a.is_libsvm
    sizes = _sidecars(path, N)
    X, y, side = _same_load(path)
    assert sorted(side) == ["group", "init_score", "weight"]
    np.testing.assert_array_equal(side["group"], sizes)
    got = list(tchunk.iter_chunks(a, 32, 10, 90))
    want = list(jchunk.iter_chunks(b, 32, 10, 90))
    for g, w in zip(got, want):
        _bits_equal(g[1], w[1])
        _bits_equal(g[2], w[2])
    # a .group sidecar reads as a .query one
    os.rename(path + ".query", path + ".group")
    _same_load(path)


@pytest.mark.parametrize("world", [2, 3])
def test_query_aligned_rank_slices(tmp_path, world):
    path = _dense_file(tmp_path, ",", False, junk=False)
    sizes = _sidecars(path, N)
    ends = np.cumsum(sizes)
    covered = 0
    for r in range(world):
        sl = tfl.compute_rank_slice(path, N, r, world)
        assert sl == jfl.compute_rank_slice(path, N, r, world)
        assert sl.start == covered and (sl.start == 0 or sl.start in ends)
        covered = sl.stop
        X, y, side = _same_load(path, rank=r, num_machines=world)
        assert X.shape[0] == sl.stop - sl.start
        assert int(side["group"].sum()) == X.shape[0]
    assert covered == N


def test_contiguous_and_clamped_rank_slices(tmp_path):
    path = _dense_file(tmp_path, "\t", True, junk=False)
    for world in (2, 7):
        for r in range(world):
            _same_load(path, rank=r, num_machines=world)
    few = str(tmp_path / "few.csv")
    np.savetxt(few, np.arange(15, dtype=np.float64).reshape(5, 3),
               delimiter=",", fmt="%g")
    for r in range(8):
        sl = tfl.compute_rank_slice(few, 5, r, 8)
        assert sl == jfl.compute_rank_slice(few, 5, r, 8)
        assert 0 <= sl.start <= sl.stop <= 5
        X, _, _ = _same_load(few, rank=r, num_machines=8)
        assert X.shape == (sl.stop - sl.start, 2)


def test_numpy_fallback_matches_native(tmp_path, monkeypatch):
    paths = [_dense_file(tmp_path, ",", True),
             _dense_file(tmp_path, "\t", False), _libsvm_file(tmp_path)]
    native = [tfl.load_text_file(p) for p in paths]
    native_chunks = [list(tchunk.iter_chunks(tchunk.scan_layout(p), 13, 3))
                     for p in paths]
    assert tnative.get_lib() is not None
    before = dict(tnative.backend)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    for p, (X, y, _), chunks in zip(paths, native, native_chunks):
        Xf, yf, _ = tfl.load_text_file(p)
        np.testing.assert_array_equal(Xf, X)
        np.testing.assert_array_equal(yf, y)
        for g, w in zip(tchunk.iter_chunks(tchunk.scan_layout(p), 13, 3),
                        chunks):
            assert g[0] == w[0]
            np.testing.assert_array_equal(g[1], w[1])
            np.testing.assert_array_equal(g[2], w[2])
    assert tnative.backend["numpy"] > before["numpy"]
    assert tnative.backend["native"] == before["native"]


def test_label_alias_is_not_read_on_the_file_path(tmp_path):
    """Both packages read the raw ``label_column`` key on the file path
    (lightgbm_tpu/basic.py:455,480): the alias ``label`` in the params
    leaves column 0 the label, and ``label_column`` moves it."""
    path = _dense_file(tmp_path, ",", False, junk=False)
    data = tfl.load_text_file(path, label_column=-1)[0]
    for params, col in (({"label": "2"}, 0), ({"label_column": "2"}, 2)):
        pt = lt.Dataset(path, params=dict(params, device_type="cpu",
                                          verbose=-1)).construct()
        pj = lj.Dataset(path, params=dict(params, verbose=-1)).construct()
        _bits_equal(pt.get_label(), pj.get_label())
        np.testing.assert_array_equal(pt.get_label(), data[:, col])
        np.testing.assert_array_equal(pt._inner.bins, pj._inner.bins)
