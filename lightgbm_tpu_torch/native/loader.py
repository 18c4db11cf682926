"""ctypes bridge to the native text parser (``parser.cpp``).

PyTorch-port counterpart of ``lightgbm_tpu/native/loader.py``. The parser
source is a byte-for-byte copy of the JAX package's, so the two packages
parse every field the same way. It is compiled with ``g++`` at first use
into ``lightgbm_tpu_torch/_build/parser-<hash>/libparser.so``, keyed by a
hash of the source and the flags (as ``ops/cuda_build.py`` keys the
kernels' library), and never beside the source. A build goes to a temporary
file that is renamed into place, so a concurrent process never loads half a
library.

Without a compiler the same entry points run numpy parsers with the same
line and field rules (the JAX package's fallbacks). Which parser ran is
logged once and counted per call in :data:`backend`
(``{"native": n, "numpy": m}``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..utils import log

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "parser.cpp"
BUILD_ROOT = _HERE.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

# calls served by each parser (the chip smoke test asserts the native one)
backend = {"native": 0, "numpy": 0}
build_info: dict = {}


def source_hash() -> str:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``parser.cpp`` if this source hash has no library yet;
    returns its path. Raises when ``g++`` fails or is missing."""
    out_dir = BUILD_ROOT / f"parser-{source_hash()}"
    lib = out_dir / "libparser.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".libparser.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        r = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                           capture_output=True, text=True, timeout=180)
        if r.returncode != 0:
            raise RuntimeError(r.stderr[-300:])
        os.replace(tmp, lib)
    finally:
        if tmp.exists():
            tmp.unlink()
    return lib


def _bind(lib: ctypes.CDLL) -> None:
    c = ctypes
    fp = c.POINTER(c.c_float)
    i64p = c.POINTER(c.c_int64)
    sigs = {
        "lgbt_scan": [c.c_char_p, c.POINTER(c.c_char), i64p, i64p,
                      c.POINTER(c.c_int), c.POINTER(c.c_int)],
        "lgbt_parse_dense": [c.c_char_p, c.c_char, c.c_int, fp, c.c_int64,
                             c.c_int64],
        "lgbt_parse_libsvm": [c.c_char_p, fp, fp, c.c_int64, c.c_int64],
        "lgbt_parse_dense_range": [c.c_char_p, c.c_char, c.c_int,
                                   c.c_int64, fp, c.c_int64, c.c_int64,
                                   i64p, i64p],
        "lgbt_parse_libsvm_range": [c.c_char_p, c.c_int64, fp, fp,
                                    c.c_int64, c.c_int64, i64p, i64p],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = c.c_int


def get_lib() -> Optional[ctypes.CDLL]:
    """The native parser, built and loaded on first call; None (logged
    once) where it cannot be built."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            path = build()
            lib = ctypes.CDLL(str(path))
            _bind(lib)
        except Exception as e:  # no toolchain, or a read-only package dir
            log.warning("native parser build failed (%s); using the slower "
                        "numpy text parser", e)
            build_info["error"] = str(e)
            return None
        build_info["path"] = str(path)
        log.info("native text parser: %s", path)
        _LIB = lib
        return _LIB


def _lib_for_call() -> Optional[ctypes.CDLL]:
    lib = get_lib()
    backend["native" if lib is not None else "numpy"] += 1
    return lib


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def scan(path: str) -> Tuple[str, int, int, bool, bool]:
    """(sep, n_rows, n_cols, is_libsvm, has_header) for a text file."""
    lib = _lib_for_call()
    if lib is None:
        return _scan_numpy(path)
    sep = ctypes.c_char(b",")
    rows, cols = ctypes.c_int64(0), ctypes.c_int64(0)
    is_svm, header = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.lgbt_scan(path.encode(), ctypes.byref(sep), ctypes.byref(rows),
                       ctypes.byref(cols), ctypes.byref(is_svm),
                       ctypes.byref(header))
    if rc != 0:
        raise IOError(f"cannot scan {path} (rc={rc})")
    return (sep.value.decode(), rows.value, cols.value, bool(is_svm.value),
            bool(header.value))


def parse_dense(path: str, sep: str, has_header: bool, n_rows: int,
                n_cols: int) -> np.ndarray:
    """[n_rows, n_cols] float32; empty and NA fields are NaN."""
    lib = _lib_for_call()
    if lib is None:
        return _parse_dense_numpy(path, sep, has_header, n_rows, n_cols)
    out = np.empty((n_rows, n_cols), np.float32)
    rc = lib.lgbt_parse_dense(path.encode(), sep.encode(), int(has_header),
                              _f32p(out), n_rows, n_cols)
    if rc != 0:
        raise IOError(f"cannot parse {path} (rc={rc})")
    return out


def parse_dense_range(path: str, sep: str, skip_header: bool, offset: int,
                      max_rows: int, n_cols: int):
    """Up to ``max_rows`` data rows from byte ``offset`` -> (X [rows,
    n_cols] float32, next offset). Offset 0 is the file head, where the
    header is skipped; pass the returned offset back to continue. The same
    field parser as :func:`parse_dense`, so a chunked read gives the
    monolithic values bit for bit."""
    lib = _lib_for_call()
    if lib is None:
        return _parse_range_numpy(
            path, offset, max_rows, skip_header,
            lambda line, dst: _dense_line_numpy(line, sep, dst), n_cols)
    out = np.empty((max_rows, n_cols), np.float32)
    rows, nxt = ctypes.c_int64(0), ctypes.c_int64(0)
    rc = lib.lgbt_parse_dense_range(
        path.encode(), sep.encode(), int(skip_header), int(offset),
        _f32p(out), max_rows, n_cols, ctypes.byref(rows), ctypes.byref(nxt))
    if rc != 0:
        raise IOError(f"cannot parse {path} at {offset} (rc={rc})")
    return out[:rows.value], int(nxt.value)


def parse_libsvm_range(path: str, offset: int, max_rows: int, n_cols: int):
    """Chunked LibSVM parse -> (X [rows, n_cols - 1] float32, label [rows]
    float32, next offset); file column 0 is the label, zeros implicit."""
    lib = _lib_for_call()
    n_feat = n_cols - 1
    if lib is None:
        labels = np.empty((max_rows,), np.float32)
        row = [0]

        def _line(line, dst):
            labels[row[0]] = _libsvm_line_numpy(line, dst)
            row[0] += 1
        X, nxt = _parse_range_numpy(path, offset, max_rows, False, _line,
                                    n_feat, zero_fill=True)
        return X, labels[:len(X)], nxt
    out = np.empty((max_rows, n_feat), np.float32)
    lab = np.empty((max_rows,), np.float32)
    rows, nxt = ctypes.c_int64(0), ctypes.c_int64(0)
    rc = lib.lgbt_parse_libsvm_range(
        path.encode(), int(offset), _f32p(out), _f32p(lab), max_rows,
        n_feat, ctypes.byref(rows), ctypes.byref(nxt))
    if rc != 0:
        raise IOError(f"cannot parse {path} at {offset} (rc={rc})")
    return out[:rows.value], lab[:rows.value], int(nxt.value)


def parse_libsvm(path: str, n_rows: int,
                 n_cols: int) -> Tuple[np.ndarray, np.ndarray]:
    """(X [n_rows, n_cols - 1], label [n_rows]): file column 0 is the
    label; zeros are implicit (the LibSVM convention)."""
    lib = _lib_for_call()
    n_feat = n_cols - 1
    if lib is None:
        return _parse_libsvm_numpy(path, n_rows, n_feat)
    out = np.empty((n_rows, n_feat), np.float32)
    lab = np.empty((n_rows,), np.float32)
    rc = lib.lgbt_parse_libsvm(path.encode(), _f32p(out), _f32p(lab),
                               n_rows, n_feat)
    if rc != 0:
        raise IOError(f"cannot parse {path} (rc={rc})")
    return out, lab


# ---------------------------------------------------------------- fallbacks
def _scan_numpy(path: str):
    sep, rows, cols, libsvm, header = ",", 0, 0, False, False
    with open(path) as f:
        first = True
        for line in f:
            # the C scanner's and the parsers' line rules: empty after the
            # CR/LF strip, or a first character '#', is skipped; a
            # whitespace-only line is a data row of NaNs
            line = line.rstrip("\r\n")
            if not line or line.startswith("#"):
                continue
            if first:
                sep = "\t" if "\t" in line else "," if "," in line else " "
                toks = line.split() if sep == " " else line.split(sep)
                if len(toks) > 1 and ":" in toks[1] and \
                        toks[1].split(":")[0].isdigit():
                    libsvm, sep = True, " "
                if not libsvm:
                    def num(t):
                        try:
                            float(t or "nan")
                            return True
                        except ValueError:
                            return t.lower() in ("na", "nan", "null",
                                                 "none", "")
                    header = not all(num(t) for t in toks)
                first = False
                if header:
                    continue
            rows += 1
            if libsvm:
                for t in line.split()[1:]:
                    if ":" in t:
                        cols = max(cols, int(t.split(":")[0]) + 1)
            else:
                cols = max(cols, len(line.split(sep)))
    return sep, rows, (cols + 1 if libsvm else cols), libsvm, header


def _dense_line_numpy(line: str, sep: str, dst: np.ndarray) -> None:
    """The one fallback dense row parser: missing or unparsable fields are
    NaN, short lines NaN-padded."""
    toks = line.split(sep)
    for col in range(len(dst)):
        if col < len(toks):
            t = toks[col].strip()
            try:
                dst[col] = float(t) if t else np.nan
            except ValueError:
                dst[col] = np.nan
        else:
            dst[col] = np.nan


def _libsvm_line_numpy(line: str, dst: np.ndarray) -> float:
    toks = line.split()
    try:
        lab = float(toks[0])
    except (ValueError, IndexError):
        lab = 0.0
    for t in toks[1:]:
        if ":" not in t:
            continue
        k, v = t.split(":", 1)
        try:
            k = int(k)
        except ValueError:
            continue
        if 0 <= k < len(dst):
            try:
                dst[k] = float(v)
            except ValueError:
                pass
    return lab


def _parse_range_numpy(path: str, offset: int, max_rows: int,
                       skip_header: bool, line_fn, n_cols: int,
                       zero_fill: bool = False):
    """Line-at-a-time parse of up to ``max_rows`` rows from byte
    ``offset`` into one preallocated buffer -> (X[:rows], next offset).
    Binary reads keep the offsets exact."""
    out = np.empty((max_rows, n_cols), np.float32)
    row = 0
    with open(path, "rb") as f:
        if offset > 0:
            f.seek(offset)
        consumed = offset
        first = offset == 0
        while row < max_rows:
            raw = f.readline()
            if not raw:
                break
            line = raw.decode("utf-8", "replace").rstrip("\r\n")
            consumed = f.tell()
            if not line or line.startswith("#"):
                continue
            if first and skip_header:
                first = False
                continue
            first = False
            if zero_fill:
                out[row] = 0.0
            line_fn(line, out[row])
            row += 1
    return out[:row], consumed


def _parse_dense_numpy(path: str, sep: str, has_header: bool, n_rows: int,
                       n_cols: int) -> np.ndarray:
    out, _ = _parse_range_numpy(
        path, 0, n_rows, has_header,
        lambda line, dst: _dense_line_numpy(line, sep, dst), n_cols)
    if out.shape[0] != n_rows:
        raise IOError(f"{path}: expected {n_rows} data rows, parsed "
                      f"{out.shape[0]}")
    return out


def _parse_libsvm_numpy(path: str, n_rows: int, n_feat: int):
    X = np.zeros((n_rows, n_feat), np.float32)
    y = np.zeros((n_rows,), np.float32)
    i = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            y[i] = _libsvm_line_numpy(line, X[i])
            i += 1
    return X, y
