"""Binary dataset cache: the JAX package's ``LGBMTPU2`` artifact (a copy of
``lightgbm_tpu/ingest/cache.py``, single-process, and of
``atomic_stream`` from ``lightgbm_tpu/resilience/atomicio.py``).

One file, written streaming and atomically, mmap-able on reload:

    [8 B magic "LGBMTPU2"]
    [packed bin matrix, C-order uint8/uint16  [num_data, num_used]]
    [metadata pickle (mappers, label, weight, queries, init_score, ...)]
    [manifest JSON]
    [8 B little-endian uint64: manifest length][8 B magic "LGBMTPU2"]

The manifest at the tail records the format version, the regions' offsets,
sizes and SHA-256, the mapper digest and the rank layout; a corrupt,
truncated or skewed file is refused with :class:`CacheError`. The
metadata pickle holds only numpy arrays and plain types (the mappers as
``BinMapper.to_dict`` records), so a file written by either package loads
in the other. ``LGBMTPU1`` files (the JAX package's earlier pickle) are
read by ``BinnedDataset.load_binary``.

Analog of ref: src/io/dataset_loader.cpp:336 LoadFromBinFile /
Dataset::SaveBinaryFile.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import pickle
import struct
import time
from typing import Any, Dict, Iterator

import numpy as np

from ..utils import log

CACHE_MAGIC = b"LGBMTPU2"
LEGACY_MAGIC = b"LGBMTPU1"
CACHE_FORMAT_VERSION = 2
CACHE_SCHEMA = "lightgbm_tpu.dataset_cache"
_FOOTER = struct.Struct("<Q8s")
_HASH_BLOCK = 1 << 22          # 4 MB streaming-hash read block


class CacheError(Exception):
    """A binary dataset cache that must not be used: corrupt, truncated,
    version-mismatched, or written for a different rank layout."""


@contextlib.contextmanager
def atomic_stream(path: str, fsync: bool = True) -> Iterator[Any]:
    """A binary file object on a temp sibling of ``path``: on a clean exit
    it is fsynced and renamed into place, on any exception removed, so a
    reader never sees a half-written artifact."""
    d, base = os.path.split(path)
    tmp = os.path.join(d, f".{base}.tmp.{os.getpid()}")
    try:
        with open(tmp, "wb") as fh:
            yield fh
            if fsync:
                fh.flush()
                os.fsync(fh.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def read_magic(path: str) -> bytes:
    try:
        with open(path, "rb") as fh:
            return fh.read(8)
    except OSError:
        return b""


def read_manifest(path: str) -> Dict[str, Any]:
    """Footer -> manifest dict; raises CacheError on any structural
    problem (short file, bad magic, unparseable manifest, version or
    schema skew, a size that disagrees with the layout)."""
    try:
        size = os.path.getsize(path)
    except OSError as e:
        raise CacheError(f"cannot stat cache {path}: {e}")
    if size < len(CACHE_MAGIC) + _FOOTER.size:
        raise CacheError(f"{path}: too short to be a dataset cache "
                         f"({size} bytes)")
    with open(path, "rb") as fh:
        if fh.read(8) != CACHE_MAGIC:
            raise CacheError(f"{path}: bad cache magic")
        fh.seek(size - _FOOTER.size)
        mf_len, tail_magic = _FOOTER.unpack(fh.read(_FOOTER.size))
        if tail_magic != CACHE_MAGIC:
            raise CacheError(f"{path}: truncated cache (footer magic "
                             "missing — the write never finalized)")
        if mf_len <= 0 or mf_len > size - _FOOTER.size - len(CACHE_MAGIC):
            raise CacheError(f"{path}: corrupt manifest length {mf_len}")
        fh.seek(size - _FOOTER.size - mf_len)
        raw = fh.read(mf_len)
    try:
        manifest = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CacheError(f"{path}: corrupt manifest JSON: {e}")
    ver = manifest.get("format_version")
    if ver != CACHE_FORMAT_VERSION:
        raise CacheError(f"{path}: cache format version {ver} != supported "
                         f"{CACHE_FORMAT_VERSION}")
    if manifest.get("schema") != CACHE_SCHEMA:
        raise CacheError(f"{path}: unknown cache schema "
                         f"{manifest.get('schema')!r}")
    expect_end = manifest["meta_offset"] + manifest["meta_nbytes"] \
        + mf_len + _FOOTER.size
    if expect_end != size:
        raise CacheError(
            f"{path}: size {size} does not match manifest layout "
            f"({expect_end}) — truncated or corrupt")
    return manifest


def _verify_region(path: str, offset: int, nbytes: int, expect: str,
                   what: str) -> None:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        fh.seek(offset)
        left = nbytes
        while left > 0:
            block = fh.read(min(_HASH_BLOCK, left))
            if not block:
                raise CacheError(f"{path}: {what} region truncated")
            h.update(block)
            left -= len(block)
    if h.hexdigest() != expect:
        raise CacheError(
            f"{path}: {what} hash mismatch (expected {expect[:12]}…, got "
            f"{h.hexdigest()[:12]}…) — the cache is corrupt; rebuild it")


def load_dataset_cache(path: str, verify: bool = True):
    """Cache file -> (bins [num_data, num_used] uint8/uint16 read-only
    memmap, metadata dict, manifest). ``verify`` streams the SHA-256 of
    both regions against the manifest; a file written for another rank
    layout is refused."""
    manifest = read_manifest(path)
    if int(manifest.get("world", 1)) != 1:
        raise CacheError(
            f"{path}: cache was written for world={manifest.get('world')} "
            "but this process trains alone")
    if verify:
        _verify_region(path, manifest["bins_offset"],
                       manifest["bins_nbytes"], manifest["bins_sha256"],
                       "bins")
        _verify_region(path, manifest["meta_offset"],
                       manifest["meta_nbytes"], manifest["meta_sha256"],
                       "metadata")
    with open(path, "rb") as fh:
        fh.seek(manifest["meta_offset"])
        meta = pickle.loads(fh.read(manifest["meta_nbytes"]))
    n = int(manifest["num_data"])
    n_used = int(manifest["num_used_features"])
    dtype = np.dtype(manifest["bin_dtype"])
    if n * n_used > 0:
        bins = np.memmap(path, dtype=dtype, mode="r",
                         offset=int(manifest["bins_offset"]),
                         shape=(n, n_used))
    else:
        bins = np.zeros((n, n_used), dtype)
    return bins, meta, manifest


def dataset_meta(ds) -> Dict[str, Any]:
    """The picklable metadata region of a binned dataset (the JAX
    package's keys): a multi-process build keeps its gathered binning
    sample (binned, uint16) for EFB, so a rank that loads the cache
    bundles as a rank that built it (lightgbm_tpu/ingest/cache.py:
    322-326)."""
    md = ds.metadata
    return {
        "mappers": [m.to_dict() for m in ds.mappers],
        "used_features": list(ds.used_features),
        "feature_names": list(ds.feature_names or []),
        "label": None if md is None else md.label,
        "weight": None if md is None else md.weight,
        "query_boundaries": None if md is None else md.query_boundaries,
        "init_score": None if md is None else md.init_score,
        "monotone_constraints": ds.monotone_constraints,
        "dataset_params": dict(ds.dataset_params),
        "mp_sample_bins": ds.mp_sample_bins,
    }


def save_dataset_cache(ds, path: str,
                       chunk_rows: int = 65536) -> Dict[str, Any]:
    """Write a binned dataset as a v2 artifact, streaming its bin matrix
    in ``chunk_rows`` blocks into an atomic temp sibling; returns the
    manifest."""
    from ..binning import mappers_digest
    if ds.prebundled is not None:
        raise CacheError(
            "sparse EFB-bundled datasets store bundle columns, not "
            "per-feature bins, and are not cacheable — construct from "
            "dense input to use the binary cache")
    bins = np.ascontiguousarray(ds.bins)
    n, n_used = bins.shape
    bins_hash = hashlib.sha256()
    chunks = 0
    with atomic_stream(str(path)) as fh:
        fh.write(CACHE_MAGIC)
        for lo in range(0, n, max(1, int(chunk_rows))):
            buf = bins[lo:lo + int(chunk_rows)].tobytes()
            bins_hash.update(buf)
            fh.write(buf)
            chunks += 1
        meta_bytes = pickle.dumps(dataset_meta(ds), protocol=4)
        bins_nbytes = bins.nbytes
        manifest = {
            "format_version": CACHE_FORMAT_VERSION,
            "schema": CACHE_SCHEMA,
            "num_data": int(n),
            "num_used_features": int(n_used),
            "num_total_features": int(ds.num_total_features),
            "bin_dtype": bins.dtype.name,
            "bins_offset": len(CACHE_MAGIC),
            "bins_nbytes": int(bins_nbytes),
            "meta_offset": len(CACHE_MAGIC) + int(bins_nbytes),
            "meta_nbytes": len(meta_bytes),
            "bins_sha256": bins_hash.hexdigest(),
            "meta_sha256": hashlib.sha256(meta_bytes).hexdigest(),
            "mappers_digest": mappers_digest(ds.mappers),
            "rank": 0, "world": 1,
            "chunks": chunks,
            "source": None,
            "created": round(time.time(), 3),
            "reference_binned": bool(ds.reference_binned),
        }
        mf = json.dumps(manifest, sort_keys=True).encode("utf-8")
        fh.write(meta_bytes)
        fh.write(mf)
        fh.write(_FOOTER.pack(len(mf), CACHE_MAGIC))
    log.info("Saved binary dataset cache: %s (%d rows x %d features, "
             "%d chunks)", path, n, n_used, chunks)
    return manifest
