"""Binary dataset cache: the JAX package's ``LGBMTPU2`` artifact (a copy of
``lightgbm_tpu/ingest/cache.py``; its atomic write is
``resilience/atomicio.atomic_stream``).

One file per rank, written streaming and atomically, mmap-able on reload:

    [8 B magic "LGBMTPU2"]
    [packed bin matrix, C-order uint8/uint16  [num_data, num_used]]
    [metadata pickle (mappers, label, weight, queries, init_score, ...)]
    [manifest JSON]
    [8 B little-endian uint64: manifest length][8 B magic "LGBMTPU2"]

The manifest at the tail records the format version, the regions' offsets,
sizes and SHA-256, the mapper digest, the producing rank and world and,
for a ``save_binary`` sidecar, the source file's fingerprint
(:func:`source_fingerprint`); a corrupt, truncated or skewed file, or one
written for another rank layout, is refused with :class:`CacheError`.
:class:`CacheWriter` takes packed chunks in row order, so the streamed
build (``ingest/pipeline.py``) writes the artifact without ever holding
the whole bin matrix. Under ranks each rank's shard is
``<path>.rank<r>of<w>`` (:func:`cache_shard_path`). The metadata pickle
holds only numpy arrays and plain types (the mappers as
``BinMapper.to_dict`` records), so a file written by either package loads
in the other. ``LGBMTPU1`` files (the JAX package's earlier pickle) are
read by ``BinnedDataset.load_binary``.

Analog of ref: src/io/dataset_loader.cpp:336 LoadFromBinFile /
Dataset::SaveBinaryFile.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import struct
import time
from typing import Any, Dict, Optional

import numpy as np

from ..resilience.atomicio import atomic_stream
from ..utils import log

CACHE_MAGIC = b"LGBMTPU2"
LEGACY_MAGIC = b"LGBMTPU1"
CACHE_FORMAT_VERSION = 2
CACHE_SCHEMA = "lightgbm_tpu.dataset_cache"
_FOOTER = struct.Struct("<Q8s")
_HASH_BLOCK = 1 << 22          # 4 MB streaming-hash read block
SAVE_CHUNK_ROWS = 65536        # rows per block save_dataset_cache writes


class CacheError(Exception):
    """A binary dataset cache that must not be used: corrupt, truncated,
    version-mismatched, or written for a different rank layout."""


def cache_shard_path(path: str, rank: int = 0, world: int = 1) -> str:
    """A rank's shard file: the bare path alone, ``<path>.rank<r>of<w>``
    under ranks (each rank caches its own row slice)."""
    if world <= 1:
        return str(path)
    return f"{path}.rank{int(rank)}of{int(world)}"


def source_fingerprint(path: str, params_digest: str = "") -> Dict[str, Any]:
    """The text file a cache was built from: size, mtime and the digest of
    the dataset-defining parameters. A ``save_binary`` sidecar hits only
    when all three match."""
    st = os.stat(path)
    return {"path": os.path.abspath(str(path)), "size": int(st.st_size),
            "mtime_ns": int(st.st_mtime_ns), "params_digest": params_digest}


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


def load_dataset_cache(path: str, verify: bool = True,
                       expect_rank: Optional[int] = None,
                       expect_world: Optional[int] = None):
    """Cache file -> (bins [num_data, num_used] uint8/uint16, metadata dict,
    manifest). ``verify`` streams the SHA-256 of both regions against the
    manifest; the bins are mapped read-only, not read. A file written for
    another world or rank than ``expect_world`` / ``expect_rank`` is
    refused."""
    manifest = read_manifest(path)
    if expect_world is not None and int(manifest.get("world", 1)) \
            != int(expect_world):
        raise CacheError(
            f"{path}: cache was written for world={manifest.get('world')}"
            f" but this run has world={expect_world} — rebuild per-rank "
            "caches (save_binary under the current launcher layout)")
    if expect_rank is not None and int(manifest.get("rank", 0)) \
            != int(expect_rank):
        raise CacheError(
            f"{path}: cache shard belongs to rank {manifest.get('rank')} "
            f"but rank {expect_rank} tried to load it")
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
    if n * n_used == 0:
        bins = np.zeros((n, n_used), dtype)
    else:
        bins = np.memmap(path, dtype=dtype, mode="r",
                         offset=int(manifest["bins_offset"]),
                         shape=(n, n_used))
    return bins, meta, manifest


class CacheWriter:
    """Streaming cache writer: ``append_rows`` packed-bin chunks in row
    order, then ``finalize`` with the metadata dict. Everything lands in
    an atomic temp sibling; a failure (or ``abort``) before ``finalize``
    leaves the destination untouched."""

    def __init__(self, path: str, num_data: int, num_total_features: int,
                 used_features, bin_dtype, rank: int = 0, world: int = 1,
                 source: Optional[Dict[str, Any]] = None):
        self.path = str(path)
        self.num_data = int(num_data)
        self.num_total_features = int(num_total_features)
        self.used_features = list(used_features)
        self.dtype = np.dtype(bin_dtype)
        self.rank, self.world = int(rank), int(world)
        self.source = source
        self.rows_written = 0
        self.chunks_written = 0
        self._bins_hash = hashlib.sha256()
        self._cm = atomic_stream(self.path)
        self._fh = self._cm.__enter__()
        self._done = False
        try:
            self._fh.write(CACHE_MAGIC)
        except BaseException:
            self.abort()
            raise

    def append_rows(self, packed: np.ndarray) -> None:
        if self._done:
            raise CacheError("cache writer already finalized")
        if packed.dtype != self.dtype or packed.ndim != 2 \
                or packed.shape[1] != len(self.used_features):
            raise CacheError(
                f"chunk shape/dtype {packed.shape}/{packed.dtype} does "
                f"not match the declared [*, {len(self.used_features)}] "
                f"{self.dtype}")
        if self.rows_written + packed.shape[0] > self.num_data:
            raise CacheError(
                f"cache overflow: {self.rows_written + packed.shape[0]} "
                f"rows pushed into a {self.num_data}-row artifact")
        buf = np.ascontiguousarray(packed).tobytes()
        self._bins_hash.update(buf)
        self._fh.write(buf)
        self.rows_written += packed.shape[0]
        self.chunks_written += 1

    def finalize(self, meta: Dict[str, Any], mappers_digest: str = "",
                 extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Write the metadata, manifest and footer, fsync and rename into
        place; ``extra`` merges more manifest fields. Returns the
        manifest."""
        if self._done:
            raise CacheError("cache writer already finalized")
        if self.rows_written != self.num_data:
            raise CacheError(f"cache underflow: {self.rows_written} of "
                             f"{self.num_data} rows written")
        meta_bytes = pickle.dumps(meta, protocol=4)
        bins_nbytes = self.num_data * len(self.used_features) \
            * self.dtype.itemsize
        manifest = {
            "format_version": CACHE_FORMAT_VERSION,
            "schema": CACHE_SCHEMA,
            "num_data": self.num_data,
            "num_used_features": len(self.used_features),
            "num_total_features": self.num_total_features,
            "bin_dtype": self.dtype.name,
            "bins_offset": len(CACHE_MAGIC),
            "bins_nbytes": bins_nbytes,
            "meta_offset": len(CACHE_MAGIC) + bins_nbytes,
            "meta_nbytes": len(meta_bytes),
            "bins_sha256": self._bins_hash.hexdigest(),
            "meta_sha256": hashlib.sha256(meta_bytes).hexdigest(),
            "mappers_digest": mappers_digest,
            "rank": self.rank, "world": self.world,
            "chunks": self.chunks_written,
            "source": self.source,
            "created": round(time.time(), 3),
        }
        manifest.update(extra or {})
        mf = json.dumps(manifest, sort_keys=True).encode("utf-8")
        self._fh.write(meta_bytes)
        self._fh.write(mf)
        self._fh.write(_FOOTER.pack(len(mf), CACHE_MAGIC))
        self._done = True
        self._cm.__exit__(None, None, None)      # fsync + rename
        return manifest

    def abort(self) -> None:
        """Discard the temp artifact (the destination stays untouched)."""
        if self._done:
            return
        self._done = True
        exc = CacheError("cache write aborted")
        self._cm.__exit__(CacheError, exc, None)


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


def save_dataset_cache(ds, path: str, rank: int = 0, world: int = 1,
                       source: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, Any]:
    """Write a binned dataset as a v2 artifact, its bin matrix streamed in
    blocks of ``SAVE_CHUNK_ROWS`` rows; returns the manifest."""
    from ..binning import mappers_digest
    if ds.prebundled is not None:
        raise CacheError(
            "sparse EFB-bundled datasets store bundle columns, not "
            "per-feature bins, and are not cacheable — construct from "
            "dense/text input to use the binary cache")
    if ds.raw_data is not None:
        raise CacheError(
            "linear_tree datasets retain raw feature values, which the "
            "binary cache does not carry — train linear_tree from the "
            "text/array source")
    bins = ds.bins
    w = CacheWriter(path, ds.num_data, ds.num_total_features,
                    ds.used_features, bins.dtype, rank=rank, world=world,
                    source=source)
    try:
        for lo in range(0, ds.num_data, SAVE_CHUNK_ROWS):
            w.append_rows(bins[lo:lo + SAVE_CHUNK_ROWS])
        manifest = w.finalize(
            dataset_meta(ds), mappers_digest=mappers_digest(ds.mappers),
            extra={"reference_binned": bool(ds.reference_binned)})
    except BaseException:
        w.abort()
        raise
    log.info("Saved binary dataset cache: %s (%d rows x %d features, "
             "%d chunks)", path, ds.num_data, len(ds.used_features),
             manifest["chunks"])
    return manifest
