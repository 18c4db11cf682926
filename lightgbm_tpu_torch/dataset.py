"""Binned dataset container + metadata.

PyTorch counterpart of ``lightgbm_tpu/dataset.py`` (``TpuDataset``) on its
dense numerical ``from_data`` path: the same row sample, the same
``BinMapper`` construction (ref: dataset_loader.cpp:988
ConstructBinMappersFromTextData) and the same binning, so both packages bin
a matrix identically. The binned ``[num_data, num_used_features]`` matrix
is kept on the host and, as ``bins_dev``, on the training device. A valid
set bins against its training set's mappers (``reference``), and a row
subset (``subset``, the folds of ``cv``) slices the binned rows.

Categorical features (``categorical_feature``: the count-sorted vocabulary
of ``binning.py``, bin 0 the NaN/other catch-all) bin as the JAX package's
do, and ``is_categorical`` marks them per used feature. Query groups
(``Metadata.set_group``) are kept as cumulative ``query_boundaries``; a row
subset re-encodes them from its rows' queries in row order.

A scipy CSR/CSC matrix (``from_sparse``, the JAX package's
``dataset.py:122-160, 338-463``) is binned without ever making the dense
[R, F] matrix: per-column mappers from the CSC sample, exclusive feature
bundling on the sample rows (conflict rate 0, at most
``tpu_max_bundle_bins`` bins a column), and the [R, C] bundle-column
matrix encoded straight from the CSC columns. Such a dataset is
``prebundled``: ``bins`` holds bundle columns and ``prebundled`` the
``ops/efb.BundleLayout`` that decodes them. A valid set built against it
(``reference``) stores exact logical bins, since it is only routed.

``monotone_constraints`` are kept per original column, length-checked as
the JAX package does (``dataset.py:261-264, 458-462``), and carried by row
subsets and by sets binned against a reference; the trainer indexes them
by the used features. ``add_features_from`` appends another dataset's
columns (and constraints), and ``save_binary``/``load_binary`` write and
read the JAX package's binary cache (``io/cache.py``): a file written by
either package loads in the other.

A dataset keeps its host bins (a read-only memmap for a cache) and copies
them to the device when ``bins_dev`` is first taken, through the chunked,
double-buffered prefetch (``ingest/prefetch.py``), or in one shot when
``ingest_prefetch`` was false at construction; ``ingest_stats`` holds the
streamed ingest's or the cache load's counters and then the prefetch's.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .binning import (BIN_CATEGORICAL, BIN_NUMERICAL, BinMapper,
                      effective_bin_counts)
from .config import Config
from .io.cache import (CACHE_MAGIC, LEGACY_MAGIC, CacheError,
                       load_dataset_cache, read_magic, save_dataset_cache)
from .ops.efb import BundleLayout, find_bundles
from .parallel import mesh
from .parallel.multiproc import allgather_sample
from .utils import log

# the binning-defining keys a binary cache carries (the JAX package's
# dataset.py:30-39)
_DATASET_DEFINING_KEYS = (
    "max_bin", "max_bin_by_feature", "bin_construct_sample_cnt",
    "min_data_in_bin", "use_missing", "zero_as_missing",
    "feature_pre_filter", "min_data_in_leaf", "data_random_seed")


class Metadata:
    """Label / weight / query-boundary / init-score holder (ref:
    include/LightGBM/dataset.h:42, src/io/metadata.cpp)."""

    def __init__(self, num_data: int):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None  # int32 [Q+1]
        self.init_score: Optional[np.ndarray] = None

    def set_label(self, label) -> None:
        label = np.asarray(label, dtype=np.float32).reshape(-1)
        log.check(label.size == self.num_data,
                  f"label size {label.size} != num_data {self.num_data}")
        self.label = label

    def set_weight(self, weight) -> None:
        if weight is None:
            self.weight = None
            return
        weight = np.asarray(weight, dtype=np.float32).reshape(-1)
        log.check(weight.size == self.num_data,
                  f"weight size {weight.size} != num_data {self.num_data}")
        log.check(bool(np.all(weight >= 0)), "weights should be non-negative")
        self.weight = weight

    def set_group(self, group) -> None:
        """``group``: per-query sizes in row order (like the reference's
        query file), kept as cumulative boundaries (ref: metadata.cpp
        query_boundaries_)."""
        if group is None:
            self.query_boundaries = None
            return
        group = np.asarray(group, dtype=np.int64).reshape(-1)
        log.check(int(group.sum()) == self.num_data,
                  "sum of group sizes != num_data")
        self.query_boundaries = np.concatenate(
            [[0], np.cumsum(group)]).astype(np.int32)

    def num_queries(self) -> int:
        return (0 if self.query_boundaries is None
                else len(self.query_boundaries) - 1)

    def set_init_score(self, init_score) -> None:
        """Kept in float64 (the trainer rounds it to f32 scores)."""
        if init_score is None:
            self.init_score = None
            return
        self.init_score = np.asarray(init_score,
                                     dtype=np.float64).reshape(-1)

    def subset(self, rows: np.ndarray) -> "Metadata":
        """The metadata of the rows ``rows`` (a flat [k*n] class-major
        init score is cut per class)."""
        out = Metadata(len(rows))
        if self.label is not None:
            out.set_label(self.label[rows])
        if self.weight is not None:
            out.set_weight(self.weight[rows])
        if self.init_score is not None:
            k = self.init_score.size // self.num_data
            out.set_init_score(self.init_score.reshape(
                k, self.num_data)[:, rows].reshape(-1))
        if self.query_boundaries is not None and len(rows):
            # run-length encode the rows' query ids in row order, so the
            # group sizes stay aligned with the (possibly unsorted) rows
            # (lightgbm_tpu/dataset.py:635-655); whole-query folds keep
            # every query whole
            row_query = np.searchsorted(self.query_boundaries, rows,
                                        side="right") - 1
            starts = np.nonzero(np.concatenate(
                [[True], row_query[1:] != row_query[:-1]]))[0]
            seen = row_query[starts]
            if len(np.unique(seen)) != len(seen):
                log.warning(
                    "subset rows interleave query groups: a query's "
                    "rows are not contiguous in the subset, so it "
                    "is split into multiple groups — sort subset "
                    "indices by query to avoid this")
            out.set_group(np.diff(np.concatenate([starts, [len(rows)]])))
        return out


def _sample_rows(num_data: int, sample_cnt: int, seed: int) -> np.ndarray:
    if num_data <= sample_cnt:
        return np.arange(num_data)
    rng = np.random.RandomState(seed)
    return np.sort(rng.choice(num_data, size=sample_cnt, replace=False))


def _encode_sparse_bundles(csc, mappers, used_features, layout,
                           most_freq_bins, n: int) -> np.ndarray:
    """[R, C] bundle-column matrix straight from CSC columns — the dense
    [R, F] logical matrix is never made (lightgbm_tpu/dataset.py:122-160).
    Bundle bin 0 = the row is default (most-frequent bin) in every member;
    conflicts keep the first member's encoding (ops/efb.py)."""
    C = layout.num_columns
    dtype = np.uint16 if max(layout.col_num_bin) > 255 else np.uint8
    out = np.zeros((n, C), dtype)
    for ci, bundle in enumerate(layout.bundles):
        col = np.zeros(n, np.int64)
        taken = np.zeros(n, bool)
        for k in bundle:
            j = used_features[k]
            m = mappers[j]
            off = int(layout.offset_of_feat[k])
            mfb = int(most_freq_bins[k])
            lo, hi = csc.indptr[j], csc.indptr[j + 1]
            rows_j = csc.indices[lo:hi]
            bins_nz = m.value_to_bin(
                np.asarray(csc.data[lo:hi], np.float64)).astype(np.int64)
            zero_bin = int(m.value_to_bin(np.zeros(1))[0])
            if zero_bin == mfb:
                # implicit zeros are default: only the non-default
                # non-zeros are stored
                nd = bins_nz != mfb
                sel = rows_j[nd]
                keep = ~taken[sel]
                col[sel[keep]] = off + bins_nz[nd][keep]
                taken[sel[keep]] = True
            else:
                # zeros bin away from the most-frequent bin (e.g.
                # zero_as_missing): this member expands densely
                dense_bins = np.full(n, zero_bin, np.int64)
                dense_bins[rows_j] = bins_nz
                sel = np.nonzero((dense_bins != mfb) & ~taken)[0]
                col[sel] = off + dense_bins[sel]
                taken[sel] = True
        out[:, ci] = col.astype(dtype)
    return out


class BinnedDataset:
    """The binned training matrix (counterpart of ``TpuDataset``).

    ``bins``: host ``[num_data, num_used_features]`` uint8/uint16;
    ``bins_dev``: the same matrix on ``device``, placed there on first use
    (a dataset loaded from a binary cache reaches the card only when a
    booster is built on it); ``mappers`` holds one BinMapper per original
    feature (trivial ones included, for model IO).
    """

    def __init__(self):
        self.bins: Optional[np.ndarray] = None
        self._bins_dev: Optional[torch.Tensor] = None
        self.device = torch.device("cpu")
        self.mappers: List[BinMapper] = []
        self.used_features: List[int] = []
        self.num_data = 0
        self.num_total_features = 0
        self.feature_names: List[str] = []
        self.metadata: Optional[Metadata] = None
        self.max_num_bin = 1
        self.num_bin_per_feat = np.zeros(0, np.int32)
        self.missing_types = np.zeros(0, np.int32)
        self.is_categorical = np.zeros(0, bool)
        self.most_freq_bins = np.zeros(0, np.int32)
        # the bundle layout of a sparse-built dataset, whose ``bins`` are
        # then bundle columns; None for logical bins
        self.prebundled: Optional[BundleLayout] = None
        # per original column, or None (no constraint)
        self.monotone_constraints: Optional[np.ndarray] = None
        # the binning parameters of the build, kept by the binary cache
        self.dataset_params: Dict[str, Any] = {}
        # binned against another dataset's mappers (a valid set)
        self.reference_binned = False
        # [num_data, num_total_features] float32 raw columns on ``device``,
        # kept for linear trees (a row subset does not carry them, as in
        # the JAX package's TpuDataset.subset)
        self.raw_data: Optional[torch.Tensor] = None
        # [sample rows, num_used_features] uint16: the binned sample every
        # rank gathered, kept under a parallel tree_learner over two or
        # more ranks (the bundle layout's conflict masks); None otherwise
        self.mp_sample_bins: Optional[np.ndarray] = None
        # how ``bins_dev`` copies the host bins: the chunked prefetch in
        # blocks of ``prefetch_chunk_rows``, or (``prefetch`` false) one
        # widened copy
        self.prefetch = True
        self.prefetch_chunk_rows = 65536
        self.ingest_stats: Optional[Dict[str, Any]] = None

    @classmethod
    def from_data(cls, data: np.ndarray, config: Config, device,
                  feature_names: Optional[List[str]] = None,
                  reference: Optional["BinnedDataset"] = None,
                  categorical_feature: Sequence[int] = ()
                  ) -> "BinnedDataset":
        """Build from a dense float matrix: sample rows, construct one
        mapper per feature (categorical for the column indices in
        ``categorical_feature``), bin every row, and place the bins on
        ``device``. With ``reference``, its mappers and used features are
        reused instead, so validation rows bin as the training rows do
        (ref: dataset_loader.cpp:282 LoadFromFileAlignWithOtherDataset)."""
        self = cls()
        data = np.asarray(data)
        if data.ndim != 2:
            log.fatal("data must be 2-dimensional")
        n, f = data.shape
        self.num_data = n
        self.num_total_features = f
        self.feature_names = (list(feature_names) if feature_names
                              else [f"Column_{i}" for i in range(f)])
        self.metadata = Metadata(n)
        self.set_prefetch(config)
        if reference is not None:
            if f != reference.num_total_features:
                log.fatal("the data has %d features but its reference has "
                          "%d", f, reference.num_total_features)
            self._adopt_reference(reference)
            self._place(self.bin_rows(data), device)
            return self
        sample_idx = _sample_rows(n, config.bin_construct_sample_cnt,
                                  config.data_random_seed)
        self.build_mappers_from_sample(
            np.asarray(data[sample_idx], dtype=np.float64), config,
            set(int(c) for c in categorical_feature))
        self._place(self.bin_rows(data), device)
        self._set_monotone(config, f)
        return self

    def build_mappers_from_sample(self, sample: np.ndarray, config: Config,
                                  cat_set=frozenset()) -> None:
        """One mapper per feature from a float64 row sample, then the used
        features and the feature arrays. The one mapper construction:
        ``from_data`` and the streamed ingest (which collects the same
        sample rows chunk by chunk) both come here, so their mappers are
        the same bits (lightgbm_tpu/dataset.py:267-331)."""
        f = self.num_total_features
        # distributed loading: every rank holds only its row shard, and the
        # bin mappers must still be IDENTICAL everywhere, so the samples
        # are allgathered before FindBin (lightgbm_tpu/dataset.py:281-284;
        # ref: dataset_loader.cpp:1015,1146-1154). Only for a parallel
        # tree_learner: a torch process group may exist for other reasons
        # (a DDP job, ranks each training a serial model of their own)
        if config.is_parallel:
            sample = allgather_sample(sample)
        mb_by_feat = list(config.max_bin_by_feature or [])
        if mb_by_feat and len(mb_by_feat) != f:
            log.fatal("max_bin_by_feature has %d entries but the data has "
                      "%d features" % (len(mb_by_feat), f))
        self.mappers = []
        for j in range(f):
            m = BinMapper()
            col = sample[:, j]
            # the reference feeds only the non-zero sampled values plus the
            # total count (zeros implicit)
            nz = col[(np.abs(col) > 1e-35) | np.isnan(col)]
            m.find_bin(nz, total_sample_cnt=len(col),
                       max_bin=int(mb_by_feat[j]) if mb_by_feat
                       else config.max_bin,
                       min_data_in_bin=config.min_data_in_bin,
                       min_split_data=config.min_data_in_leaf
                       if config.feature_pre_filter else 0,
                       pre_filter=config.feature_pre_filter,
                       bin_type=(BIN_CATEGORICAL if j in cat_set
                                 else BIN_NUMERICAL),
                       use_missing=config.use_missing,
                       zero_as_missing=config.zero_as_missing)
            self.mappers.append(m)
        self.used_features = [j for j in range(f)
                              if not self.mappers[j].is_trivial]
        if not self.used_features:
            log.warning("There are no meaningful features which satisfy "
                        "the provided configuration.")
        if mesh.under_ranks(config) and self.used_features:
            # the gathered sample, binned (uint16), is kept for EFB: the
            # bundle layout must be the same on every rank, so its
            # conflict masks come from this shared sample
            # (lightgbm_tpu/dataset.py:313-322; the reference also bundles
            # from sampled rows, dataset_loader.cpp FindGroups)
            self.mp_sample_bins = np.stack(
                [self.mappers[j].value_to_bin(sample[:, j])
                 for j in self.used_features], axis=1).astype(np.uint16)
        self._finalize_feature_arrays()

    @classmethod
    def from_sparse(cls, data, config: Config, device,
                    feature_names: Optional[List[str]] = None,
                    reference: Optional["BinnedDataset"] = None
                    ) -> "BinnedDataset":
        """Build from a scipy CSR/CSC matrix without making the dense
        [R, F] float matrix (lightgbm_tpu/dataset.py:338-463; ref: the
        reference's CSR/CSC dataset creation, c_api.cpp:398-520):
        per-column mappers from the sample rows' non-zeros, bundling on the
        sample rows at conflict rate 0, and the bundle-column matrix
        encoded from the CSC columns (``prebundled``). With ``reference``
        the rows are binned as exact logical bins against its mappers (a
        valid set is only routed, never histogrammed)."""
        import scipy.sparse as sp
        self = cls()
        csc = sp.csc_matrix(data)
        csc.sort_indices()
        n, f = csc.shape
        self.num_data = n
        self.num_total_features = f
        self.feature_names = (list(feature_names) if feature_names
                              else [f"Column_{i}" for i in range(f)])
        self.metadata = Metadata(n)
        self.set_prefetch(config)
        if reference is not None:
            if f != reference.num_total_features:
                log.fatal("the data has %d features but its reference has "
                          "%d", f, reference.num_total_features)
            self._adopt_reference(reference)
            dtype = np.uint8 if self.max_num_bin <= 256 else np.uint16
            out = np.zeros((n, len(self.used_features)), dtype)
            for k, j in enumerate(self.used_features):
                m = self.mappers[j]
                lo, hi = csc.indptr[j], csc.indptr[j + 1]
                zero_bin = int(m.value_to_bin(np.zeros(1))[0])
                col = np.full(n, zero_bin, dtype)
                col[csc.indices[lo:hi]] = m.value_to_bin(
                    np.asarray(csc.data[lo:hi], np.float64)).astype(dtype)
                out[:, k] = col
            self._place(out, device)
            return self
        # per-column mappers from the sample's non-zeros (zeros implicit,
        # as the dense path's); one pass also collects each used column's
        # sample rows that are not implicit zeros, for bundling
        sample_idx = _sample_rows(n, config.bin_construct_sample_cnt,
                                  config.data_random_seed)
        n_sample = len(sample_idx)
        sample_masks = []
        for j in range(f):
            lo, hi = csc.indptr[j], csc.indptr[j + 1]
            rows_j = csc.indices[lo:hi]
            pos = np.searchsorted(sample_idx, rows_j)
            pos_c = np.minimum(pos, n_sample - 1)
            hit = (pos < n_sample) & (sample_idx[pos_c] == rows_j)
            nz = np.asarray(csc.data[lo:hi][hit], np.float64)
            nz = nz[(np.abs(nz) > 1e-35) | np.isnan(nz)]
            m = BinMapper()
            m.find_bin(nz, total_sample_cnt=n_sample,
                       max_bin=config.max_bin,
                       min_data_in_bin=config.min_data_in_bin,
                       min_split_data=(config.min_data_in_leaf
                                       if config.feature_pre_filter else 0),
                       pre_filter=config.feature_pre_filter,
                       bin_type=BIN_NUMERICAL,
                       use_missing=config.use_missing,
                       zero_as_missing=config.zero_as_missing)
            self.mappers.append(m)
            if not m.is_trivial:
                mask = np.zeros(n_sample, bool)
                mask[pos_c[hit]] = True
                sample_masks.append(mask)
        self.used_features = [j for j in range(f)
                              if not self.mappers[j].is_trivial]
        if not self.used_features:
            log.warning("There are no meaningful features which satisfy "
                        "the provided configuration.")
        self._finalize_feature_arrays()
        # conflict-free bundling on the sample rows (the reference also
        # bundles from its sample, dataset_loader.cpp FindGroups)
        nb = [int(x) for x in self.num_bin_per_feat]
        bundles = find_bundles(sample_masks, n_sample, max_conflict_rate=0.0,
                               max_bundle_bins=int(config.tpu_max_bundle_bins),
                               num_bin_per_feat=nb)
        layout = BundleLayout(bundles, nb)
        self.prebundled = layout
        self._place(_encode_sparse_bundles(csc, self.mappers,
                                           self.used_features, layout,
                                           self.most_freq_bins, n), device)
        log.info("Sparse EFB: %d used features -> %d bundle columns "
                 "(max %d bins)", len(self.used_features),
                 layout.num_columns,
                 max(layout.col_num_bin) if layout.num_columns else 0)
        self._set_monotone(config, f)
        return self

    def _adopt_reference(self, reference: "BinnedDataset") -> None:
        """Bin with ``reference``'s mappers (a valid set)."""
        self.mappers = reference.mappers
        self.used_features = reference.used_features
        self.monotone_constraints = reference.monotone_constraints
        self.dataset_params = dict(reference.dataset_params)
        self.reference_binned = True
        self._finalize_feature_arrays()

    def _set_monotone(self, config: Config, f: int) -> None:
        """The build's binning parameters, and ``monotone_constraints``
        per original column when given."""
        self.dataset_params = {k: getattr(config, k)
                               for k in _DATASET_DEFINING_KEYS}
        if config.monotone_constraints:
            mc = np.asarray(config.monotone_constraints, dtype=np.int32)
            log.check(mc.size == f, "monotone_constraints length mismatch")
            self.monotone_constraints = mc

    def _finalize_feature_arrays(self) -> None:
        used = [self.mappers[j] for j in self.used_features]
        self.num_bin_per_feat = effective_bin_counts(used)
        self.max_num_bin = (int(self.num_bin_per_feat.max())
                            if self.used_features else 1)
        self.missing_types = np.array([m.missing_type for m in used],
                                      np.int32)
        self.most_freq_bins = np.array([m.most_freq_bin for m in used],
                                       np.int32)
        self.is_categorical = np.array(
            [m.bin_type == BIN_CATEGORICAL for m in used], bool)

    def _place(self, bins: np.ndarray, device) -> None:
        """Keep the host bins for ``device``; ``bins_dev`` copies them
        there at first use."""
        self.bins = bins
        self.device = torch.device(device)
        self._bins_dev = None

    @property
    def bins_dev(self) -> Optional[torch.Tensor]:
        """The bins on ``device``, widened (int16 for uint8 host bins,
        int32 for uint16) so bins >= 128 stay positive in a signed tensor;
        copied at first use through the chunked prefetch, or in one shot
        when ``prefetch`` is off."""
        if self._bins_dev is None and self.bins is not None:
            if self.prefetch:
                from .ingest.prefetch import IngestStats, stream_to_device
                stats = IngestStats(source="prefetch")
                self._bins_dev = stream_to_device(
                    self.bins, self.prefetch_chunk_rows, self.device, stats)
                self.ingest_stats = dict(self.ingest_stats or {},
                                         prefetch=stats.to_dict())
            else:
                wide = np.int16 if self.bins.dtype == np.uint8 else np.int32
                self._bins_dev = torch.from_numpy(
                    np.asarray(self.bins).astype(wide)).to(self.device)
        return self._bins_dev

    def set_prefetch(self, config: Config) -> None:
        """The prefetch's switch and chunk rows, from the construct's
        configuration."""
        self.prefetch = bool(config.ingest_prefetch)
        self.prefetch_chunk_rows = int(config.ingest_chunk_rows)

    def bin_dtype(self):
        return np.uint8 if self.max_num_bin <= 256 else np.uint16

    def subset(self, rows) -> "BinnedDataset":
        """A row subset sharing the mappers: the binned rows are sliced,
        nothing is rebinned (ref: dataset.cpp CopySubrow; cv folds)."""
        rows = np.asarray(rows)
        out = BinnedDataset()
        out.mappers = self.mappers
        out.used_features = self.used_features
        out.num_data = len(rows)
        out.num_total_features = self.num_total_features
        out.feature_names = self.feature_names
        out.metadata = self.metadata.subset(rows)
        out._finalize_feature_arrays()
        out.prebundled = self.prebundled     # bundle rows slice as rows do
        out.monotone_constraints = self.monotone_constraints
        out.dataset_params = dict(self.dataset_params)
        out.prefetch = self.prefetch
        out.prefetch_chunk_rows = self.prefetch_chunk_rows
        out._place(self.bins[rows], self.device)
        return out

    def add_features_from(self, other: "BinnedDataset") -> None:
        """Append ``other``'s features column-wise (ref: dataset.h
        AddFeaturesFrom; lightgbm_tpu/dataset.py:506-533): its mappers and
        binned columns become new features after this one's, its names
        taking a ``_2`` suffix where they clash, its constraints (0 where
        it has none) after this one's. Both hold the same rows."""
        if other.num_data != self.num_data:
            log.fatal("add_features_from: row counts differ (%d vs %d)"
                      % (self.num_data, other.num_data))
        if self.prebundled is not None or other.prebundled is not None:
            log.fatal("add_features_from needs per-feature bins; a "
                      "sparse-built dataset holds bundle columns")
        base = len(self.mappers)
        self.num_total_features += other.num_total_features
        self.mappers = list(self.mappers) + list(other.mappers)
        self.used_features = list(self.used_features) + [
            base + j for j in other.used_features]
        self.feature_names = list(self.feature_names) + [
            n if n not in self.feature_names else f"{n}_2"
            for n in other.feature_names]
        dtype = (np.uint16 if max(self.max_num_bin, other.max_num_bin) > 256
                 else self.bins.dtype)
        bins = np.concatenate([np.asarray(self.bins, dtype),
                               np.asarray(other.bins, dtype)], axis=1)
        if self.monotone_constraints is not None \
                or other.monotone_constraints is not None:
            a = (self.monotone_constraints
                 if self.monotone_constraints is not None
                 else np.zeros(base, np.int32))
            b = (other.monotone_constraints
                 if other.monotone_constraints is not None
                 else np.zeros(len(other.mappers), np.int32))
            self.monotone_constraints = np.concatenate([a, b])
        self._finalize_feature_arrays()
        self._place(bins, self.device)

    def save_binary(self, path: str) -> None:
        """The binary cache of ``io/cache.py`` (the JAX package's v2
        ``LGBMTPU2`` artifact)."""
        save_dataset_cache(self, path)

    @classmethod
    def load_binary(cls, path: str, device, expect_rank=None,
                    expect_world=None) -> "BinnedDataset":
        """A binary cache that either package wrote: the v2 ``LGBMTPU2``
        artifact (bins mmapped, regions verified; refused when written for
        another rank or world than ``expect_rank``/``expect_world``) or
        the JAX package's v1 pickle (``LGBMTPU1``). The bins reach
        ``device`` on first use, a v2 cache's through the prefetch."""
        magic = read_magic(path)
        self = cls()
        if magic == CACHE_MAGIC:
            bins, meta, manifest = load_dataset_cache(
                path, expect_rank=expect_rank, expect_world=expect_world)
            self.num_total_features = int(manifest["num_total_features"])
            self.reference_binned = bool(manifest.get("reference_binned",
                                                      False))
            self.ingest_stats = {"source": "cache", "cache_hit": 1,
                                 "cache_path": str(path),
                                 "chunks": int(manifest.get("chunks", 1)),
                                 "rows": int(manifest["num_data"]),
                                 "max_live_chunks": 0, "verified": True,
                                 "mmap": True}
        else:
            if magic != LEGACY_MAGIC:
                raise CacheError(f"{path}: not a binary dataset cache")
            with open(path, "rb") as fh:
                fh.read(8)
                meta = pickle.load(fh)
            bins = meta["bins"]
            self.num_total_features = int(meta["num_total_features"])
        self.bins = bins
        self.num_data = int(bins.shape[0])
        self.mappers = [BinMapper.from_dict(d) for d in meta["mappers"]]
        self.used_features = list(meta["used_features"])
        self.feature_names = list(meta.get("feature_names") or [])
        self.metadata = Metadata(self.num_data)
        if meta.get("label") is not None:
            self.metadata.set_label(meta["label"])
        self.metadata.weight = meta.get("weight")
        self.metadata.query_boundaries = meta.get("query_boundaries")
        self.metadata.init_score = meta.get("init_score")
        self.monotone_constraints = meta.get("monotone_constraints")
        self.dataset_params = dict(meta.get("dataset_params") or {})
        self.mp_sample_bins = meta.get("mp_sample_bins")
        self._finalize_feature_arrays()
        self.device = torch.device(device)
        return self

    def bin_rows(self, data: np.ndarray) -> np.ndarray:
        """Bin a [rows, num_total_features] float block against the mappers
        -> [rows, num_used_features] uint8/uint16. The one binning of raw
        rows: ``from_data`` and the streamed ingest's chunks both come
        here."""
        dtype = self.bin_dtype()
        dataT = np.ascontiguousarray(data.T)
        outT = np.empty((len(self.used_features), data.shape[0]), dtype)
        for k, j in enumerate(self.used_features):
            outT[k] = self.mappers[j].value_to_bin(dataT[j]).astype(
                dtype, copy=False)
        return np.ascontiguousarray(outT.T)

    @property
    def num_features(self) -> int:
        return len(self.used_features)

    def real_feature_index(self, inner_idx: int) -> int:
        return self.used_features[inner_idx]

    def default_bins(self) -> np.ndarray:
        return np.array([self.mappers[j].default_bin
                         for j in self.used_features], np.int32)

    def feature_infos(self) -> List[str]:
        """Per-original-feature info strings for the model text format
        (ref: gbdt_model_text.cpp feature_infos: ``[min:max]``, or a
        categorical feature's categories)."""
        infos = []
        for m in self.mappers:
            if m.is_trivial:
                infos.append("none")
            elif m.bin_type == BIN_CATEGORICAL:
                cats = sorted(m.bin_2_categorical[1:])
                infos.append("[" + ":".join(str(c) for c in cats) + "]")
            else:
                infos.append(f"[{m.min_val:g}:{m.max_val:g}]")
        return infos
