"""Two-pass chunked bin-and-pack: a text shard -> a binned dataset with
O(chunk) host residency.

PyTorch-port counterpart of ``lightgbm_tpu/ingest/pipeline.py``. Pass 1
streams the file once and collects exactly the rows the monolithic build
samples (``dataset._sample_rows`` over the rank's slice, the same
RandomState draw), so ``BinnedDataset.build_mappers_from_sample`` makes the
same mappers; under a parallel ``tree_learner`` it gathers the ranks'
samples as the monolithic build does. Pass 2 streams again and bins each
chunk through ``BinnedDataset.bin_rows`` (the monolithic binning) into the
preallocated bin matrix, or straight into a :class:`~..io.cache.
CacheWriter`, whose finished artifact is then memory-mapped back (the
reference's ``two_round`` loading, ref: dataset_loader.cpp).

A ``linear_tree`` build needs the raw values and takes the monolithic path.
The JAX pipeline's per-chunk mapper-drift counters wait for the training
side of the observability plane (ROADMAP Queue A item 10e).
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Optional, Tuple

import numpy as np

from ..io.file_loader import (_label_spec, compute_rank_slice,
                              load_sidecars, split_label_column)
from ..utils import log
from .chunker import iter_chunks, scan_layout, slice_start_offset
from .prefetch import IngestStats


def streaming_eligible(config, data) -> Tuple[bool, str]:
    """(eligible, reason): may this construct take the chunked ingest?
    When asked for (``two_round=true``, or an explicitly set
    ``ingest_chunk_rows``) and nothing needs the raw values."""
    if not isinstance(data, (str, os.PathLike)):
        return False, "not_a_file"
    if not (bool(config.two_round) or config.was_set("ingest_chunk_rows")):
        return False, "not_requested"
    if bool(config.linear_tree):
        return False, "linear_tree_needs_raw_data"
    return True, "ok"


def ingest_text_streamed(path: str, config, device, label_column=None,
                         rank: int = 0, num_machines: int = 1,
                         categorical_feature=(), feature_names=None,
                         reference=None, cache_out: Optional[str] = None,
                         world: int = 1):
    """Chunked two-pass build -> BinnedDataset (labels and sidecars in its
    metadata).

    With ``reference`` (a constructed BinnedDataset) pass 1 is skipped and
    the rows bin against its mappers (a valid file). With ``cache_out`` the
    packed chunks stream into a v2 cache artifact, which is loaded back
    memory-mapped instead of holding the bin matrix in RAM."""
    from ..binning import mappers_digest
    from ..dataset import BinnedDataset, Metadata, _sample_rows
    from ..io.cache import CacheWriter, dataset_meta, source_fingerprint

    chunk_rows = max(1, int(config.ingest_chunk_rows))
    layout = scan_layout(str(path))
    if layout.n_rows == 0:
        raise ValueError(f"no data rows in {path}")
    sl = compute_rank_slice(str(path), layout.n_rows, rank, num_machines)
    n = sl.stop - sl.start
    li = None if layout.is_libsvm else _label_spec(label_column,
                                                  layout.header_names)
    n_feat = layout.n_cols - 1 if layout.is_libsvm else (
        layout.n_cols - 1 if li is not None and 0 <= li < layout.n_cols
        else layout.n_cols)
    if not layout.is_libsvm and li is not None and li >= layout.n_cols:
        raise ValueError(
            f"label_column={li} out of range for {layout.n_cols}-column "
            f"file {path}")

    stats = IngestStats(source="text")
    # the byte offset of this rank's first row is walked once; both passes
    # start from it
    off0 = slice_start_offset(layout, sl.start)
    ds = BinnedDataset()
    ds.num_data = n
    ds.num_total_features = n_feat
    ds.feature_names = (list(feature_names) if feature_names
                        else [f"Column_{i}" for i in range(n_feat)])
    ds.metadata = Metadata(n)
    label = (np.empty((n,), np.float32)
             if layout.is_libsvm or (li is not None and li >= 0) else None)

    def _features_of(Xc, yc, row0):
        """A chunk's feature rows; its labels go into ``label``."""
        if layout.is_libsvm:
            if label is not None:
                label[row0:row0 + len(Xc)] = yc
            return Xc
        Xf, yl = split_label_column(Xc, li, layout.n_cols, str(path))
        if yl is not None and label is not None:
            label[row0:row0 + len(Xc)] = yl
        return Xf

    if reference is not None:
        ds._adopt_reference(reference)
    else:
        # ---- pass 1: the monolithic build's sample rows of this slice
        sample_idx = _sample_rows(n, config.bin_construct_sample_cnt,
                                  config.data_random_seed)
        sample = np.empty((len(sample_idx), n_feat), np.float64)
        filled = 0
        for row0, Xc, _ in iter_chunks(layout, chunk_rows, sl.start,
                                       sl.stop, start_offset=off0):
            stats.chunk_opened(len(Xc))
            lo_i = int(np.searchsorted(sample_idx, row0))
            hi_i = int(np.searchsorted(sample_idx, row0 + len(Xc)))
            if hi_i > lo_i:
                # only the sampled rows: dropping the label column commutes
                # with the row selection
                sub = Xc[sample_idx[lo_i:hi_i] - row0]
                if not layout.is_libsvm:
                    sub, _ = split_label_column(sub, li, layout.n_cols,
                                                str(path))
                sample[lo_i:hi_i] = np.asarray(sub, np.float64)
                filled += hi_i - lo_i
            stats.chunk_closed()
        log.check(filled == len(sample_idx),
                  f"ingest sample collected {filled} of "
                  f"{len(sample_idx)} rows")
        stats.sample_rows = len(sample_idx)
        ds.build_mappers_from_sample(
            sample, config, set(int(c) for c in categorical_feature))
        del sample

    # ---- pass 2: parse -> bin -> pack, chunk by chunk
    writer = None
    bins_out = None
    if cache_out is not None:
        writer = CacheWriter(cache_out, n, n_feat, ds.used_features,
                             ds.bin_dtype(), rank=rank, world=world)
    else:
        bins_out = np.empty((n, len(ds.used_features)), ds.bin_dtype())
    try:
        for row0, Xc, yc in iter_chunks(layout, chunk_rows, sl.start,
                                        sl.stop, start_offset=off0):
            stats.chunk_opened(len(Xc))
            packed = ds.bin_rows(_features_of(Xc, yc, row0))
            if writer is not None:
                writer.append_rows(packed)
            else:
                bins_out[row0:row0 + len(packed)] = packed
            stats.chunk_closed()
    except BaseException:
        if writer is not None:
            writer.abort()
        raise

    side = load_sidecars(str(path), sl, rank, num_machines)
    if label is not None:
        ds.metadata.set_label(label)
    if "weight" in side:
        ds.metadata.set_weight(side["weight"])
    if "group" in side:
        ds.metadata.set_group(side["group"])
    if "init_score" in side:
        ds.metadata.set_init_score(side["init_score"])
    if reference is None:
        ds._set_monotone(config, n_feat)

    if writer is not None:
        try:
            writer.source = source_fingerprint(
                str(path), dataset_params_digest(config, categorical_feature))
            writer.finalize(
                dataset_meta(ds), mappers_digest=mappers_digest(ds.mappers),
                extra={"reference_binned": bool(ds.reference_binned)})
        except BaseException:
            writer.abort()
            raise
        cached = BinnedDataset.load_binary(
            cache_out, device, expect_rank=rank, expect_world=world)
        cached.ingest_stats = dict(stats.to_dict(), source="text+cache",
                                   cache_path=str(cache_out), cache_hit=0)
        log.info("Streamed ingest wrote cache %s (%d rows, %d chunks)",
                 cache_out, n, stats.chunks)
        return cached

    ds._place(bins_out, device)
    ds.ingest_stats = stats.to_dict()
    log.info("Streamed ingest: %s -> %d rows x %d features in %d chunks "
             "(max %d live)", path, n, len(ds.used_features), stats.chunks,
             stats.max_live_chunks)
    return ds


def dataset_params_digest(config, categorical_feature=()) -> str:
    """Digest of the dataset-defining parameters: a sidecar cache built
    under other binning parameters misses. ``categorical_feature`` is the
    resolved index list (the constructor's, which the config key never
    sees)."""
    from ..dataset import _DATASET_DEFINING_KEYS
    keys = _DATASET_DEFINING_KEYS + (
        "label_column", "categorical_feature", "monotone_constraints",
        "linear_tree")
    d = {k: getattr(config, k, None) for k in keys}
    d["resolved_categorical_feature"] = sorted(
        int(c) for c in (categorical_feature or ()))
    return hashlib.sha256(
        json.dumps(d, sort_keys=True, default=str).encode()).hexdigest()
