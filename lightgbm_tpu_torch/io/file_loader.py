"""Text data files: CSV, TSV and LibSVM.

A copy of ``lightgbm_tpu/io/file_loader.py`` over the port's native parser
(ref: src/io/dataset_loader.cpp:203 LoadFromFile, parser.cpp format
detection): the format is detected by the layout scan, the label column
taken from ``label_column`` (an index, ``name:<col>`` against the header,
-1 for none; LibSVM's label is its first token), and the reference's
sidecar files read: ``<file>.weight`` (a weight per row),
``<file>.query``/``.group`` (query sizes) and ``<file>.init`` (init
scores; ref: src/io/metadata.cpp).

Under ranks each rank parses only its contiguous row slice
(:func:`compute_rank_slice`; aligned to whole queries when a query sidecar
exists, clamped to empty slices when there are more ranks than rows),
through the resumable chunk iterator of ``ingest/chunker.py``. The fully
streamed build is ``ingest/pipeline.py``; this module gives the shard as
one array.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..native import loader as native
from ..utils import log


def _label_spec(label_column, header_names):
    """-> the label's column index (ref: config.h label_column)."""
    if label_column in (None, ""):
        return 0
    if isinstance(label_column, int):
        return label_column
    s = str(label_column)
    if s.startswith("name:"):
        name = s[5:]
        if header_names and name in header_names:
            return header_names.index(name)
        raise ValueError(f"label column name '{name}' not in header")
    return int(s)


def query_sidecar_path(path: str) -> Optional[str]:
    return next((path + sfx for sfx in (".query", ".group")
                 if os.path.exists(path + sfx)), None)


# the last query sidecar parsed, keyed by its file state: the rank slice and
# the sidecar loader both need the sizes
_QUERY_SIZES_CACHE: dict = {}


def _query_sizes(path: str) -> np.ndarray:
    st = os.stat(path)
    key = (st.st_mtime_ns, st.st_size)
    cached = _QUERY_SIZES_CACHE.get(path)
    if cached is not None and cached[0] == key:
        return cached[1]
    vals = np.loadtxt(path, dtype=np.float64, ndmin=1)
    _QUERY_SIZES_CACHE.clear()
    _QUERY_SIZES_CACHE[path] = (key, vals)
    return vals


def compute_rank_slice(path: str, n_rows: int, rank: int,
                       num_machines: int) -> slice:
    """This rank's contiguous row slice of an ``n_rows``-row file. With a
    query sidecar the cuts move to query boundaries, so every rank holds
    whole queries (ref: metadata.cpp:141 CheckOrPartition). The monolithic
    loader and the streamed pipeline both slice here."""
    if num_machines <= 1:
        return slice(0, n_rows)
    qside = query_sidecar_path(path)
    if qside is not None:
        ends = np.cumsum(_query_sizes(qside).astype(np.int64))
        if int(ends[-1]) != n_rows:
            raise ValueError(
                f"query sizes sum to {int(ends[-1])} but the file has "
                f"{n_rows} rows")
        cuts = [0]
        for r in range(1, num_machines):
            target = (r * n_rows) // num_machines
            qi = int(np.searchsorted(ends, target, side="left"))
            cuts.append(int(ends[min(qi, len(ends) - 1)]))
        cuts.append(n_rows)
        return slice(cuts[rank], cuts[rank + 1])
    per = (n_rows + num_machines - 1) // num_machines
    # both bounds clamped: with more ranks than rows the last ranks hold
    # an empty slice, never a negative one
    return slice(min(n_rows, rank * per), min(n_rows, (rank + 1) * per))


def load_sidecars(path: str, sl: slice, rank: int,
                  num_machines: int) -> dict:
    """``<file>.weight``/``.query``/``.group``/``.init`` sliced to this
    rank's rows -> {"weight"?, "group"?, "init_score"?}."""
    side = {}
    for suffix, key in ((".weight", "weight"), (".query", "group"),
                        (".group", "group"), (".init", "init_score")):
        sp = path + suffix
        if not os.path.exists(sp):
            continue
        vals = (_query_sizes(sp) if key == "group"
                else np.loadtxt(sp, dtype=np.float64, ndmin=1))
        if key == "group":
            if num_machines > 1:
                # whole queries: those whose rows lie in this rank's slice
                ends = np.cumsum(vals.astype(np.int64))
                starts = ends - vals.astype(np.int64)
                keep = (starts >= sl.start) & (ends <= sl.stop)
                if not keep.any() or \
                        int(vals[keep].sum()) != sl.stop - sl.start:
                    log.warning(
                        "rank %d row slice cuts through query "
                        "boundaries; group sizes clipped to the slice",
                        rank)
                    clipped = (np.minimum(ends, sl.stop)
                               - np.maximum(starts, sl.start))
                    side[key] = clipped[clipped > 0]
                else:
                    side[key] = vals[keep].astype(np.int64)
            else:
                side[key] = vals.astype(np.int64)
        else:
            side[key] = vals[sl]
        log.info("Loaded %s from %s", key, sp)
    return side


def split_label_column(data: np.ndarray, li: Optional[int], n_cols: int,
                       path: str):
    """Parsed dense rows -> (X, y); ``li`` < 0 means no label column."""
    if li is None or li < 0:
        return data, None
    if li >= n_cols:
        raise ValueError(
            f"label_column={li} out of range for {n_cols}-column file "
            f"{path}")
    y = data[:, li].copy()
    X = np.delete(data, li, axis=1)
    return X, y


def load_text_file(path: str, label_column=None, rank: int = 0,
                   num_machines: int = 1, force_header: bool = None
                   ) -> Tuple[np.ndarray, Optional[np.ndarray], dict]:
    """Parse a CSV/TSV/LibSVM file -> (X float32, label or None,
    sidecars). ``force_header`` overrides the scan's header detection (an
    all-numeric header line reads as data otherwise)."""
    from ..ingest.chunker import iter_chunks, scan_layout
    layout = scan_layout(path, force_header=force_header)
    n_rows, n_cols = layout.n_rows, layout.n_cols
    if n_rows == 0:
        raise ValueError(f"no data rows in {path}")
    sl = compute_rank_slice(path, n_rows, rank, num_machines)

    if num_machines > 1:
        # only this rank's slice is parsed
        n_local = sl.stop - sl.start
        if layout.is_libsvm:
            X = np.empty((n_local, n_cols - 1), np.float32)
            y = np.empty((n_local,), np.float32)
            for row0, Xc, yc in iter_chunks(layout, 1 << 18, sl.start,
                                            sl.stop):
                X[row0:row0 + len(Xc)] = Xc
                y[row0:row0 + len(Xc)] = yc
        else:
            data = np.empty((n_local, n_cols), np.float32)
            for row0, Xc, _ in iter_chunks(layout, 1 << 18, sl.start,
                                           sl.stop):
                data[row0:row0 + len(Xc)] = Xc
            li = _label_spec(label_column, layout.header_names)
            X, y = split_label_column(data, li, n_cols, path)
    elif layout.is_libsvm:
        X, y = native.parse_libsvm(path, n_rows, n_cols)
    else:
        data = native.parse_dense(path, layout.sep, layout.has_header,
                                  n_rows, n_cols)
        li = _label_spec(label_column, layout.header_names)
        X, y = split_label_column(data, li, n_cols, path)

    return X, y, load_sidecars(path, sl, rank, num_machines)
