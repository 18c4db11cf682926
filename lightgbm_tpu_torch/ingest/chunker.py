"""Bounded resumable text chunk iteration.

A copy of ``lightgbm_tpu/ingest/chunker.py`` over the port's native parser
(``native/loader.py``). One layout scan (the native ``lgbt_scan`` —
identical separator/header/LibSVM decisions to the monolithic load), then
row chunks parsed through
the native range parsers (``lgbt_parse_dense_range`` /
``lgbt_parse_libsvm_range``), which share the field parser with the
monolithic entry points — so every float a chunk yields is bit-identical
to what ``load_text_file`` would have produced for the same row.

The iterator tracks byte offsets across calls: streaming a whole file is
O(bytes) total, and skipping to a rank's row slice never materializes the
rows before it.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..native import loader as native


@dataclasses.dataclass
class TextLayout:
    """One scan's worth of file facts (ref: parser.cpp lgbt_scan)."""
    path: str
    sep: str
    n_rows: int
    n_cols: int
    is_libsvm: bool
    has_header: bool
    header_names: Optional[List[str]] = None


def scan_layout(path: str, force_header: Optional[bool] = None
                ) -> TextLayout:
    """Scan ``path`` once -> TextLayout (the same auto-detection +
    ``force_header`` override semantics as io.file_loader.load_text_file,
    so layout decisions cannot differ between the monolithic and the
    chunked path)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    sep, n_rows, n_cols, is_libsvm, has_header = native.scan(path)
    if force_header is not None and bool(force_header) != bool(has_header):
        if force_header and not has_header:
            n_rows -= 1   # the scan counted the numeric header as data
        elif has_header and not force_header:
            n_rows += 1
        has_header = bool(force_header)
    header_names = None
    if has_header:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith("#"):
                    header_names = [t.strip() for t in line.split(sep)]
                    break
    return TextLayout(path=path, sep=sep, n_rows=n_rows, n_cols=n_cols,
                      is_libsvm=bool(is_libsvm),
                      has_header=bool(has_header),
                      header_names=header_names)


def _skip_data_rows(layout: TextLayout, n_skip: int) -> int:
    """Byte offset just past the first ``n_skip`` data rows (header,
    blank and ``#`` comment lines excluded), without parsing a single
    float.  Line classification MUST mirror the parsers' (empty after
    CR/LF strip, or first char ``#`` — never a whole-line strip): a
    whitespace-only line is a DATA row to the scan and both parsers, so
    skipping it uncounted here would shift every later rank's slice."""
    if n_skip <= 0:
        return 0
    skipped = 0
    with open(layout.path, "rb") as f:
        first = True
        offset = 0
        while skipped < n_skip:
            raw = f.readline()
            if not raw:
                break
            line = raw.rstrip(b"\r\n")
            if not line or line.startswith(b"#"):
                offset = f.tell()
                continue
            if first and layout.has_header:
                first = False
                offset = f.tell()
                continue
            first = False
            skipped += 1
            offset = f.tell()
    return offset


def slice_start_offset(layout: TextLayout, start_row: int) -> int:
    """Byte offset of data row ``start_row`` — computed once and passed
    to repeated ``iter_chunks`` calls over the same slice (two-pass
    builds), so the pure-Python skip walk over the rows before a rank's
    slice is not paid per pass."""
    return _skip_data_rows(layout, start_row)


def iter_chunks(layout: TextLayout, chunk_rows: int, start_row: int = 0,
                stop_row: Optional[int] = None,
                start_offset: Optional[int] = None
                ) -> Iterator[Tuple[int, np.ndarray,
                                    Optional[np.ndarray]]]:
    """Yield ``(row0, X, label_or_None)`` chunks of at most
    ``chunk_rows`` rows covering data rows ``[start_row, stop_row)``.

    ``row0`` is relative to ``start_row`` (chunk placement index for the
    caller's slice). Dense chunks carry the FULL parsed row (label
    column included — extraction is the pipeline's job); LibSVM chunks
    carry features + the separated label. Exactly one chunk is live per
    iteration step; holding more is the caller's (instrumented)
    choice."""
    if chunk_rows <= 0:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    stop = layout.n_rows if stop_row is None else min(stop_row,
                                                      layout.n_rows)
    if start_row >= stop:
        return
    offset = (start_offset if start_offset is not None
              else _skip_data_rows(layout, start_row))
    # offset 0 means "file head" to the range parsers (header skipped
    # there); a positive offset is already past it
    row = start_row
    while row < stop:
        want = min(chunk_rows, stop - row)
        if layout.is_libsvm:
            X, y, offset = native.parse_libsvm_range(
                layout.path, offset, want, layout.n_cols)
        else:
            X, offset = native.parse_dense_range(
                layout.path, layout.sep, layout.has_header, offset,
                want, layout.n_cols)
            y = None
        if X.shape[0] == 0:
            raise IOError(
                f"{layout.path}: expected data rows up to {stop}, file "
                f"ended at row {row}")
        yield row - start_row, X, y
        row += X.shape[0]
