"""Atomic file writes: write a temp sibling, fsync, rename into place (a
copy of ``lightgbm_tpu/resilience/atomicio.py``, always fsynced).

POSIX ``rename`` within one filesystem is atomic, so any reader (a
resuming run, a model loader, the checkpoint selector) sees either the
previous complete file or the new complete file, never a truncation.
Every durable artifact of the port routes through these helpers: the
checkpoint arrays and manifests, ``Booster.save_model`` (and with it the
engine's ``snapshot_freq`` files) and the binary dataset cache
(``io/cache.py``, through :func:`atomic_stream`). The temp sibling is
``.<base>.tmp.<pid>``, as in the JAX package, and a failed write removes
it.
"""
from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Iterator


def _tmp_path(path: str) -> str:
    d, base = os.path.split(path)
    return os.path.join(d, f".{base}.tmp.{os.getpid()}")


@contextlib.contextmanager
def atomic_stream(path: str) -> Iterator[Any]:
    """A binary file object on the temp sibling of ``path``: on a clean
    exit it is fsynced and renamed into place, on any exception removed,
    and ``path`` is left untouched."""
    tmp = _tmp_path(path)
    try:
        with open(tmp, "wb") as fh:
            yield fh
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    finally:
        # a failed write must not litter temp files next to checkpoints
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` atomically (temp file + rename)."""
    with atomic_stream(path) as fh:
        fh.write(data)


def atomic_write_text(path: str, text: str) -> None:
    atomic_write_bytes(path, text.encode("utf-8"))


def atomic_write_json(path: str, obj: Any) -> None:
    atomic_write_text(path, json.dumps(obj, default=str))
