"""JSONL event sink for the telemetry registry.

A copy of ``lightgbm_tpu/obs/events.py`` (which imports no JAX; the port
keeps its own). One JSON object per line.  Schema:

- every record carries ``ts`` (unix seconds), ``rank`` (the
  ``torch.distributed`` rank, else 0) and ``event`` (name);
- events carry their attributes as flat extra keys.

Multi-process runs write one file per rank: rank 0 owns the configured
path, rank r writes ``<path>.rank<r>`` (a shared file over NFS would
interleave partial lines).

Lifecycle: the FIRST open of a path in this process truncates it (a
fresh run starts a fresh stream); any later re-open (a second service
pointed at the same file) appends, so an established stream is never
clobbered mid-process.
"""
from __future__ import annotations

import atexit
import json
import threading
from typing import Any, Dict

# paths this process has already opened: re-opens append (see module
# docstring) instead of truncating the earlier records
_OPENED_PATHS = set()


def _json_default(o: Any):
    """Last-resort coercion so numpy scalars / tensors in event
    attributes cannot kill the sink."""
    for cast in (int, float):
        try:
            return cast(o)
        except (TypeError, ValueError):
            continue
    return str(o)


class JsonlSink:
    """Line-buffered JSONL writer (one flush per record)."""

    def __init__(self, path: str, rank: int = 0):
        # the path as configured, before rank suffixing
        self.requested_path = path
        if rank:
            path = f"{path}.rank{rank}"
        self.path = path
        self._lock = threading.Lock()
        mode = "a" if path in _OPENED_PATHS else "w"
        self._fh = open(path, mode, buffering=1)
        _OPENED_PATHS.add(path)
        atexit.register(self.close)

    def write(self, record: Dict[str, Any]) -> None:
        line = json.dumps(record, separators=(",", ":"),
                          default=_json_default)
        with self._lock:
            if self._fh is not None:
                self._fh.write(line + "\n")

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
