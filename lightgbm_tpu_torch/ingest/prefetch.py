"""Chunked, double-buffered host-to-device copy of a dataset's bins.

PyTorch counterpart of ``lightgbm_tpu/ingest/prefetch.py``. A one-shot copy
widens the whole host matrix and copies it in one go; on a memory-mapped
cache that faults the whole artifact into host RAM and then makes a
second, widened copy of it. :func:`stream_to_device`
instead allocates the device matrix once and walks the host rows in chunks
of ``chunk_rows`` through two staging buffers (pinned on a card): chunk
*k*'s host rows are read (and its cache pages faulted in) while chunk
*k-1*'s copy is in flight on a side CUDA stream. Each chunk crosses in its
narrow dtype (uint8 bins as bytes, uint16 bins as their int16 bits) with
``copy_(non_blocking=True)`` and is widened to int16/int32 on the device,
which halves the bytes over PCIe; an event recorded after a chunk's copy
and widening is waited on before its staging buffer is refilled. So at
most two chunks are live on the host (``max_live_chunks <= 2``), and
``host_wait_ms`` counts the time the host waited for a buffer.

``BinnedDataset.bins_dev`` copies every dataset's bins through it, unless
``ingest_prefetch`` is false (then in one shot). The result is
``torch.equal`` to the one-shot copy's tensor: this is a transfer
schedule, not a data transform. On a CPU device the same schedule runs with
plain copies, so its counters are tested on the CPU. There is no fallback:
a failed copy raises. ``publish_ingest_stats`` of the JAX package waits for
the training telemetry (ROADMAP Queue A item 10e); the stats ride the
dataset as ``ingest_stats``.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch


class IngestStats:
    """Chunk residency and timing of one ingest (parse, bin, pack) or
    prefetch (host to device) pass. ``max_live_chunks`` is the bounded
    residency the tests assert on."""

    def __init__(self, source: str = "text"):
        self.source = source
        self.chunks = 0
        self.rows = 0
        self.live_chunks = 0
        self.max_live_chunks = 0
        self.cache_hit = 0
        self.host_wait_ms = 0.0
        self.sample_rows = 0
        self.pinned = False
        self.side_stream = False
        # ("fill" | "wait", buffer, chunk) in the order the host did them,
        # when ``trace`` is on (the card-only test reads it)
        self.trace: Optional[List[tuple]] = None

    def chunk_opened(self, rows: int = 0) -> None:
        self.chunks += 1
        self.rows += int(rows)
        self.live_chunks += 1
        self.max_live_chunks = max(self.max_live_chunks, self.live_chunks)

    def chunk_closed(self) -> None:
        self.live_chunks = max(0, self.live_chunks - 1)

    def to_dict(self) -> Dict[str, Any]:
        return {"source": self.source, "chunks": self.chunks,
                "rows": self.rows, "max_live_chunks": self.max_live_chunks,
                "cache_hit": self.cache_hit,
                "host_wait_ms": round(self.host_wait_ms, 3),
                "sample_rows": self.sample_rows, "pinned": self.pinned,
                "side_stream": self.side_stream}


def _narrow(dtype) -> torch.dtype:
    """The staging dtype of host bins: uint8 as bytes, uint16 as the bits
    of an int16 (widened on the device)."""
    return torch.uint8 if np.dtype(dtype) == np.uint8 else torch.int16


def _widen(chunk: torch.Tensor, out: torch.Tensor) -> None:
    """``out[:] = chunk`` read as unsigned, in ``out``'s wider dtype."""
    if chunk.dtype == torch.int16:
        out.copy_(chunk.to(torch.int32) & 0xFFFF)
    else:
        out.copy_(chunk)


def stream_to_device(bins: np.ndarray, chunk_rows: int, device,
                     stats: Optional[IngestStats] = None,
                     trace: bool = False) -> torch.Tensor:
    """Assemble the ``[n, f]`` device bins (int16 for uint8 host bins,
    int32 for uint16) from host ``bins`` in double-buffered row chunks of
    ``chunk_rows``; equal to the one-shot widened copy."""
    device = torch.device(device)
    if stats is None:
        stats = IngestStats(source="prefetch")
    if trace:
        stats.trace = []
    n, f = int(bins.shape[0]), int(bins.shape[1])
    wide = torch.int16 if np.dtype(bins.dtype) == np.uint8 else torch.int32
    out = torch.empty((n, f), dtype=wide, device=device)
    if n == 0 or f == 0:
        return out
    rows = max(1, min(int(chunk_rows), n))
    narrow = _narrow(bins.dtype)
    view = np.uint8 if narrow == torch.uint8 else np.int16
    on_card = device.type == "cuda"
    stage = [torch.empty((rows, f), dtype=narrow, pin_memory=on_card)
             for _ in range(2)]
    stats.pinned = on_card and all(b.is_pinned() for b in stage)
    if on_card:
        landing = [torch.empty((rows, f), dtype=narrow, device=device)
                   for _ in range(2)]
        side = torch.cuda.Stream(device=device)
        # the buffers were allocated on the current stream
        side.wait_stream(torch.cuda.current_stream(device))
        events = [None, None]
        stats.side_stream = True
    for i, lo in enumerate(range(0, n, rows)):
        hi = min(n, lo + rows)
        k = i % 2
        if on_card and events[k] is not None:
            # the buffer's last copy must be done before it is refilled
            t0 = time.perf_counter()
            events[k].synchronize()
            stats.host_wait_ms += (time.perf_counter() - t0) * 1000.0
            if trace:
                stats.trace.append(("wait", k, i - 2))
            stats.chunk_closed()
            events[k] = None
        stats.chunk_opened(hi - lo)
        if trace:
            stats.trace.append(("fill", k, i))
        host = stage[k][:hi - lo]
        np.copyto(host.numpy(), np.asarray(bins[lo:hi]).view(view))
        if on_card:
            with torch.cuda.stream(side):
                dev = landing[k][:hi - lo]
                dev.copy_(host, non_blocking=True)
                _widen(dev, out[lo:hi])
                ev = torch.cuda.Event()
                ev.record(side)
            events[k] = ev
        else:
            _widen(host, out[lo:hi])
            stats.chunk_closed()
    if on_card:
        for k in (0, 1):
            if events[k] is not None:
                t0 = time.perf_counter()
                events[k].synchronize()
                stats.host_wait_ms += (time.perf_counter() - t0) * 1000.0
                stats.chunk_closed()
        torch.cuda.current_stream(device).wait_stream(side)
    return out
