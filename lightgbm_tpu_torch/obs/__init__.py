"""Serving telemetry of the port: the part of ``lightgbm_tpu/obs/`` that
``serve/`` needs.

- :class:`Telemetry` (registry.py) — counters, gauges, value
  distributions with p50/p95/p99, the structured event stream and the
  CUDA memory watermarks;
- :class:`JsonlSink` (events.py) — the JSONL writer behind
  ``telemetry_out=<path>``;
- reqtrace.py — request-scoped serving traces: a ``trace_id`` minted at
  ``PredictionService.submit()`` rides through the micro-batcher and the
  engine's dispatch into one ``serve_access`` record per request.
"""
from .events import JsonlSink
from .registry import Telemetry

__all__ = ["Telemetry", "JsonlSink"]
