"""Structured serving errors + the client retry policy.

A copy of ``lightgbm_tpu/serve/errors.py`` (which imports no JAX; the port
keeps its own).

Under open-loop overload a serving queue without admission control
grows without bound and p99 diverges; the fix is *structured rejection*
— a refused or shed request must carry machine-readable fields (reason,
retry-after hint, queue state) a client-side policy can act on, not a
bare string.  Every error below extends ``RuntimeError`` so existing
``except RuntimeError`` call sites keep working.

Taxonomy:

- :class:`ServeRejected` — admission refusal AT SUBMIT: the bounded
  queue (``max_queue_rows`` / ``max_queue_requests``, or the adaptive
  controller's shed watermark) is full.  Raised synchronously from
  ``submit()``; carries ``retry_after_ms`` (backlog / measured drain
  rate).  Retryable.
- :class:`ServeDeadlineExceeded` — the request's deadline passed while
  it waited in the queue; it is shed AT DEQUEUE, before any device work
  is spent on it.  Retryable (the service shed it unserved).
- :class:`ServeClosed` — submit after ``close()``, or a queued request
  failed by a bounded drain (``close(drain_timeout_s=)``).  Not
  retryable: the service is going away.
- :class:`ServeWorkerWedged` — the worker thread did not exit within
  the close timeout (stuck inside a device dispatch); queued and
  in-flight futures are failed with this instead of leaking unresolved.
  Not retryable.

Compute errors (a poisoned request, a device failure inside the
dispatch) are deliberately NOT in this hierarchy: they resolve the
affected futures with the original exception, and :class:`RetryPolicy`
never retries them — retrying a deterministic failure only doubles the
damage.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple


class ServeError(RuntimeError):
    """Base of the structured serving errors; ``details()`` returns the
    machine-readable fields as a plain dict (what the telemetry event
    carries)."""

    def __init__(self, message: str, **fields: Any):
        super().__init__(message)
        self.fields = dict(fields)

    def details(self) -> Dict[str, Any]:
        return {"error": type(self).__name__,
                "message": str(self), **self.fields}


class ServeRejected(ServeError):
    """Admission control refused the request at submit time.

    Fields: ``reason`` (``queue_rows`` / ``queue_requests`` /
    ``shed_watermark``), ``retry_after_ms`` (estimated backlog drain
    time), ``queue_rows``, ``queue_requests``, ``model_id``."""

    def __init__(self, message: str, reason: str = "",
                 retry_after_ms: float = 0.0, **fields: Any):
        super().__init__(message, reason=reason,
                         retry_after_ms=round(float(retry_after_ms), 3),
                         **fields)
        self.reason = reason
        self.retry_after_ms = float(retry_after_ms)


class ServeDeadlineExceeded(ServeError):
    """The request's deadline expired while it was still queued; it was
    shed before dispatch (no device work spent).

    Fields: ``deadline_ms``, ``waited_ms``, ``model_id``,
    ``trace_id``."""

    def __init__(self, message: str, retry_after_ms: float = 0.0,
                 **fields: Any):
        super().__init__(message,
                         retry_after_ms=round(float(retry_after_ms), 3),
                         **fields)
        self.retry_after_ms = float(retry_after_ms)


class ServeClosed(ServeError):
    """The service/batcher is closed (or a bounded drain gave up on the
    remaining queue)."""


class ServeWorkerWedged(ServeError):
    """The batcher worker did not exit within the close timeout —
    wedged inside a dispatch.  Queued + in-flight futures are failed
    with this so nothing leaks unresolved."""


#: errors a retry can reasonably help with: the service refused or shed
#: the request WITHOUT doing its work.  Everything else (compute
#: errors, closed service, wedged worker) must surface immediately.
RETRYABLE = (ServeRejected, ServeDeadlineExceeded)


class RetryPolicy:
    """Capped-exponential-backoff retry for ``PredictionService.predict``.

    Retries ONLY on shed/reject (:data:`RETRYABLE`) — never on compute
    errors — with ``backoff = base * multiplier**attempt`` capped at
    ``max_backoff_ms``, and honors a larger server-provided
    ``retry_after_ms`` hint when one rides the error: bounded attempts,
    transient-only, the last failure re-raises untouched.

    ``max_elapsed_s`` additionally bounds the total time spent
    (attempts + sleeps): a client with its own deadline should not
    out-wait it retrying.
    """

    def __init__(self, max_attempts: int = 4,
                 base_backoff_ms: float = 5.0,
                 backoff_multiplier: float = 2.0,
                 max_backoff_ms: float = 2000.0,
                 max_elapsed_s: Optional[float] = None):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base_backoff_ms = float(base_backoff_ms)
        self.backoff_multiplier = float(backoff_multiplier)
        self.max_backoff_ms = float(max_backoff_ms)
        self.max_elapsed_s = (None if max_elapsed_s is None
                              else float(max_elapsed_s))

    # ------------------------------------------------------------------
    def backoff_ms(self, attempt: int,
                   exc: Optional[BaseException] = None) -> float:
        """Sleep before retry number ``attempt`` (0-based): capped
        exponential, never shorter than the service's own
        ``retry_after_ms`` hint (the server knows its backlog better
        than the client's curve does)."""
        b = min(self.max_backoff_ms,
                self.base_backoff_ms * self.backoff_multiplier ** attempt)
        hint = float(getattr(exc, "retry_after_ms", 0.0) or 0.0)
        return max(b, min(hint, self.max_backoff_ms))

    def should_retry(self, exc: BaseException, attempt: int) -> bool:
        return isinstance(exc, RETRYABLE) \
            and attempt + 1 < self.max_attempts

    # ------------------------------------------------------------------
    def call(self, fn, telemetry=None) -> Any:
        """Run ``fn()`` under the policy; returns its result or raises
        the final error.  Telemetry: ``serve.retries`` per retry,
        ``serve.retry_exhausted`` when attempts run out."""
        t0 = time.perf_counter()
        attempt = 0
        while True:
            try:
                return fn()
            except RETRYABLE as exc:
                elapsed = time.perf_counter() - t0
                delay_s = self.backoff_ms(attempt, exc) / 1000.0
                budget_ok = self.max_elapsed_s is None or \
                    (elapsed + delay_s) < self.max_elapsed_s
                if not (self.should_retry(exc, attempt) and budget_ok):
                    if telemetry is not None:
                        telemetry.inc("serve.retry_exhausted")
                    raise
                if telemetry is not None:
                    telemetry.inc("serve.retries")
                time.sleep(delay_s)
                attempt += 1

    def stats(self) -> Tuple[int, float, float]:
        return (self.max_attempts, self.base_backoff_ms,
                self.max_backoff_ms)
