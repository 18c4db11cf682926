"""Micro-batching request queue with admission control and fleet lanes.

PyTorch-port copy of ``lightgbm_tpu/serve/batcher.py``: the same queue,
coalescing, admission, deadlines, wedge detection and fleet lanes; the
fault-injection hook (``resilience/faults.py``) waits for ROADMAP Queue A
item 10.

Per-request dispatch is what makes naive serving slow: every request
pays a host→device→host round trip.  The batcher coalesces concurrent
requests for the same model into ONE device call — the serving analog
of the training megastep's dispatch amortization:

- ``submit()`` enqueues a request and returns a
  ``concurrent.futures.Future`` immediately (the async form; ``predict``
  on the service is ``submit().result()``);
- a worker thread drains its queue: it takes the oldest request,
  pulls every queued request for the SAME model, and keeps waiting for
  more until either ``max_batch_rows`` rows are assembled or
  ``max_delay_ms`` has passed since the oldest request arrived — the
  classic deadline-coalescing loop;
- the assembled batch is one engine call (≤1 host dispatch per
  micro-batch when the batch fits one bucket), and each requester's
  slice resolves its future.

Fleet mode (``n_lanes > 1``): one LANE — queue + condition + worker
thread — per serve device (on one card, per replica: each lane has its
own CUDA stream). A submit is routed to the least-loaded lane (queued +
in-flight rows weighted by the lane's measured per-row batch EWMA;
all-idle ties rotate round-robin so a sequential closed loop still
exercises every lane), or in turns with ``routing="round_robin"``, and
the dispatch callback receives the lane index so the service resolves it
against that lane's model replica. Admission caps split evenly across
lanes, and a submit its routed lane would reject SPILLS to the coldest
lane with room before it is shed (``serve.spills``). Per-lane gauges
(``serve.d<i>.queue_depth`` / ``queue_rows``) publish next to the
aggregate ones. With one lane the dispatch callback keeps its
two-argument form ``(model_id, X)``.

Overload hardening:

- **bounded queue** — ``max_queue_rows`` / ``max_queue_requests`` cap
  the backlog; a submit that would overflow raises a structured
  :class:`~.errors.ServeRejected` synchronously, carrying a
  ``retry_after_ms`` hint derived from the measured drain rate.  The
  adaptive controller (admission.py) can lower the effective bound
  below the hard cap via ``shed_watermark_rows``;
- **deadlines** — ``submit(deadline_ms=)`` (or the service-level
  ``default_deadline_ms``) stamps each request; expired requests are
  SHED AT DEQUEUE with :class:`~.errors.ServeDeadlineExceeded` —
  before any device work is spent on them, never after;
- **bounded drain + wedge detection** — ``close(drain_timeout_s=)``
  sheds whatever a timed-out drain leaves with structured
  ``ServeClosed`` errors, and a worker that does not exit (stuck inside
  a device dispatch) is detected: queued AND in-flight futures are
  failed with :class:`~.errors.ServeWorkerWedged` and a
  ``serve_worker_wedged`` event fires instead of silently leaking
  unresolved futures.

Failures resolve the affected futures with the exception — a poisoned
request cannot wedge the queue.  Telemetry: queue-depth/rows gauges,
refreshed on submit, drain AND shed so a stalled worker's backlog is
visible between drains (+ peak watermarks), batch-size and latency
distributions, ``serve.rejected``/``serve.shed``/``serve.spills``
counters, ``serve_batch`` events.
"""
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..obs import reqtrace
from .errors import (ServeClosed, ServeDeadlineExceeded, ServeRejected,
                     ServeWorkerWedged)

# grace after an aborted drain before a worker is declared wedged:
# long enough for a healthy worker to notice the abort flag (it checks
# between batches, and a batch is bounded by max_delay + one dispatch)
_WEDGE_GRACE_S = 5.0
# serve_rejected / serve_spill events are rate-limited (the counters
# are exact; the event ring must not be flooded by an open-loop storm)
_REJECT_EVENT_PERIOD_S = 0.5


class _Request:
    __slots__ = ("model_id", "X", "rows", "cols", "future", "t_submit",
                 "sparse", "trace_id", "deadline")

    def __init__(self, model_id: str, X, rows: int, sparse: bool,
                 deadline_ms: Optional[float] = None):
        self.model_id = model_id
        self.X = X
        self.rows = rows
        self.cols = int(X.shape[1])
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        self.sparse = sparse
        # request identity (obs/reqtrace.py): minted HERE, the moment
        # the request exists — every downstream record (serve_access
        # JSONL line, Perfetto serve-track span) quotes it, and the
        # caller reads it back off future.trace_id
        self.trace_id = reqtrace.mint_trace_id()
        self.future.trace_id = self.trace_id
        # absolute shed deadline on the worker's clock; None = never
        self.deadline = (None if not deadline_ms or deadline_ms <= 0
                         else self.t_submit + float(deadline_ms) / 1000.0)


def _resolve(future: Future, result=None, exc=None) -> None:
    """set_result/set_exception tolerant of a client cancel() racing the
    delivery — an InvalidStateError here would kill a worker thread and
    wedge every future request behind it."""
    try:
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(result)
    except Exception:
        pass   # cancelled between the done() check and delivery


class _Lane:
    """One dispatch queue + worker (one per serve device in fleet mode).
    The condition shares the batcher's single mutex: routing reads every
    lane's load under one lock; workers only wake for their own queue."""

    __slots__ = ("index", "cv", "q", "q_rows", "inflight", "busy_rows",
                 "ewma_ms_per_row", "worker")

    def __init__(self, index: int, mu: threading.Lock):
        self.index = index
        self.cv = threading.Condition(mu)
        self.q: collections.deque = collections.deque()
        self.q_rows = 0
        self.inflight: List[_Request] = []
        self.busy_rows = 0          # rows of the batch being dispatched
        self.ewma_ms_per_row: Optional[float] = None
        self.worker: Optional[threading.Thread] = None


class MicroBatcher:
    """Deadline-coalescing request queue in front of a dispatch fn."""

    def __init__(self, dispatch: Callable[..., np.ndarray],
                 max_batch_rows: int = 8192, max_delay_ms: float = 2.0,
                 telemetry=None, batch_events: bool = True,
                 memory_watermarks: bool = True,
                 max_queue_rows: int = 0, max_queue_requests: int = 0,
                 default_deadline_ms: float = 0.0,
                 n_lanes: int = 1, routing: str = "least_loaded"):
        self._dispatch = dispatch
        self.max_batch_rows = int(max_batch_rows)
        self.max_delay_s = float(max_delay_ms) / 1000.0
        self.tel = telemetry
        self.batch_events = batch_events
        self.memory_watermarks = bool(memory_watermarks)
        # admission control (0 = unbounded, the pre-hardening contract)
        self.max_queue_rows = max(0, int(max_queue_rows or 0))
        self.max_queue_requests = max(0, int(max_queue_requests or 0))
        self.default_deadline_ms = max(0.0, float(default_deadline_ms
                                                  or 0.0))
        # adaptive lever (admission.AdmissionController): a row bound
        # UNDER the hard cap; None = inactive
        self.shed_watermark_rows: Optional[int] = None
        # post-batch hook (the admission controller's step); best-effort
        self.on_batch_done: Optional[Callable[[], None]] = None
        self.n_lanes = max(1, int(n_lanes or 1))
        self.routing = str(routing or "least_loaded")
        if self.routing not in ("least_loaded", "round_robin"):
            raise ValueError(f"routing must be 'least_loaded' or "
                             f"'round_robin', not {self.routing!r}")
        self._mu = threading.Lock()
        self._lanes = [_Lane(i, self._mu) for i in range(self.n_lanes)]
        self._rr = self.n_lanes - 1   # rotating tie-break cursor
        self._stop = False
        self._abort_drain = False
        self._wedged = False
        # measured drain rate (EWMA over completed batches, all lanes)
        # feeding the retry_after_ms hint on rejections
        self._ewma_batch_ms: Optional[float] = None
        self._ewma_batch_rows: Optional[float] = None
        self._last_reject_event = 0.0
        self._last_spill_event = 0.0
        for lane in self._lanes:
            suffix = f"-d{lane.index}" if self.n_lanes > 1 else ""
            lane.worker = threading.Thread(
                target=self._loop, args=(lane,),
                name=f"lgbm-serve-batcher{suffix}", daemon=True)
            lane.worker.start()

    # ---------------------------------------------------- introspection
    @property
    def _q(self) -> collections.deque:
        """Lane 0's queue (the queue when ``n_lanes == 1``)."""
        return self._lanes[0].q

    @property
    def _q_rows(self) -> int:
        """Queued rows across lanes."""
        return sum(lane.q_rows for lane in self._lanes)

    @property
    def _inflight(self) -> List[_Request]:
        return [r for lane in self._lanes for r in lane.inflight]

    # ------------------------------------------------------- admission
    def _retry_after_ms(self) -> float:
        """Backlog / measured drain rate — the hint a rejected client
        should wait before resubmitting.  Before any batch completed,
        fall back to twice the coalescing delay."""
        if self._ewma_batch_ms and self._ewma_batch_rows:
            # rows/ms per lane; the fleet drains n_lanes of them
            rate = (self._ewma_batch_rows / self._ewma_batch_ms
                    * self.n_lanes)
            if rate > 0:
                return min(10_000.0, max(1.0, self._q_rows / rate))
        return max(1.0, self.max_delay_s * 2000.0)

    def _lane_caps(self) -> Tuple[int, int, Optional[int]]:
        """Per-lane (row cap, request cap, watermark): the global bounds
        split evenly (ceil) across lanes; 0/None = unbounded."""
        n = self.n_lanes
        cap_rows = -(-self.max_queue_rows // n) \
            if self.max_queue_rows else 0
        cap_reqs = -(-self.max_queue_requests // n) \
            if self.max_queue_requests else 0
        wm = self.shed_watermark_rows
        wm_lane = None if wm is None else max(1, -(-int(wm) // n))
        return cap_rows, cap_reqs, wm_lane

    def _admission_reason(self, lane: _Lane, rows: int) -> Optional[str]:
        """Why this submit must be rejected by ``lane``, or None.  Caller
        holds the lock.  A single oversized request against an EMPTY lane
        always admits (it could otherwise never be served; the engine
        chunks it), matching the max_batch_rows oversized-single
        semantics."""
        cap_rows, cap_reqs, wm = self._lane_caps()
        if cap_reqs and len(lane.q) + 1 > cap_reqs:
            return "queue_requests"
        # effective row bound: the hard cap tightened by the adaptive
        # watermark (either may be unset)
        eff = min(cap_rows, wm) if (cap_rows and wm is not None) \
            else (wm if wm is not None else cap_rows)
        if eff and lane.q_rows + rows > eff and (lane.q or rows <= eff):
            return "shed_watermark" \
                if wm is not None and eff != cap_rows else "queue_rows"
        return None

    # --------------------------------------------------------- routing
    def _lane_load(self, lane: _Lane) -> float:
        """Estimated ms of work ahead of a request routed here: queued
        + in-flight rows weighted by the lane's measured per-row batch
        EWMA (a neutral weight before any batch completed)."""
        w = lane.ewma_ms_per_row
        if w is None or w <= 0:
            w = 1.0
        return (lane.q_rows + lane.busy_rows) * w

    def _pick_lane(self) -> _Lane:
        """Least-loaded lane; ties (the all-idle closed loop) rotate
        round-robin from the last pick so every lane warms and the fleet
        contract is measurable per lane. Caller holds the lock."""
        n = self.n_lanes
        if n == 1:
            return self._lanes[0]
        if self.routing == "round_robin":
            self._rr = (self._rr + 1) % n
            return self._lanes[self._rr]
        best, best_load = None, 0.0
        for off in range(n):
            lane = self._lanes[(self._rr + 1 + off) % n]
            load = self._lane_load(lane)
            if best is None or load < best_load:
                best, best_load = lane, load
        self._rr = best.index
        return best

    def _spill_lane(self, rows: int, exclude: int) -> Optional[_Lane]:
        """Coldest OTHER lane that admits ``rows`` — tried before a
        shed. Caller holds the lock."""
        cands = sorted((lane for lane in self._lanes
                        if lane.index != exclude), key=self._lane_load)
        for lane in cands:
            if self._admission_reason(lane, rows) is None:
                return lane
        return None

    # ------------------------------------------------------------------
    def submit(self, model_id: str, X,
               deadline_ms: Optional[float] = None) -> Future:
        from ..basic import _is_scipy_sparse
        sparse = _is_scipy_sparse(X)
        if not sparse:
            X = np.asarray(X)
            if X.ndim == 1:
                X = X.reshape(1, -1)
            if X.dtype.kind not in "fiub":
                # coerce non-numeric input HERE, synchronously: a bad
                # request must raise in its own submit call, not poison
                # the np.concatenate of a whole coalesced batch
                X = X.astype(np.float64)
        eff_deadline = (self.default_deadline_ms
                        if deadline_ms is None else float(deadline_ms))
        req = _Request(model_id, X, int(X.shape[0]), sparse,
                       deadline_ms=eff_deadline)
        reject: Optional[ServeRejected] = None
        spilled = False
        with self._mu:
            if self._stop or self._wedged:
                exc = ServeWorkerWedged(
                    "MicroBatcher worker is wedged", model_id=model_id) \
                    if self._wedged else ServeClosed(
                        "MicroBatcher is closed", model_id=model_id)
                req.future.set_exception(exc)
                self._emit_failed(req, type(exc).__name__)
                return req.future
            lane = self._pick_lane()
            reason = self._admission_reason(lane, req.rows)
            if reason is not None and self.n_lanes > 1:
                # admission spill: the coldest lane with room takes the
                # request before admission control sheds it
                alt = self._spill_lane(req.rows, exclude=lane.index)
                if alt is not None:
                    lane, reason, spilled = alt, None, True
            if reason is None:
                lane.q.append(req)
                lane.q_rows += req.rows
                gauges = self._queue_gauges_locked(lane)
                lane.cv.notify()
            else:
                reject = ServeRejected(
                    f"serving queue full ({reason}); retry after "
                    f"~{self._retry_after_ms():.0f} ms",
                    reason=reason,
                    retry_after_ms=self._retry_after_ms(),
                    queue_rows=self._q_rows,
                    queue_requests=sum(len(ln.q) for ln in self._lanes),
                    model_id=model_id)
        if reject is not None:
            # telemetry OUTSIDE the queue lock: a JSONL sink write must
            # never serialize submitters against the workers
            if self.tel is not None:
                self.tel.inc("serve.rejected")
                self.tel.inc("serve.rejected_rows", req.rows)
                now = time.perf_counter()
                if now - self._last_reject_event > _REJECT_EVENT_PERIOD_S:
                    self._last_reject_event = now
                    self._record(lambda: self.tel.event(
                        "serve_rejected", **reject.details()))
            raise reject
        if self.tel is not None:
            self._publish_queue_gauges(gauges, peaks=True)
            self.tel.inc("serve.requests")
            self.tel.inc("serve.rows", req.rows)
            if self.n_lanes > 1:
                self.tel.inc(f"serve.d{lane.index}.requests")
                self.tel.inc(f"serve.d{lane.index}.rows", req.rows)
            if spilled:
                self.tel.inc("serve.spills")
                self.tel.inc(f"serve.d{lane.index}.spills")
                now = time.perf_counter()
                if now - self._last_spill_event > _REJECT_EVENT_PERIOD_S:
                    self._last_spill_event = now
                    self._record(lambda: self.tel.event(
                        "serve_spill", model_id=model_id,
                        rows=req.rows, to_device=lane.index))
        return req.future

    # ---------------------------------------------------------- gauges
    def _queue_gauges_locked(self, lane: Optional[_Lane] = None):
        """Snapshot (aggregate depth, aggregate rows, [(lane, depth,
        rows)]) under the lock; published outside it."""
        agg_d = sum(len(ln.q) for ln in self._lanes)
        agg_r = sum(ln.q_rows for ln in self._lanes)
        per = None
        if self.n_lanes > 1:
            lanes = self._lanes if lane is None else [lane]
            per = [(ln.index, len(ln.q), ln.q_rows) for ln in lanes]
        return agg_d, agg_r, per

    def _publish_queue_gauges(self, gauges, peaks: bool = False) -> None:
        if self.tel is None:
            return
        agg_d, agg_r, per = gauges
        self.tel.gauge("serve.queue_depth", agg_d)
        self.tel.gauge("serve.queue_rows", agg_r)
        if peaks:
            self.tel.gauge_max("serve.queue_peak_requests", agg_d)
            self.tel.gauge_max("serve.queue_peak_rows", agg_r)
        for i, d, r in (per or ()):
            self.tel.gauge(f"serve.d{i}.queue_depth", d)
            self.tel.gauge(f"serve.d{i}.queue_rows", r)

    def _regauge(self, lane: _Lane) -> None:
        """Refresh the queue gauges from a worker (drain/shed paths) —
        best-effort, never on the submit fast path's lock hold."""
        with self._mu:
            gauges = self._queue_gauges_locked(lane)
        self._record(self._publish_queue_gauges, gauges)

    # ------------------------------------------------------- deadlines
    @staticmethod
    def _expired(req: _Request, now: float) -> bool:
        return req.deadline is not None and now >= req.deadline

    def _shed(self, reqs: List[_Request]) -> None:
        """Fail expired requests BEFORE any device work is spent on
        them: structured error, counter, one serve_access record each
        (error="ServeDeadlineExceeded") — shed requests trace too."""
        now = time.perf_counter()
        for r in reqs:
            waited_ms = (now - r.t_submit) * 1000.0
            deadline_ms = 0.0 if r.deadline is None else \
                (r.deadline - r.t_submit) * 1000.0
            _resolve(r.future, exc=ServeDeadlineExceeded(
                f"deadline of {deadline_ms:.1f} ms passed after "
                f"{waited_ms:.1f} ms in queue (shed before dispatch)",
                retry_after_ms=self._retry_after_ms(),
                deadline_ms=round(deadline_ms, 3),
                waited_ms=round(waited_ms, 3),
                model_id=r.model_id, trace_id=r.trace_id))
            if self.tel is not None:
                self.tel.inc("serve.shed")
                self.tel.inc("serve.shed_rows", r.rows)
            self._emit_failed(r, "ServeDeadlineExceeded")

    # ------------------------------------------------------------------
    def _pull_same_model(self, lane: _Lane, model_id: str, cols: int,
                         budget: int
                         ) -> Tuple[List[_Request], List[_Request]]:
        """Remove queued DENSE requests for ``model_id`` with the SAME
        column count (a width mismatch must fail only its own request,
        not its batch neighbors' np.concatenate), up to ``budget`` rows,
        preserving arrival order.  Expired requests of ANY model are
        also removed and returned separately for shedding (emission
        happens outside the lock).  Caller holds the lock."""
        got, expired, keep = [], [], collections.deque()
        now = time.perf_counter()
        while lane.q:
            r = lane.q.popleft()
            if self._expired(r, now):
                lane.q_rows -= r.rows
                expired.append(r)
            elif (r.model_id == model_id and not r.sparse
                    and r.cols == cols and r.rows <= budget):
                # strict budget: a batch never exceeds max_batch_rows,
                # so one micro-batch is one bucketed device dispatch
                # (an oversized SINGLE request still chunks in the
                # engine, but never drags neighbors past the cap)
                lane.q_rows -= r.rows
                got.append(r)
                budget -= r.rows
            else:
                keep.append(r)
        lane.q = keep
        return got, expired

    def _drain_lane_locked(self, lane: _Lane) -> List[_Request]:
        drop = list(lane.q)
        lane.q.clear()
        lane.q_rows = 0
        return drop

    def _loop(self, lane: _Lane) -> None:
        while True:
            drop: Optional[List[_Request]] = None
            with self._mu:
                while not lane.q and not self._stop \
                        and not self._abort_drain:
                    lane.cv.wait()
                if self._abort_drain:
                    drop = self._drain_lane_locked(lane)
                elif not lane.q and self._stop:
                    return
                else:
                    first = lane.q.popleft()
                    lane.q_rows -= first.rows
            if drop is not None:
                # bounded drain expired: shutdown must shed the
                # remaining queue with structured errors, not block
                exc = ServeClosed("MicroBatcher drain timed out; "
                                  "request shed at shutdown",
                                  reason="drain_timeout")
                for r in drop:
                    _resolve(r.future, exc=exc)
                    self._emit_failed(r, "DrainTimeout")
                return
            now = time.perf_counter()
            if self._expired(first, now):
                self._shed([first])
                self._regauge(lane)
                continue
            batch = [first]
            rows = first.rows
            if not first.sparse:
                deadline = first.t_submit + self.max_delay_s
                while rows < self.max_batch_rows:
                    with self._mu:
                        more, expired = self._pull_same_model(
                            lane, first.model_id, first.cols,
                            self.max_batch_rows - rows)
                        if not more and not expired:
                            remaining = deadline - time.perf_counter()
                            if remaining <= 0:
                                break
                            lane.cv.wait(remaining)
                            more, expired = self._pull_same_model(
                                lane, first.model_id, first.cols,
                                self.max_batch_rows - rows)
                    if expired:
                        self._shed(expired)
                    if more:
                        batch.extend(more)
                        rows += sum(r.rows for r in more)
                    elif time.perf_counter() >= deadline:
                        break
            self._run_batch(lane, first.model_id, batch, rows)

    def _emit_failed(self, req: "_Request", error: str) -> None:
        """serve_access for a request that never reached a dispatch
        (submit-after-stop, shed deadline, drain timeout, wedged
        worker) — the exactly-one-record-per-request contract covers
        the failure paths an operator actually debugs."""
        if self.tel is None:
            return

        def _go():
            reqtrace.emit_access(
                self.tel, req, {"error": error},
                queue_ms=(time.perf_counter() - req.t_submit) * 1000.0,
                batch_ms=0.0)
        self._record(_go)

    def _record(self, fn, *args, **kwargs) -> None:
        """Telemetry from a worker thread must be best-effort: a
        failing sink (disk full under telemetry_out) would otherwise
        unwind _loop, kill the lane's worker and wedge every future
        request behind a healthy device."""
        if self.tel is None:
            return
        try:
            fn(*args, **kwargs)
        except Exception:
            pass

    def _run_batch(self, lane: _Lane, model_id: str,
                   batch: List[_Request], rows: int) -> None:
        # re-gauge on drain too: submit-only updates would leave an
        # idle service reporting its last (peak) backlog forever
        self._regauge(lane)
        lane.inflight = batch
        lane.busy_rows = rows
        t0 = time.perf_counter()
        wait_ms = (t0 - batch[0].t_submit) * 1000.0
        # request-scoped batch context: the engine annotates bucket /
        # dispatch wall / degradation from inside the dispatch without
        # the batcher knowing its internals (obs/reqtrace.py)
        reqtrace.begin_batch(model_id,
                             device=lane.index if self.n_lanes > 1
                             else None)
        try:
            X = batch[0].X if len(batch) == 1 else np.concatenate(
                [r.X for r in batch], axis=0)
            if self.n_lanes > 1:
                out = self._dispatch(model_id, X, lane.index)
            else:
                out = self._dispatch(model_id, X)
            out = np.asarray(out)
        except Exception as exc:  # resolve, don't wedge
            ctx = reqtrace.end_batch()
            for r in batch:
                _resolve(r.future, exc=exc)
            lane.inflight = []
            lane.busy_rows = 0

            def _error_telemetry():
                self.tel.inc("serve.batch_errors")
                self.tel.event("serve_batch_error", model_id=model_id,
                               rows=rows, error=type(exc).__name__)
                # the exactly-one-serve_access-per-request contract
                # holds on the failure path too — a request that died
                # must still be traceable by its trace_id
                for r in batch:
                    reqtrace.emit_access(
                        self.tel, r, dict(ctx, error=type(exc).__name__),
                        queue_ms=(t0 - r.t_submit) * 1000.0,
                        batch_ms=(time.perf_counter() - t0) * 1000.0)
            self._record(_error_telemetry)
            self._record(lambda: self.on_batch_done and
                         self.on_batch_done())
            return
        ctx = reqtrace.end_batch()
        done = time.perf_counter()
        c0 = 0
        for r in batch:
            _resolve(r.future, result=out[c0:c0 + r.rows])
            c0 += r.rows
        lane.inflight = []
        lane.busy_rows = 0
        batch_ms = (done - t0) * 1000.0
        # drain-rate EWMAs: the global pair feeds the rejection
        # retry_after hint; the per-lane ms/row feeds least-loaded
        # routing (plain attributes: worker-written, submitter-read,
        # GIL-atomic)
        a = 0.2
        self._ewma_batch_ms = batch_ms if self._ewma_batch_ms is None \
            else (1 - a) * self._ewma_batch_ms + a * batch_ms
        self._ewma_batch_rows = float(rows) \
            if self._ewma_batch_rows is None \
            else (1 - a) * self._ewma_batch_rows + a * rows
        ms_per_row = batch_ms / max(1, rows)
        lane.ewma_ms_per_row = ms_per_row \
            if lane.ewma_ms_per_row is None \
            else (1 - a) * lane.ewma_ms_per_row + a * ms_per_row

        def _batch_telemetry():
            self.tel.inc("serve.batches")
            self.tel.dist("serve.batch_rows", rows)
            if self.n_lanes > 1:
                self.tel.inc(f"serve.d{lane.index}.batches")
                self.tel.dist(f"serve.d{lane.index}.batch_ms", batch_ms)
            for r in batch:
                self.tel.dist("serve.latency_ms",
                              (done - r.t_submit) * 1000.0)
                reqtrace.emit_access(
                    self.tel, r, ctx,
                    queue_ms=(t0 - r.t_submit) * 1000.0,
                    batch_ms=batch_ms)
            if self.batch_events:
                self.tel.event("serve_batch", model_id=model_id,
                               rows=rows, requests=len(batch),
                               wait_ms=round(wait_ms, 3),
                               exec_ms=round(batch_ms, 3),
                               trace_ids=[r.trace_id for r in batch],
                               **({} if self.n_lanes == 1
                                  else {"device": lane.index}))
            if self.memory_watermarks:
                # serving dispatch boundary: the allocator peak just
                # moved (or didn't) — refresh the device memory gauges
                self.tel.memory_watermarks(where="serve")

        self._record(_batch_telemetry)
        # adaptive admission: evaluate AFTER the batch's latency samples
        # landed in the dist ring (time-gated inside the controller)
        self._record(lambda: self.on_batch_done and self.on_batch_done())

    # ------------------------------------------------------------------
    def close(self, drain: bool = True,
              drain_timeout_s: Optional[float] = None) -> None:
        """Stop the workers.  ``drain=True`` serves what is already
        queued first, bounded by ``drain_timeout_s`` (default 30 s,
        shared across lanes): when the bound expires, the remaining
        queues are shed with structured ``ServeClosed`` errors instead
        of blocking shutdown indefinitely.  ``drain=False`` fails
        queued requests immediately.  A worker that does not exit even
        after the aborted drain (stuck inside a device dispatch) is
        declared WEDGED: queued + in-flight futures are failed with
        ``ServeWorkerWedged`` and a ``serve_worker_wedged`` event fires
        — never a silent leak of unresolved futures."""
        with self._mu:
            self._stop = True
            dropped: List[_Request] = []
            if not drain:
                for lane in self._lanes:
                    dropped.extend(self._drain_lane_locked(lane))
                for r in dropped:
                    _resolve(r.future,
                             exc=ServeClosed("MicroBatcher closed",
                                             model_id=r.model_id))
            for lane in self._lanes:
                lane.cv.notify_all()
        for r in dropped:
            self._emit_failed(r, "MicroBatcherClosed")
        timeout = 30.0 if drain_timeout_s is None \
            else max(0.0, float(drain_timeout_s))
        # one shared deadline: the drain bound covers the whole fleet,
        # not timeout x n_lanes
        deadline = time.perf_counter() + timeout
        for lane in self._lanes:
            lane.worker.join(
                timeout=max(0.0, deadline - time.perf_counter()))
        if not any(lane.worker.is_alive() for lane in self._lanes):
            return
        # bounded drain expired: tell the workers to stop serving the
        # backlog and shed it (structured errors) on their way out
        with self._mu:
            self._abort_drain = True
            for lane in self._lanes:
                lane.cv.notify_all()
        grace = time.perf_counter() + _WEDGE_GRACE_S
        for lane in self._lanes:
            if lane.worker.is_alive():
                lane.worker.join(
                    timeout=max(0.0, grace - time.perf_counter()))
        if not any(lane.worker.is_alive() for lane in self._lanes):
            return
        # a worker ignored the abort: it is wedged inside a dispatch
        # (a hung device).  Fail everything
        # it will never serve — _resolve is race-tolerant, so if the
        # worker ever does come back its own delivery no-ops.
        self._wedged = True
        with self._mu:
            drop = []
            for lane in self._lanes:
                drop.extend(self._drain_lane_locked(lane))
        inflight = self._inflight
        exc = ServeWorkerWedged(
            "serving worker did not exit within the close timeout "
            "(wedged inside a dispatch); queued and in-flight requests "
            "failed", queued=len(drop), inflight=len(inflight))
        for r in drop + inflight:
            _resolve(r.future, exc=exc)
            self._emit_failed(r, "ServeWorkerWedged")
        if self.tel is not None:
            self._record(lambda: self.tel.event(
                "serve_worker_wedged", queued=len(drop),
                inflight=len(inflight),
                drain_timeout_s=timeout))
            self._record(lambda: self.tel.inc("serve.worker_wedged"))
