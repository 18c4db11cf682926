"""The port's overload-hardened serving: admission control, deadline
shedding, retry policy, the drain timeout, wedge detection, rollover with
hashes and shadow scoring, readiness; and the refusals of the planes still
to be ported.

The counterparts of ``tests/test_serve_overload.py`` that need neither
``resilience.faults`` nor a checkpoint (the wedged worker is made by a gate
that never opens in time instead of an injected fault). Dispatch
throttling is a wrapped ``batcher._dispatch`` holding a gate, so a backlog
piles up deterministically on any runner.
"""
import threading
import time

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.serve import (PredictionService, RetryPolicy,
                                      ServeClosed, ServeDeadlineExceeded,
                                      ServeRejected, ServeWorkerWedged)
from lightgbm_tpu_torch.serve import batcher as batcher_mod

TOL = dict(rtol=1e-5, atol=1e-6)
F = 8
CPU = {"device_type": "cpu"}


def _train(seed=0, n=400, rounds=5, **extra):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, F).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 1.0).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 15,
              "learning_rate": 0.2, "verbose": -1, "min_data_in_leaf": 5,
              **CPU}
    params.update(extra)
    return lt.train(params, lt.Dataset(X, label=y), rounds)


@pytest.fixture(scope="module")
def bst():
    return _train(seed=0)


@pytest.fixture(scope="module")
def bst2():
    return _train(seed=0, rounds=7, learning_rate=0.35)


def _svc(bst, **kw):
    kw.setdefault("max_batch_rows", 64)
    kw.setdefault("min_bucket_rows", 16)
    kw.setdefault("max_delay_ms", 0.5)
    kw.setdefault("batch_events", False)
    kw.setdefault("serve_devices", 1)
    kw.setdefault("device_type", "cpu")
    return PredictionService({"m": bst}, **kw)


def _gate_dispatch(svc, hold_s=2.0):
    """Replace the service's dispatch with one that blocks on a gate."""
    real = svc.batcher._dispatch
    gate = threading.Event()

    def slow(mid, X):
        gate.wait(hold_s)
        return real(mid, X)
    svc.batcher._dispatch = slow
    return gate, real


def _events(svc, name):
    return [e for e in svc.tel._events if e.get("event") == name]


# ------------------------------------------------------ admission
def test_reject_structured_and_queue_bounded(bst):
    svc = _svc(bst, max_queue_requests=4)
    svc.warmup()
    gate, _ = _gate_dispatch(svc)
    futs, rejects = [], []
    try:
        for _ in range(25):
            try:
                futs.append(svc.submit("m", np.zeros((2, F), np.float32)))
            except ServeRejected as exc:
                rejects.append(exc)
        assert len(svc.batcher._q) <= 4
        assert rejects, "an open-loop burst over a 4-deep queue rejects"
        exc = rejects[0]
        assert exc.reason in ("queue_requests", "queue_rows")
        assert exc.retry_after_ms > 0
        d = exc.details()
        assert d["error"] == "ServeRejected" and "queue_requests" in d
    finally:
        gate.set()
    for f in futs:
        f.result(timeout=30)          # everything admitted is served
    s = svc.stats()
    assert s["rejected"] == len(rejects)
    assert s["queue_peak_requests"] <= 4
    assert _events(svc, "serve_rejected"), "structured reject event"
    svc.close()


def test_oversized_single_request_admits_when_queue_empty(bst):
    svc = _svc(bst, max_queue_rows=8)
    svc.warmup()
    X = np.random.RandomState(3).rand(32, F).astype(np.float32)
    out = svc.predict("m", X)
    np.testing.assert_allclose(out, bst.predict(X), **TOL)
    assert svc.stats()["rejected"] == 0
    svc.close()


def test_deadline_shed_at_dequeue_before_device_work(bst):
    svc = _svc(bst)
    svc.warmup()
    d0 = svc.stats()["dispatches"]
    gate, _ = _gate_dispatch(svc)
    f0 = svc.submit("m", np.zeros((1, F), np.float32))
    time.sleep(0.05)
    late = [svc.submit("m", np.zeros((1, F), np.float32),
                       deadline_ms=100.0) for _ in range(3)]
    time.sleep(0.3)                    # all three expire while queued
    gate.set()
    f0.result(timeout=30)
    for f in late:
        with pytest.raises(ServeDeadlineExceeded) as ei:
            f.result(timeout=30)
        assert ei.value.fields["waited_ms"] >= 100.0
        assert ei.value.fields["deadline_ms"] == pytest.approx(100.0)
    s = svc.stats()
    assert s["shed"] == 3
    assert s["dispatches"] - d0 == 1   # shed before any device work
    errs = [e for e in _events(svc, "serve_access")
            if e.get("error") == "ServeDeadlineExceeded"]
    assert len(errs) == 3
    svc.close()


def test_service_default_deadline_applies(bst):
    svc = _svc(bst, default_deadline_ms=80.0)
    svc.warmup()
    gate, _ = _gate_dispatch(svc)
    svc.submit("m", np.zeros((1, F), np.float32))
    time.sleep(0.05)
    f = svc.submit("m", np.zeros((1, F), np.float32))   # inherits 80 ms
    time.sleep(0.2)
    gate.set()
    with pytest.raises(ServeDeadlineExceeded):
        f.result(timeout=30)
    svc.close()


# -------------------------------------------------------- retry
def test_retry_policy_retries_shed_and_reject_only(bst):
    svc = _svc(bst, max_queue_requests=1)
    svc.warmup()
    gate, real = _gate_dispatch(svc)
    svc.submit("m", np.zeros((1, F), np.float32))
    time.sleep(0.05)
    svc.submit("m", np.zeros((1, F), np.float32))
    t = threading.Timer(0.3, gate.set)
    t.start()
    pol = RetryPolicy(max_attempts=40, base_backoff_ms=25,
                      max_backoff_ms=100)
    out = svc.predict("m", np.zeros((2, F), np.float32), retry=pol)
    assert out.shape == (2,)
    assert svc.stats()["retries"] > 0
    t.cancel()
    calls = []

    def boom(mid, X):
        calls.append(1)
        raise ValueError("poisoned")
    svc.batcher._dispatch = boom
    r0 = svc.stats()["retries"]
    with pytest.raises(ValueError):
        svc.predict("m", np.zeros((1, F), np.float32), retry=pol)
    assert len(calls) == 1             # compute errors are never retried
    assert svc.stats()["retries"] == r0
    svc.batcher._dispatch = real
    svc.close()


def test_retry_policy_backoff_honors_server_hint():
    pol = RetryPolicy(max_attempts=3, base_backoff_ms=10,
                      backoff_multiplier=2.0, max_backoff_ms=500)
    assert pol.backoff_ms(0) == 10
    assert pol.backoff_ms(1) == 20
    hint = ServeRejected("x", reason="queue_rows", retry_after_ms=120.0)
    assert pol.backoff_ms(0, hint) == 120.0
    big = ServeRejected("x", reason="queue_rows", retry_after_ms=9000.0)
    assert pol.backoff_ms(0, big) == 500
    assert pol.should_retry(hint, 0) and not pol.should_retry(hint, 2)
    assert not pol.should_retry(ValueError("compute"), 0)


# --------------------------------------------- adaptive controller
def test_admission_controller_hysteresis_no_flap(bst):
    svc = _svc(bst, target_p99_ms=50.0, max_queue_rows=1024)
    try:
        ctl = svc.admission
        assert ctl is not None and ctl.level == 0
        b = svc.batcher
        base_delay, base_rows = b.max_delay_s, b.max_batch_rows
        for p99 in (500.0, 10.0, 500.0, 60.0):   # no streak: holds
            ctl.step(force=True, p99_ms=p99)
        assert ctl.level == 0 and b.shed_watermark_rows is None
        for _ in range(3):
            ctl.step(force=True, p99_ms=500.0)
        assert ctl.level == 1
        assert b.max_delay_s == pytest.approx(base_delay / 2)
        assert b.max_batch_rows == base_rows // 2
        assert b.shed_watermark_rows == 512
        for _ in range(3):
            ctl.step(force=True, p99_ms=500.0)
        assert ctl.level == 2 and b.shed_watermark_rows == 256
        for _ in range(3):
            ctl.step(force=True, p99_ms=10.0)
        assert ctl.level == 1
        for _ in range(3):
            ctl.step(force=True, p99_ms=10.0)
        assert ctl.level == 0
        assert b.max_delay_s == pytest.approx(base_delay)
        assert b.max_batch_rows == base_rows
        assert b.shed_watermark_rows is None
        evs = _events(svc, "serve_admission")
        assert len(evs) == 4 and {e["direction"] for e in evs} == \
            {"shed", "recover"}
    finally:
        svc.close()


def test_admission_watermark_rejects_under_hard_cap(bst):
    svc = _svc(bst, target_p99_ms=50.0, max_queue_rows=1024)
    svc.warmup()
    gate, _ = _gate_dispatch(svc)
    try:
        for _ in range(3):
            svc.admission.step(force=True, p99_ms=500.0)
        assert svc.batcher.shed_watermark_rows == 512
        svc.submit("m", np.zeros((1, F), np.float32))
        time.sleep(0.05)               # in flight, holds the worker
        svc.submit("m", np.zeros((1, F), np.float32))   # queued
        with pytest.raises(ServeRejected) as ei:
            # under the 1024 hard cap, over the level-1 watermark (512)
            svc.submit("m", np.zeros((600, F), np.float32))
        assert ei.value.reason == "shed_watermark"
    finally:
        gate.set()
        svc.close()


# -------------------------------------------- bounded drain / wedge
def test_close_drain_timeout_sheds_structured(bst):
    svc = _svc(bst)
    svc.warmup()
    gate, _ = _gate_dispatch(svc, hold_s=1.5)
    f0 = svc.submit("m", np.zeros((1, F), np.float32))
    time.sleep(0.05)
    queued = [svc.submit("m", np.zeros((1, F), np.float32))
              for _ in range(4)]
    t0 = time.perf_counter()
    svc.close(drain_timeout_s=0.2)     # cannot drain through the gate
    assert time.perf_counter() - t0 < 10.0
    gate.set()
    f0.result(timeout=30)              # the in-flight batch completed
    for f in queued:                   # the backlog was shed, not leaked
        with pytest.raises(ServeClosed):
            f.result(timeout=30)


def test_wedged_worker_detected_and_reported(bst, monkeypatch):
    monkeypatch.setattr(batcher_mod, "_WEDGE_GRACE_S", 0.3)
    svc = _svc(bst)
    svc.warmup()
    gate, _ = _gate_dispatch(svc, hold_s=3.0)   # stuck inside batch 1
    f1 = svc.submit("m", np.zeros((1, F), np.float32))
    time.sleep(0.2)
    f2 = svc.submit("m", np.zeros((1, F), np.float32))
    svc.close(drain_timeout_s=0.2)
    try:
        for f in (f1, f2):             # in flight and queued both fail
            with pytest.raises(ServeWorkerWedged):
                f.result(timeout=5)
        ev = _events(svc, "serve_worker_wedged")
        assert ev and ev[0]["queued"] == 1 and ev[0]["inflight"] == 1
        assert svc._readiness() == (False, "closed")
    finally:
        gate.set()


# ------------------------------------------------------- rollover
def test_rollover_swaps_atomically_with_hashes(bst, bst2):
    svc = _svc(bst)
    svc.warmup()
    X = np.zeros((3, F), np.float32)
    before = svc.predict("m", X)
    rep = svc.rollover("m", bst2)
    assert rep["promoted"] and rep["old_hash"] != rep["new_hash"]
    after = svc.predict("m", X)
    np.testing.assert_allclose(after, bst2.predict(X.astype(np.float64)),
                               **TOL)
    assert not np.allclose(before, after)
    ev = _events(svc, "serve_rollover")
    assert ev and ev[0]["old_hash"] == rep["old_hash"] \
        and ev[0]["new_hash"] == rep["new_hash"]
    assert svc.stats()["rollovers"] == 1
    svc.close()


def test_rollover_from_model_text(bst, bst2, tmp_path):
    """A model file rolls over as a booster does (raw routing)."""
    path = str(tmp_path / "v2.txt")
    bst2.save_model(path)
    svc = _svc(bst)
    svc.warmup()
    rep = svc.rollover("m", path)
    assert rep["promoted"]
    X = np.random.RandomState(5).rand(40, F).astype(np.float32)
    np.testing.assert_allclose(svc.predict("m", X), bst2.predict(X), **TOL)
    assert _events(svc, "serve_rollover")[0]["source"] == "file"
    assert svc.residency.get("m").variant == "raw"
    svc.close()


def test_rollover_shadow_reports_divergence_and_abort(bst, bst2):
    svc = _svc(bst)
    svc.warmup()
    stop = threading.Event()
    fails = []

    def traffic():
        r = np.random.RandomState(11)
        while not stop.is_set():
            try:
                svc.predict("m", r.rand(2, F).astype(np.float32))
            except Exception as e:     # pragma: no cover
                fails.append(repr(e))
    th = threading.Thread(target=traffic, daemon=True)
    th.start()
    try:
        rep = svc.rollover("m", bst2, shadow_requests=4,
                           shadow_timeout_s=15.0)
        assert rep["promoted"] and rep["shadow"]["completed"]
        assert rep["shadow"]["requests"] >= 4
        assert rep["shadow"]["max_divergence"] > 0
        assert _events(svc, "serve_shadow")
        # a zero tolerance against a diverging candidate keeps the
        # current model serving
        rep2 = svc.rollover("m", bst, shadow_requests=3,
                            shadow_timeout_s=15.0,
                            shadow_abort_threshold=0.0)
        assert not rep2["promoted"]
        assert _events(svc, "serve_rollover_aborted")
    finally:
        stop.set()
        th.join(timeout=10)
    assert not fails
    X = np.zeros((3, F), np.float32)
    np.testing.assert_allclose(svc.predict("m", X),
                               bst2.predict(np.zeros((3, F))), **TOL)
    svc.close()


def test_rollover_responses_attributable_to_one_version(bst, bst2):
    svc = _svc(bst)
    svc.warmup()
    h_old = svc.residency.get("m").model_hash[:16]
    for _ in range(3):
        svc.predict("m", np.zeros((2, F), np.float32))
    svc.rollover("m", bst2)
    h_new = svc.residency.get("m").model_hash[:16]
    for _ in range(3):
        svc.predict("m", np.zeros((2, F), np.float32))
    acc = [e for e in _events(svc, "serve_access") if "model_version" in e]
    assert len(acc) >= 6
    assert {e["model_version"] for e in acc} == {h_old, h_new}
    svc.close()


# --------------------------------------------------------- readiness
def test_readyz_gates_on_warmup_and_close(bst):
    svc = _svc(bst)
    assert svc._readiness() == (False, "warmup_pending")
    svc.warmup()
    assert svc._readiness() == (True, "ready")
    svc.close()
    assert svc._readiness() == (False, "closed")


def test_idle_overload_knobs_keep_serving_contract(bst):
    svc = _svc(bst)
    svc.warmup()
    rng = np.random.RandomState(7)
    for s in (1, 5, 17, 33):
        svc.predict("m", rng.rand(s, F).astype(np.float32))
    s = svc.stats()
    assert s["dispatches_per_request"] == 1.0
    assert s["compiles_per_1k_requests"] == 0.0
    assert s["rejected"] == 0 and s["shed"] == 0
    svc.close()


# ---------------------------------------------- planes not ported yet
@pytest.mark.parametrize("kw,item", [
    ({"metrics_port": 9200}, "item 10"),
    ({"trace_out": "t.json"}, "item 10"),
    ({"slo_enabled": True}, "item 10"),
    ({"slo_config": "slo.json"}, "item 10"),
    ({"cost_ledger": "hlo"}, "item 10"),
    ({"drift_enabled": True}, "item 10"),
])
def test_unported_planes_refuse(bst, kw, item, monkeypatch):
    """The metrics exporter, traces, SLOs, the cost ledger and the drift
    monitor wait for ROADMAP Queue A item 10. The defaults arm none of
    them, and a checkpoint directory is refused as a model source."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(NotImplementedError, match=item):
        _svc(bst, **kw)


def test_checkpoint_source_refused_and_defaults_arm_nothing(bst, tmp_path):
    with pytest.raises(NotImplementedError, match="item 10"):
        PredictionService({"m": str(tmp_path)}, device_type="cpu")
    svc = PredictionService({"m": bst}, device_type="cpu",
                            cost_ledger="off", drift_enabled=False)
    try:
        svc.warmup()
        s = svc.stats()
        assert "drift" not in s and "fleet" not in s
        assert not any(k.startswith(("cost.", "drift."))
                       for k in svc.tel.snapshot()["gauges"])
    finally:
        svc.close()
