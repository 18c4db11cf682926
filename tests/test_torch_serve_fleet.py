"""The port's serving fleet (``lightgbm_tpu_torch/serve/``), on the CPU.

The counterparts of the 15 tests of ``tests/test_serve_fleet.py``, and the
resolution of ``serve_devices``. The JAX package's fleet tests run on eight
host devices that ``tests/conftest.py`` forces; the port's run their lanes
on the CPU through ``devices=[cpu] * 4`` (one replica, worker and queue a
lane), as a machine with one card runs its lanes on ``cuda:0``. Lanes on
one device hold the base replica's tensors, so only lane 0 is charged
bytes. Predictions are held to the float64 walk within rtol 1e-5, atol
1e-6 (float32 sums on the lanes).
"""
import threading
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.obs import Telemetry
from lightgbm_tpu_torch.serve import (MicroBatcher, PredictionService,
                                      ResidencyManager, ServingEngine)
from lightgbm_tpu_torch.serve.engine import storage_nbytes
from lightgbm_tpu_torch.serve.errors import ServeRejected
from lightgbm_tpu_torch.serve.service import resolve_devices

TOL = dict(rtol=1e-5, atol=1e-6)   # f32 lane sums against the f64 walk
F = 8
NDEV = 4
CPU = torch.device("cpu")
LANES = [CPU] * NDEV
PARAMS = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.2,
          "verbose": -1, "min_data_in_leaf": 5, "device_type": "cpu"}


def _train(seed=0, n=400, f=F, rounds=6, **extra):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 1.0).astype(np.float32)
    return lt.train(dict(PARAMS, **extra), lt.Dataset(X, label=y), rounds)


@pytest.fixture(scope="module")
def bst():
    return _train(seed=0)


@pytest.fixture(scope="module")
def bst_multi():
    rng = np.random.RandomState(7)
    X = rng.rand(300, F).astype(np.float32)
    y = rng.randint(0, 3, 300).astype(np.float32)
    return lt.train({"objective": "multiclass", "num_class": 3,
                     "num_leaves": 15, "verbose": -1, "min_data_in_leaf": 5,
                     "device_type": "cpu"},
                    lt.Dataset(X, label=y), 5)


def _svc(models, **kw):
    kw.setdefault("max_batch_rows", 64)
    kw.setdefault("min_bucket_rows", 16)
    kw.setdefault("max_delay_ms", 1.0)
    kw.setdefault("batch_events", False)
    kw.setdefault("device_type", "cpu")
    if "serve_devices" not in kw:
        kw.setdefault("devices", LANES)
    return PredictionService(models, **kw)


def _held(eng):
    """Every tensor a replica keeps alive: its packing, operands and
    tids."""
    return list(eng.pred.stack.values()) + list(eng._ops) + [eng._tids]


# ----------------------------------------------------------- accounting
def test_residency_bytes_match_live_device_buffers(bst):
    """The budget charges what the lanes hold: per lane, the bytes of the
    storages its replica keeps alive beyond the lanes before it (distinct
    storages: views and aliases count once) within 10% of
    ``resident_bytes_on(d)``; lanes on the base's device hold its very
    tensors and are charged nothing."""
    rm = ResidencyManager(devices=LANES[:2], max_batch_rows=128,
                          min_bucket_rows=32)
    rm.register("m", bst)
    engines = [rm.get("m", 0), rm.get("m", 1)]
    seen = []
    for d, eng in enumerate(engines):
        actual = storage_nbytes(_held(eng), exclude=seen)
        est = rm.resident_bytes_on(d)
        assert abs(actual - est) <= 0.10 * max(actual, 1), \
            f"lane {d}: actual={actual} est={est}"
        seen.extend(_held(eng))
    assert rm.resident_bytes_on(0) > 0 and rm.resident_bytes_on(1) == 0
    assert rm.resident_bytes == storage_nbytes(seen)


def test_full_range_engine_aliases_packed_no_copy(bst):
    """A full-range engine's operands are the packed tensors' own storage
    (views, no copy); the charge is the packing plus only the tree-id
    vector."""
    eng = ServingEngine(bst, max_batch_rows=128, min_bucket_rows=32)
    packed = {t.untyped_storage().data_ptr()
              for t in eng.pred.stack.values() if t is not None}
    ops = [a for a in eng._ops if a is not None]
    assert len(ops) == len(packed)
    assert all(a.untyped_storage().data_ptr() in packed for a in ops)
    assert eng.packed_nbytes == eng.pred.packed_nbytes \
        + eng._tids.untyped_storage().nbytes()
    assert eng.packed_nbytes < 1.10 * eng.pred.packed_nbytes


def test_sub_range_engine_charges_its_slices(bst):
    """``num_iteration`` < total: the JAX package's slices are copies and
    are charged; the port's are views of the packed storage, so the
    charge is what the engine really holds, the packing and its tids."""
    eng = ServingEngine(bst, max_batch_rows=128, min_bucket_rows=32,
                        num_iteration=3)
    assert eng.num_iteration == 3
    assert eng._ops[0].shape[0] == 3 < eng.pred.num_trees
    assert eng.packed_nbytes == storage_nbytes(_held(eng))
    assert eng.packed_nbytes > eng.pred.packed_nbytes


def test_replica_shares_packing_and_charges_copies(bst):
    """A replica reuses the base engine's packing (one pack per model);
    on the base's device its operands are the base's tensors, so it is
    charged nothing, and every operand lives on its lane's device."""
    rm = ResidencyManager(devices=LANES[:2], max_batch_rows=128,
                          min_bucket_rows=32)
    rm.register("m", bst)
    base = rm.get("m", 0)
    rep = rm.get("m", 1)
    assert rep.pred is base.pred          # shared packing, no re-pack
    assert rep.model_hash == base.model_hash
    assert base._owns_pred and not rep._owns_pred
    assert all(a is b for a, b in zip(rep._ops, base._ops))
    assert rep._tids is base._tids
    assert rep.packed_nbytes == 0 == rm.resident_bytes_on(1)
    assert rm.resident_bytes_on(0) == base.packed_nbytes > 0
    for a in rep._ops + (rep._tids,):
        if a is not None:
            assert a.device == LANES[1]
    assert (base.device_index, rep.device_index) == (0, 1)
    assert base._signature(32) != rep._signature(32)


def test_budget_evicts_a_model_from_every_lane_at_once(bst):
    """Over budget, a model leaves every lane in one step (its replicas
    share one pack), whichever lane holds its base; the budget applies to
    the bytes of every lane on the device, so the charges stay the
    storages still alive and within budget."""
    b2 = _train(seed=3)
    rm = ResidencyManager(devices=LANES[:2], max_batch_rows=128,
                          min_bucket_rows=32)
    rm.register("a", bst)
    rm.register("b", b2)
    rm.get("a", 0)
    rm.get("a", 1)
    rm.budget_bytes = rm.resident_bytes + 64
    rm.get("b", 1)          # b's base is on lane 1, charged there
    assert rm.resident() == ["b"]
    assert all("a" not in t for t in rm._tables)
    rm.get("b", 0)          # lane 0 aliases lane 1's base: no eviction
    held = [x for t in rm._tables for e in t.values() for x in _held(e)]
    assert rm.resident_bytes == storage_nbytes(held) <= rm.budget_bytes
    assert rm.resident_bytes_on(0) == 0 < rm.resident_bytes_on(1)
    rm.get("a", 0)          # a rebuilt: a fresh pack, b goes everywhere
    assert rm.resident() == ["a"]
    held = [x for t in rm._tables for e in t.values() for x in _held(e)]
    assert rm.resident_bytes == storage_nbytes(held) > 0


# -------------------------------------------------------------- routing
def test_fleet_routes_every_device_with_per_device_contract(bst):
    """A sequential closed loop still exercises every lane (idle ties
    rotate), and after warmup every lane honours the contract: exactly
    1.0 dispatch per request, 0 steady-state compiles."""
    svc = _svc({"m": bst})
    try:
        assert svc.n_devices == NDEV
        svc.warmup()
        rng = np.random.RandomState(3)
        n_req = 4 * NDEV
        for _ in range(n_req):
            Xq = rng.rand(16, F).astype(np.float32)
            np.testing.assert_allclose(svc.predict("m", Xq),
                                       bst.predict(Xq), **TOL)
        st = svc.stats()
        fl = st["fleet"]
        assert fl["devices"] == NDEV
        assert fl["routed_devices"] == NDEV
        per = fl["per_device"]
        assert sum(e["requests"] for e in per) == n_req
        for e in per:
            assert e["requests"] > 0
            assert e["dispatches_per_request"] == 1.0, e
            assert e["compiles_per_1k_requests"] == 0.0, e
        assert st["dispatches_per_request"] == 1.0
        assert st["compiles_per_1k_requests"] == 0.0
    finally:
        svc.close()


def test_round_robin_routing_spreads_exactly(bst):
    svc = _svc({"m": bst}, routing="round_robin")
    try:
        svc.warmup()
        rng = np.random.RandomState(5)
        for _ in range(3 * NDEV):
            svc.predict("m", rng.rand(8, F).astype(np.float32))
        fl = svc.stats()["fleet"]
        assert fl["routing"] == "round_robin"
        assert [e["requests"] for e in fl["per_device"]] == [3] * NDEV
    finally:
        svc.close()


def test_single_device_plane_has_no_fleet_surface(bst):
    """serve_devices=1 is the single-device plane: one lane, the
    two-argument dispatch callback, no fleet section."""
    svc = _svc({"m": bst}, serve_devices=1)
    try:
        assert svc.devices is None and svc.n_devices == 1
        assert svc.batcher.n_lanes == 1
        svc.warmup()
        rng = np.random.RandomState(9)
        Xq = rng.rand(10, F).astype(np.float32)
        np.testing.assert_allclose(svc.predict("m", Xq),
                                   bst.predict(Xq), **TOL)
        assert "fleet" not in svc.stats()
    finally:
        svc.close()


def test_single_lane_predict_bulk_goes_through_bulk_scorer(bst):
    """With one lane ``predict_bulk`` is the bulk scorer's too (one shard
    a chunk on the lane), with the engine dispatch's bits."""
    svc = _svc({"m": bst}, serve_devices=1)
    try:
        rng = np.random.RandomState(13)
        X = rng.rand(300, F).astype(np.float32)
        single = svc.residency.get("m").predict(X)
        np.testing.assert_array_equal(svc.predict_bulk("m", X), single)
        np.testing.assert_array_equal(svc.predict_bulk("m", X[0]),
                                      single[:1])
        c = svc.tel.snapshot()["counters"]
        assert c["serve.bulk_rows"] == X.shape[0] + 1
        assert c["serve.bulk_dispatches"] == 2
        assert svc._bulk["m"].n_lanes == 1
    finally:
        svc.close()


def test_serve_devices_resolves_over_local_devices(bst, monkeypatch):
    """``serve_devices`` counts the cards for ``device_type="cuda"`` (0:
    all of them, never more than there are) and one CPU device for
    ``"cpu"``; ``devices=`` names the lanes outright, repeats allowed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cuda = [torch.device("cuda", i) for i in range(3)]
    assert resolve_devices(0, "cuda") == cuda
    assert resolve_devices(2, "cuda") == cuda[:2]
    assert resolve_devices(8, "cuda") == cuda
    assert resolve_devices(0, "cpu") == [CPU]
    assert resolve_devices(4, "cpu") == [CPU]
    assert resolve_devices(0, "cuda", devices=["cpu", "cpu"]) == [CPU, CPU]
    svc = PredictionService({"m": bst}, serve_devices=4, device_type="cpu")
    try:
        assert svc.n_devices == 1 and svc.devices is None
    finally:
        svc.close()


# ---------------------------------------------------- spill & admission
def _wedge_lanes(batcher, n, gate, rows=1):
    """Occupy every lane's worker inside a gated dispatch and wait until
    all of them are busy."""
    futs = [batcher.submit("m", np.zeros((rows, F), np.float32))
            for _ in range(n)]
    deadline = time.time() + 10.0
    while any(lane.busy_rows == 0 for lane in batcher._lanes):
        assert time.time() < deadline, "workers never picked up"
        time.sleep(0.005)
    return futs


def test_spill_to_coldest_lane_before_shed():
    """A submit its routed lane must reject goes to the coldest lane with
    room (counted, evented); only when every lane is full does admission
    control shed."""
    tel = Telemetry(enabled=True)
    gate = threading.Event()

    def dispatch(model_id, X, device):
        gate.wait(10.0)
        return np.zeros((X.shape[0],))

    b = MicroBatcher(dispatch, max_batch_rows=8, max_delay_ms=1.0,
                     telemetry=tel, max_queue_rows=4, n_lanes=2)
    try:
        busy = _wedge_lanes(b, 2, gate)
        # routing pinned to lane 0: the spill, not the routing, is tested
        b._pick_lane = lambda: b._lanes[0]
        f1 = b.submit("m", np.zeros((2, F), np.float32))
        assert b._lanes[0].q_rows == 2       # lane cap = ceil(4/2) = 2
        f2 = b.submit("m", np.zeros((2, F), np.float32))
        assert b._lanes[1].q_rows == 2       # spilled, not shed
        c = tel.snapshot()["counters"]
        assert c.get("serve.spills") == 1
        assert c.get("serve.d1.spills") == 1
        with pytest.raises(ServeRejected):   # both lanes full now
            b.submit("m", np.zeros((2, F), np.float32))
        gate.set()
        for f in busy + [f1, f2]:
            f.result(timeout=10.0)
        events = [e for e in tel.snapshot()["events"]
                  if e["event"] == "serve_spill"]
        assert events and events[0]["to_device"] == 1
    finally:
        gate.set()
        b.close(drain_timeout_s=5.0)
        tel.close()


def test_queue_gauges_published_on_submit_while_worker_stalled():
    """The backlog behind a stalled worker is visible without a drain:
    submit itself refreshes the aggregate and per-lane gauges."""
    tel = Telemetry(enabled=True)
    gate = threading.Event()

    def dispatch(model_id, X, device):
        gate.wait(10.0)
        return np.zeros((X.shape[0],))

    b = MicroBatcher(dispatch, max_batch_rows=4, max_delay_ms=1.0,
                     telemetry=tel, n_lanes=2)
    try:
        busy = _wedge_lanes(b, 2, gate)
        b._pick_lane = lambda: b._lanes[0]
        queued = [b.submit("m", np.zeros((2, F), np.float32))
                  for _ in range(3)]
        g = tel.snapshot()["gauges"]
        assert g["serve.queue_depth"] == 3
        assert g["serve.queue_rows"] == 6
        assert g["serve.d0.queue_depth"] == 3
        assert g["serve.d0.queue_rows"] == 6
        gate.set()
        for f in busy + queued:
            f.result(timeout=10.0)
    finally:
        gate.set()
        b.close(drain_timeout_s=5.0)
        tel.close()


def test_sustained_imbalance_per_lane_skew_and_spill_sums():
    """Every worker wedged in a gated dispatch, the flood pinned to lane
    0 until it fills, the excess spilled toward the colder lanes: the
    skew shows in the per-lane gauges, the spill counters advance on the
    receiving lanes only, and the aggregates are exactly the per-lane
    sums."""
    tel = Telemetry(enabled=True)
    gates = {d: threading.Event() for d in range(4)}

    def dispatch(model_id, X, device):
        gates[device].wait(10.0)
        return np.zeros((X.shape[0],))

    b = MicroBatcher(dispatch, max_batch_rows=4, max_delay_ms=1.0,
                     telemetry=tel, max_queue_rows=32, n_lanes=4)
    try:
        busy = _wedge_lanes(b, 4, None)
        b._pick_lane = lambda: b._lanes[0]
        # lane cap = ceil(32/4) = 8 rows: 4 submits fill lane 0, the
        # next 6 spill (12 rows over lanes 1-3)
        futs = [b.submit("m", np.zeros((2, F), np.float32))
                for _ in range(10)]
        g = tel.snapshot()["gauges"]
        assert g["serve.d0.queue_depth"] == 4
        assert g["serve.d0.queue_rows"] == 8
        for d in (1, 2, 3):
            assert g[f"serve.d{d}.queue_rows"] > 0
            assert g["serve.d0.queue_depth"] > \
                g[f"serve.d{d}.queue_depth"]
        assert sum(g[f"serve.d{d}.queue_rows"] for d in (1, 2, 3)) == 12
        assert g["serve.queue_depth"] == sum(
            g[f"serve.d{d}.queue_depth"] for d in range(4))
        assert g["serve.queue_rows"] == sum(
            g[f"serve.d{d}.queue_rows"] for d in range(4))
        c = tel.snapshot()["counters"]
        assert c.get("serve.spills") == 6
        assert sum(c.get(f"serve.d{d}.spills", 0)
                   for d in range(4)) == c["serve.spills"]
        assert c.get("serve.d0.spills", 0) == 0
        for d in (1, 2, 3):
            assert c.get(f"serve.d{d}.spills", 0) >= 1
        for gate in gates.values():
            gate.set()
        for f in busy + futs:
            f.result(timeout=10.0)
    finally:
        for gate in gates.values():
            gate.set()
        b.close(drain_timeout_s=5.0)
        tel.close()


# ------------------------------------------------------------- rollover
def test_fleet_rollover_swaps_every_replica_atomically(bst):
    """Rollover under load: a thread keeps submitting while the full
    replica set swaps; every response carries the old or the new hash,
    every request submitted after ``rollover`` returned the new one, on
    every lane; the bulk scorer is built again from the new replicas."""
    b2 = _train(seed=1, rounds=8)
    svc = _svc({"m": bst})
    try:
        svc.warmup()
        rng = np.random.RandomState(13)
        X = rng.rand(200, F).astype(np.float32)
        old_hash = svc.residency.get("m", 0).model_hash
        svc.predict_bulk("m", X)
        stop = threading.Event()
        sent = []

        def load():
            r = np.random.RandomState(21)
            # bounded: every record must stay in the telemetry's event ring
            while not stop.is_set() and len(sent) < 200:
                sent.append(svc.submit("m", r.rand(4, F).astype(
                    np.float32)))
                time.sleep(0.002)
        t = threading.Thread(target=load)
        t.start()
        time.sleep(0.02)
        rep = svc.rollover("m", b2)
        stop.set()
        t.join()
        for f in sent:
            f.result(timeout=10)
        # a closed loop on the idle fleet: its ties rotate over the lanes
        after = []
        for i in range(2 * NDEV):
            after.append(svc.submit("m", X[i:i + 4]))
            after[-1].result(timeout=10)
        assert rep["promoted"] and sent
        hashes = {svc.residency.get("m", d).model_hash
                  for d in range(svc.n_devices)}
        new_hash = hashes.pop()
        assert not hashes and new_hash != old_hash
        acc = {e["trace_id"]: e for e in svc.tel.snapshot()["events"]
               if e["event"] == "serve_access"}
        versions = {acc[f.trace_id]["model_version"] for f in sent}
        assert versions <= {old_hash[:16], new_hash[:16]}
        after = [acc[f.trace_id] for f in after]
        assert all(e["model_version"] == new_hash[:16] for e in after)
        assert {e["device"] for e in after} == set(range(NDEV))
        for _ in range(2 * NDEV):
            np.testing.assert_allclose(svc.predict("m", X[:16]),
                                       b2.predict(X[:16]), **TOL)
        np.testing.assert_allclose(svc.predict_bulk("m", X),
                                   b2.predict(X), **TOL)
    finally:
        svc.close()


# ----------------------------------------------------------------- bulk
def test_predict_bulk_identical_to_single_device_dispatch(bst):
    svc = _svc({"m": bst}, max_batch_rows=256, min_bucket_rows=32)
    try:
        svc.warmup()
        rng = np.random.RandomState(11)
        X = rng.rand(1000, F).astype(np.float32)
        single = svc.residency.get("m", 0).predict(X)
        bulk = svc.predict_bulk("m", X)
        assert bulk.shape == single.shape
        # predict_pass sums each row's trees in tree order whatever rows
        # share its call: the same bits
        np.testing.assert_array_equal(bulk, single)
        np.testing.assert_allclose(bulk, bst.predict(X), **TOL)
        sp = pytest.importorskip("scipy.sparse")
        np.testing.assert_array_equal(
            svc.predict_bulk("m", sp.csr_matrix(X)), single)
        fl = svc.stats()["fleet"]
        assert fl["bulk_rows"] == 2 * X.shape[0]
        assert fl["bulk_dispatches"] >= 2
    finally:
        svc.close()


def test_predict_bulk_multiclass_and_raw_score(bst_multi):
    svc = _svc({"mc": bst_multi}, max_batch_rows=128)
    try:
        svc.warmup()
        rng = np.random.RandomState(17)
        X = rng.rand(500, F).astype(np.float32)
        eng = svc.residency.get("mc", 0)
        np.testing.assert_allclose(svc.predict_bulk("mc", X),
                                   eng.predict(X), **TOL)
        np.testing.assert_allclose(
            svc.predict_bulk("mc", X, raw_score=True),
            eng.predict(X, raw_score=True), **TOL)
    finally:
        svc.close()


def test_predict_bulk_degraded_model_falls_back_to_host_walk():
    """A model the stack cannot hold (linear trees) serves predict_bulk
    through the exact float64 walk: no lane dispatch, no error."""
    rng = np.random.RandomState(8)
    X = rng.rand(300, 4)
    y = X @ np.array([1.0, 2.0, -1.0, 0.5]) + 0.05 * rng.randn(300)
    blin = lt.train({"objective": "regression", "num_leaves": 5,
                     "verbose": -1, "linear_tree": True,
                     "min_data_in_leaf": 10, "device_type": "cpu"},
                    lt.Dataset(X, label=y), 2)
    svc = _svc({"lin": blin})
    try:
        Xq = rng.rand(50, 4)
        np.testing.assert_allclose(svc.predict_bulk("lin", Xq),
                                   blin.predict(Xq), rtol=1e-9, atol=1e-12)
        assert svc.stats()["fleet"]["bulk_rows"] == 0
    finally:
        svc.close()


def test_bulk_steady_stream_recompiles_nothing(bst):
    """Repeated bulk calls of one shard size are registry hits: the bulk
    signatures live in the registry the online engines count against."""
    svc = _svc({"m": bst}, max_batch_rows=128)
    try:
        svc.warmup()
        rng = np.random.RandomState(19)
        X = rng.rand(800, F).astype(np.float32)
        svc.predict_bulk("m", X)
        c0 = svc.stats()["fleet"]["bulk_compiles"]
        for _ in range(3):
            svc.predict_bulk("m", X)
        fl = svc.stats()["fleet"]
        assert fl["bulk_compiles"] == c0
        assert fl["bulk_dispatches"] >= 4
    finally:
        svc.close()
