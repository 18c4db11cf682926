"""The port's serving plane (``lightgbm_tpu_torch/serve/``) against the JAX
package's, on the CPU.

The counterparts of the 16 tests of ``tests/test_serve.py``. One model is
trained by the port; its model text is served by both packages, and the
JAX package's ``ServingEngine`` on that text (binned routing through a
training set binned by the JAX package, or raw routing for the model file)
is the reference the port's engine and service are held to, within rtol
1e-6 (both sum the same float32 leaf values in tree order). After warmup a
stream of mixed request sizes counts no new signature and at most one
dispatch per micro-batch.
"""
import json

import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.serve import ServingEngine as JEngine
from lightgbm_tpu_torch.obs import Telemetry
from lightgbm_tpu_torch.serve import (MicroBatcher, PredictionService,
                                      ResidencyManager, ServingEngine)

TOL = dict(rtol=1e-5, atol=1e-6)   # f32 device sums against the f64 walk
JAX_TOL = dict(rtol=1e-6, atol=1e-7)
F = 8
CPU = {"device_type": "cpu"}
BUCKETS = dict(max_batch_rows=128, min_bucket_rows=32)


def _data(seed=0, n=400, f=F):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 1.0).astype(np.float32)
    return X, y


PARAMS = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.2,
          "verbose": -1, "min_data_in_leaf": 5}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The port's live booster, its model file, and the JAX package's
    boosters on the same text: ``jfile`` (raw routing) and ``jlive`` (the
    text with a JAX-binned training set attached: binned routing)."""
    X, y = _data()
    bst = lt.train(dict(PARAMS, **CPU), lt.Dataset(X, label=y), 6)
    path = str(tmp_path_factory.mktemp("serve") / "m.txt")
    bst.save_model(path)
    jlive = jlgb.Booster(model_file=path)
    jlive.train_set = jlgb.Dataset(X, label=y, params=dict(PARAMS))
    jlive.train_set.construct()
    return {"bst": bst, "path": path,
            "loaded": lt.Booster(params=CPU, model_file=path),
            "jfile": jlgb.Booster(model_file=path), "jlive": jlive,
            "jeng": {}}


def _jax_ref(models, which, Xq, **kw):
    """The JAX package's ServingEngine on the same model text."""
    raw_score = kw.pop("raw_score", False)
    key = (which, tuple(sorted(kw.items())))
    eng = models["jeng"].get(key)
    if eng is None:
        eng = models["jeng"][key] = JEngine(models[which], **BUCKETS, **kw)
    return eng.predict(Xq, raw_score=raw_score)


def _queries(rng, sizes, f=F):
    return [rng.rand(int(s), f).astype(np.float32) for s in sizes]


# ---------------------------------------------------------------- engine
def test_engine_binned_parity(models):
    bst = models["bst"]
    eng = ServingEngine(bst, **BUCKETS)
    assert eng.variant == "binned" and eng.device_ok
    rng = np.random.RandomState(1)
    for Xq in _queries(rng, [1, 33, 150]):
        got = eng.predict(Xq)
        np.testing.assert_allclose(got, bst.predict(Xq), **TOL)
        np.testing.assert_allclose(got, _jax_ref(models, "jlive", Xq),
                                   **JAX_TOL)


def test_engine_raw_parity_file_loaded(models):
    loaded = models["loaded"]
    assert loaded.train_set is None
    eng = ServingEngine(loaded, **BUCKETS)
    assert eng.variant == "raw" and eng.device_ok, eng.degraded_reason
    rng = np.random.RandomState(3)
    for Xq in _queries(rng, [1, 19, 140]):
        got = eng.predict(Xq)
        np.testing.assert_allclose(got, loaded.predict(Xq), **TOL)
        np.testing.assert_allclose(got, _jax_ref(models, "jfile", Xq),
                                   **JAX_TOL)


def test_engine_raw_leaf_routing_bit_identical(models):
    """Per-tree routing matches the float64 walk exactly for float32
    inputs: each one-tree output is leaf_value[walk leaf] as float32."""
    loaded = models["loaded"]
    rng = np.random.RandomState(5)
    Xq = rng.rand(128, F).astype(np.float32)
    leaves = loaded.predict(Xq, pred_leaf=True)
    for ti, tree in enumerate(loaded.models[:3]):
        eng = ServingEngine(loaded, max_batch_rows=128, min_bucket_rows=128,
                            start_iteration=ti, num_iteration=1)
        dev = eng.predict_raw(Xq)[0]
        expect = tree.leaf_value[leaves[:, ti]].astype(np.float32)
        np.testing.assert_array_equal(dev.astype(np.float32), expect)


def test_engine_zero_recompiles_after_warmup(models):
    eng = ServingEngine(models["bst"], **BUCKETS)
    warm = eng.warmup()
    assert warm["warmed"] == [32, 64, 128]
    c0, d0 = eng.compiles, eng.dispatches
    rng = np.random.RandomState(7)
    sizes = [1, 3, 32, 33, 100, 128, 200, 5]
    for Xq in _queries(rng, sizes):
        np.testing.assert_allclose(eng.predict(Xq),
                                   _jax_ref(models, "jlive", Xq), **JAX_TOL)
    assert eng.compiles == c0, "mixed-size stream took a new signature"
    # one dispatch per <=128-row request; the 200-row one chunks into 2
    assert eng.dispatches - d0 == len(sizes) + 1


def test_engine_degrades_linear_tree_to_host_walk():
    rng = np.random.RandomState(8)
    X = rng.rand(300, 4)
    y = X @ np.array([1.0, 2.0, -1.0, 0.5]) + 0.05 * rng.randn(300)
    p = {"objective": "regression", "num_leaves": 5, "verbose": -1,
         "linear_tree": True, "min_data_in_leaf": 10, **CPU}
    blin = lt.train(p, lt.Dataset(X, label=y, params=p), 2)
    tel = Telemetry(enabled=True)
    eng = ServingEngine(blin, telemetry=tel)
    assert not eng.device_ok and eng.degraded_reason == "linear_tree"
    Xq = rng.rand(9, 4)
    got = eng.predict(Xq)
    np.testing.assert_allclose(got, blin.predict(Xq), rtol=1e-9,
                               atol=1e-12)
    jeng = JEngine(jlgb.Booster(model_str=blin.model_to_string()))
    assert jeng.degraded_reason == "linear_tree"
    np.testing.assert_allclose(got, jeng.predict(Xq), **JAX_TOL)
    snap = tel.snapshot()
    reasons = [e for e in snap["events"]
               if e["event"] == "serve_degradation"]
    assert reasons and reasons[0]["reason"] == "linear_tree"
    assert snap["counters"].get("serve.host_rows", 0) == 9


def test_engine_sparse_request():
    sp = pytest.importorskip("scipy.sparse")
    Xs = sp.random(400, 20, density=0.1, random_state=9, format="csr")
    ys = (np.asarray(Xs.sum(axis=1)).ravel() > 1.0).astype(np.float32)
    bsp = lt.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
                    "min_data_in_leaf": 5, **CPU},
                   lt.Dataset(Xs, label=ys, params=CPU), 3)
    Xq = sp.random(40, 20, density=0.1, random_state=10, format="csr")
    eng = ServingEngine(bsp, **BUCKETS)
    got = eng.predict(Xq)
    np.testing.assert_allclose(got, bsp.predict(Xq), **TOL)
    np.testing.assert_allclose(
        got, jlgb.Booster(model_str=bsp.model_to_string()).predict(Xq),
        **TOL)


# --------------------------------------------------------------- batcher
def test_batcher_coalesces_slices_and_caps():
    calls = []

    def dispatch(mid, X):
        calls.append(X.shape[0])
        return X.sum(axis=1)

    b = MicroBatcher(dispatch, max_batch_rows=12, max_delay_ms=30.0)
    try:
        rng = np.random.RandomState(0)
        reqs = [rng.rand(3, 4) for _ in range(10)]
        futs = [b.submit("m", X) for X in reqs]
        outs = [f.result(timeout=10) for f in futs]
        for X, out in zip(reqs, outs):
            np.testing.assert_allclose(out, X.sum(axis=1))
        assert len(calls) < len(reqs)        # coalescing happened
        assert sum(calls) == 30
        assert all(c <= 12 for c in calls)   # strict row cap
    finally:
        b.close()


def test_batcher_isolates_models_and_errors():
    def dispatch(mid, X):
        if mid == "bad":
            raise ValueError("boom")
        return np.full(X.shape[0], 7.0)

    b = MicroBatcher(dispatch, max_batch_rows=64, max_delay_ms=5.0)
    try:
        ok = b.submit("good", np.zeros((2, 2)))
        bad = b.submit("bad", np.zeros((2, 2)))
        np.testing.assert_allclose(ok.result(timeout=10), [7.0, 7.0])
        with pytest.raises(ValueError, match="boom"):
            bad.result(timeout=10)
        # the queue survives the poisoned request
        again = b.submit("good", np.zeros((1, 2)))
        np.testing.assert_allclose(again.result(timeout=10), [7.0])
    finally:
        b.close()


def test_batcher_groups_by_column_count():
    widths = []

    def dispatch(mid, X):
        widths.append(X.shape[1])
        return np.zeros(X.shape[0])

    b = MicroBatcher(dispatch, max_batch_rows=64, max_delay_ms=30.0)
    try:
        futs = [b.submit("m", np.zeros((2, w))) for w in (4, 5, 4)]
        for f in futs:
            f.result(timeout=10)
        # the width-4 requests coalesced; the width-5 one went alone
        assert sorted(widths) == [4, 5]
    finally:
        b.close()


def test_batcher_cancelled_future_does_not_wedge_worker():
    import threading
    import time as _t
    block = threading.Event()

    def dispatch(mid, X):
        block.wait(2)
        return np.zeros(X.shape[0])

    b = MicroBatcher(dispatch, max_batch_rows=1, max_delay_ms=1.0)
    try:
        f1 = b.submit("a", np.zeros((1, 2)))   # the worker blocks here
        _t.sleep(0.05)
        f2 = b.submit("a", np.zeros((1, 2)))   # still queued
        assert f2.cancel()
        block.set()
        f1.result(timeout=5)
        f3 = b.submit("a", np.zeros((1, 2)))   # the worker survived
        f3.result(timeout=5)
    finally:
        block.set()
        b.close()


def test_batcher_close_rejects_new_submits():
    b = MicroBatcher(lambda mid, X: np.zeros(X.shape[0]))
    b.close()
    fut = b.submit("m", np.zeros((1, 2)))
    with pytest.raises(RuntimeError):
        fut.result(timeout=5)


# ------------------------------------------------------------- residency
def test_residency_lru_eviction_and_pin(models):
    bst = models["bst"]
    tel = Telemetry(enabled=True)
    # three model ids over the same booster: the same packed bytes and
    # signatures, distinct resident engines
    one = ServingEngine(bst, **BUCKETS).packed_nbytes
    assert one > 0
    mgr = ResidencyManager(budget_bytes=int(one * 2.5), telemetry=tel,
                           **BUCKETS)
    for i in range(3):
        mgr.register(f"m{i}", bst)
    mgr.get("m0")
    mgr.get("m1")
    assert set(mgr.resident()) == {"m0", "m1"}
    mgr.get("m2")                      # over budget: m0 is LRU
    assert set(mgr.resident()) == {"m1", "m2"}
    snap = tel.snapshot()
    assert snap["counters"]["serve.evictions"] == 1
    ev = [e for e in snap["events"] if e["event"] == "serve_eviction"]
    assert ev and ev[0]["model_id"] == "m0"
    mgr.get("m0")                      # rebuilt; m1 is the LRU now
    assert "m0" in mgr.resident() and "m1" not in mgr.resident()
    assert tel.snapshot()["counters"]["serve.rebuilds"] == 1
    mgr.pin("m2")                      # pinned models are never evicted
    mgr.get("m1")
    assert "m2" in mgr.resident()
    with pytest.raises(KeyError):
        mgr.get("nope")


# --------------------------------------------------------------- service
def test_service_acceptance_mixed_sizes_zero_recompiles(models):
    """Warmup, then a mixed-size stream over a live and a file-loaded
    model: no new signature, at most one dispatch per micro-batch, the
    answers the JAX package's engines give on the same text."""
    svc = PredictionService({"live": models["bst"], "file": models["path"]},
                            max_delay_ms=1.0, batch_events=False,
                            device_type="cpu", **BUCKETS)
    try:
        svc.warmup()
        s0 = svc.stats()
        rng = np.random.RandomState(31)
        sizes = [1, 2, 17, 40, 100, 128, 9, 33]
        for i, Xq in enumerate(_queries(rng, sizes)):
            mid = ("live", "file")[i % 2]
            got = svc.predict(mid, Xq)
            want = _jax_ref(models, "jlive" if mid == "live" else "jfile",
                            Xq)
            np.testing.assert_allclose(got, want, **JAX_TOL)
            np.testing.assert_allclose(got, models["bst"].predict(Xq),
                                       **TOL)
        s1 = svc.stats()
        assert s1["compiles"] == s0["compiles"], \
            "the request stream took a new signature after warmup"
        batches = s1["batches"] - s0["batches"]
        dispatches = s1["dispatches"] - s0["dispatches"]
        assert batches == len(sizes)          # sequential: no coalescing
        assert dispatches <= batches          # <=1 dispatch per batch
    finally:
        svc.close()


def test_service_concurrent_submits_coalesce(models):
    svc = PredictionService({"m": models["bst"]}, max_delay_ms=20.0,
                            batch_events=False, device_type="cpu",
                            **BUCKETS)
    try:
        svc.warmup()
        s0 = svc.stats()
        rng = np.random.RandomState(33)
        reqs = [rng.rand(4, F).astype(np.float32) for _ in range(16)]
        futs = [svc.submit("m", X) for X in reqs]
        outs = [f.result(timeout=30) for f in futs]
        for X, out in zip(reqs, outs):
            np.testing.assert_allclose(out, _jax_ref(models, "jlive", X),
                                       **JAX_TOL)
        s1 = svc.stats()
        batches = s1["batches"] - s0["batches"]
        assert batches < len(reqs), "no coalescing happened"
        assert s1["dispatches"] - s0["dispatches"] <= batches
        assert s1["latency_ms"] and s1["latency_ms"]["count"] >= 16
    finally:
        svc.close()


def test_service_telemetry_jsonl_events(models, tmp_path):
    out = str(tmp_path / "serve.jsonl")
    svc = PredictionService({"m": models["bst"]}, telemetry_out=out,
                            max_delay_ms=1.0, device_type="cpu", **BUCKETS)
    try:
        svc.warmup()
        svc.predict("m", np.random.RandomState(35).rand(5, F))
    finally:
        svc.close()
    events = [json.loads(line) for line in open(out)]
    names = {e["event"] for e in events}
    assert {"serve_start", "serve_model_loaded", "serve_warmup",
            "serve_batch", "serve_stats", "serve_access"} <= names
    batch = next(e for e in events if e["event"] == "serve_batch")
    assert batch["rows"] == 5 and batch["requests"] == 1
    stats = next(e for e in events if e["event"] == "serve_stats")
    assert stats["requests"] == 1 and stats["dispatches_per_request"] >= 1
    # the planes still to be ported feed no key
    assert "drift" not in stats


def test_service_specs_raw_score_num_iteration(models, tmp_path):
    svc = PredictionService([models["bst"]], max_delay_ms=1.0,
                            raw_score=True, num_iteration=3,
                            device_type="cpu", **BUCKETS)
    try:
        assert svc.model_ids() == ["0"]
        Xq = np.random.RandomState(38).rand(21, F).astype(np.float32)
        got = svc.predict("0", Xq)
        np.testing.assert_allclose(
            got, models["bst"].predict(Xq, raw_score=True, num_iteration=3),
            **TOL)
        np.testing.assert_allclose(
            got, _jax_ref(models, "jlive", Xq, raw_score=True,
                          num_iteration=3), **JAX_TOL)
        with pytest.raises(KeyError):
            svc.submit("1", np.zeros((1, F)))
    finally:
        svc.close()
    with pytest.raises(FileNotFoundError):
        PredictionService({"x": str(tmp_path / "missing.txt")},
                          device_type="cpu")
