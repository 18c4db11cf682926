"""The port's fault tolerance (``lightgbm_tpu_torch/resilience/``), port
only, on the CPU.

Module tests, each the counterpart of a JAX package test in
``tests/test_resilience.py``: atomic writes leave no temp file; the
checkpoint manager commits, selects and loads, skips a torn npz or
manifest, keeps the newest two and never selects an incomplete world;
the fault spec parses and fires at most once across a respawn (a fresh
registry on the same state directory); the ``torn_ckpt`` fault leaves a
checkpoint the selector skips; ``guarded_call`` times out without retry
and retries a transport error; the resync blob round-trips.

Then the trainer: train straight through against train, stop and resume
(``train(resume_from=...)``) gives byte-equal model text on the megastep,
epilogue and synchronous bodies (gbdt with bagging, feature_fraction and
early stopping; the epilogue body; GOSS, DART, RF, multiclass,
``linear_tree``, quant16 with gain screening). The recorded curve
continues across a resume; a wrong boosting, a changed number of valid
sets and a torn checkpoint are refused in the JAX package's words;
``reset_parameter`` keeps, replaces and closes the writer without
leaking its thread; ``train()`` returns with its last checkpoint
committed; ``save_model`` is the atomic write (a failed rename leaves the
old model and no temp file; a save fsyncs). Tiny data (400 x 8,
``num_leaves`` 7, 6-14 rounds).
"""
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.resilience import atomicio
from lightgbm_tpu_torch.resilience import checkpoint as ckpt_mod
from lightgbm_tpu_torch.resilience import comms, faults, recovery
from lightgbm_tpu_torch.resilience import state as rstate
from lightgbm_tpu_torch.obs.health import model_state_hash
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

CPU = {"device_type": "cpu", "verbose": -1}


def _data(seed=0, n=400, f=8):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 1).astype(np.float32)
    return X, y


def _noisy_valid():
    """Valid labels unrelated to the rows: the valid loss bottoms out
    early, so early stopping fires after the resume point."""
    X, _ = _data(seed=7, n=150)
    return X, np.random.RandomState(8).randint(0, 2, 150).astype(
        np.float32)


def _train(params, X, y, n_rounds, valid=None, cbs=None, resume=None,
           **kw):
    ds = lt.Dataset(X, label=y, params=dict(CPU))
    vs = None
    if valid is not None:
        vs = [lt.Dataset(valid[0], label=valid[1], reference=ds)]
    return lt.train(dict(CPU, **params), ds, num_boost_round=n_rounds,
                    valid_sets=vs, callbacks=list(cbs or []),
                    resume_from=resume, **kw)


# ---------------------------------------------------------- atomic IO
def test_atomic_write_roundtrip_and_no_temp_litter(tmp_path):
    p = tmp_path / "out.txt"
    atomicio.atomic_write_text(str(p), "hello")
    assert p.read_text() == "hello"
    atomicio.atomic_write_json(str(tmp_path / "out.json"), {"a": 1})
    assert json.loads((tmp_path / "out.json").read_text()) == {"a": 1}
    with pytest.raises(RuntimeError):
        with atomicio.atomic_stream(str(tmp_path / "s.bin")) as fh:
            fh.write(b"half")
            raise RuntimeError("boom")
    assert sorted(os.listdir(tmp_path)) == ["out.json", "out.txt"]


def test_save_model_is_the_atomic_write(tmp_path, monkeypatch):
    """A failed rename leaves the old model whole and no temp file beside
    it; a successful save fsyncs (the JAX package's ``save_model``)."""
    X, y = _data(n=200, f=4)
    bst = _train({"objective": "binary", "num_leaves": 7}, X, y, 2)
    out = tmp_path / "model.txt"
    synced = []
    real_fsync = os.fsync
    monkeypatch.setattr(os, "fsync",
                        lambda fd: (synced.append(fd), real_fsync(fd)))
    bst.save_model(str(out))
    assert synced, "save_model did not fsync"
    good = out.read_text()
    assert "Tree=1" in good

    def boom(src, dst):
        raise OSError("rename failed")
    monkeypatch.setattr(os, "replace", boom)
    bst.update()
    with pytest.raises(OSError, match="rename failed"):
        bst.save_model(str(out))
    assert out.read_text() == good
    assert os.listdir(tmp_path) == ["model.txt"]


# --------------------------------------------------- checkpoint manager
def _mk_manager(tmp_path, keep=2):
    return ckpt_mod.CheckpointManager(str(tmp_path / "ck"), rank=0,
                                      world=1, keep=keep)


def _save(mgr, iteration, h="abc"):
    """Enqueue one checkpoint and join the writer thread's commit."""
    mgr.save(iteration, {"model_hash": h, "iteration": iteration},
             {"a": np.arange(iteration + 1)})
    mgr.wait()


def test_checkpoint_commit_select_load(tmp_path):
    mgr = _mk_manager(tmp_path)
    _save(mgr, 4)
    _save(mgr, 8)
    root = str(tmp_path / "ck")
    assert [it for it, _ in ckpt_mod.list_checkpoints(root)] == [8, 4]
    sel = ckpt_mod.select_checkpoint(root, world=1)
    assert sel and sel.endswith("ckpt_0000000008")
    assert sorted(os.listdir(sel)) == ["rank0.json", "rank0.npz"]
    payload, arrays = ckpt_mod.load_rank(sel, 0)
    assert payload["iteration"] == 8
    assert np.array_equal(arrays["a"], np.arange(9))
    assert mgr.last_written["iteration"] == 8
    assert mgr.last_written["bytes"] == os.path.getsize(
        os.path.join(sel, "rank0.npz"))


def test_torn_npz_and_torn_manifest_are_skipped(tmp_path):
    mgr = _mk_manager(tmp_path, keep=4)
    for it in (4, 8, 12):
        _save(mgr, it)
    root = str(tmp_path / "ck")
    with open(os.path.join(root, "ckpt_0000000012", "rank0.npz"),
              "r+b") as fh:
        fh.truncate(10)                  # torn npz: size != manifest's
    with open(os.path.join(root, "ckpt_0000000008", "rank0.json"),
              "w") as fh:
        fh.write('{"schema": 1, "rank"')     # torn manifest
    sel = ckpt_mod.select_checkpoint(root, world=1)
    assert sel and sel.endswith("ckpt_0000000004")
    with pytest.raises(FileNotFoundError):
        ckpt_mod.load_rank(os.path.join(root, "ckpt_0000000008"), 0)


def test_checkpoint_pruning_keeps_newest_two(tmp_path):
    mgr = _mk_manager(tmp_path, keep=2)
    for it in (2, 4, 6, 8):
        _save(mgr, it)
    root = str(tmp_path / "ck")
    assert [it for it, _ in ckpt_mod.list_checkpoints(root)] == [8, 6]


def test_incomplete_world_checkpoint_not_selected(tmp_path):
    # rank 0 of a two-rank run committed, rank 1 did not
    mgr = _mk_manager(tmp_path)
    _save(mgr, 4)
    root = str(tmp_path / "ck")
    assert ckpt_mod.select_checkpoint(root, world=1) is not None
    assert ckpt_mod.select_checkpoint(root, world=2) is None


# ------------------------------------------------------ fault registry
def test_fault_spec_parse_and_at_most_once(tmp_path):
    fl = faults.parse_faults("crash@5:rank=1, diverge@3 ,junk,hang@2")
    assert [(f.kind, f.iteration, f.rank) for f in fl] == \
        [("crash", 5, 1), ("diverge", 3, -1), ("hang", 2, -1)]
    reg = faults.FaultRegistry(fl, state_dir=str(tmp_path / "fs"))
    assert reg.due("crash", 5, rank=1) is not None
    assert reg.due("crash", 5, rank=1) is None          # fired
    assert reg.due("crash", 5, rank=0) is None          # wrong rank
    # a respawned process: a fresh registry sees the marker file
    reg2 = faults.FaultRegistry(faults.parse_faults("crash@5:rank=1"),
                                state_dir=str(tmp_path / "fs"))
    assert reg2.due("crash", 5, rank=1) is None
    reg3 = faults.FaultRegistry(faults.parse_faults("crash@5:rank=1"))
    assert reg3.due("crash", 7, rank=1) is None
    assert reg3.due("crash", 7, rank=1, at_or_after=True) is not None


def test_torn_ckpt_fault_produces_unselectable_checkpoint(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv(faults.FAULTS_ENV, "torn_ckpt@8")
    monkeypatch.setenv(faults.FAULT_STATE_ENV, str(tmp_path / "fs"))
    mgr = _mk_manager(tmp_path, keep=4)
    _save(mgr, 4)
    _save(mgr, 8)        # torn: half the npz, no manifest
    root = str(tmp_path / "ck")
    assert mgr.last_written["iteration"] == 4
    assert os.listdir(os.path.join(root, "ckpt_0000000008")) \
        == ["rank0.npz"]
    assert ckpt_mod.select_checkpoint(root, world=1) \
        .endswith("ckpt_0000000004")
    _save(mgr, 12)       # fired once: later writes commit
    assert ckpt_mod.select_checkpoint(root, world=1) \
        .endswith("ckpt_0000000012")


# --------------------------------------------------- guarded collectives
def test_guarded_call_timeout_and_retry():
    calls = {"hang": 0, "flaky": 0}

    def hang():
        calls["hang"] += 1
        time.sleep(3)

    def flaky():
        calls["flaky"] += 1
        if calls["flaky"] == 1:
            raise OSError("transport hiccup")
        return 42
    comms.set_collective_policy(0.2, retries=1)
    try:
        t0 = time.perf_counter()
        with pytest.raises(comms.CollectiveError, match="timed out"):
            comms.guarded_call(hang, what="unit")
        assert time.perf_counter() - t0 < 1.5 and calls["hang"] == 1
        assert comms.guarded_call(flaky, what="unit") == 42
        assert calls["flaky"] == 2
        with pytest.raises(comms.CollectiveError, match="failed after 2"):
            comms.guarded_call(
                lambda: (_ for _ in ()).throw(OSError("down")), what="unit")
    finally:
        comms.set_collective_policy(0.0)
    # with no timeout it is the direct call
    assert comms.guarded_call(lambda: "direct") == "direct"


def test_models_blob_roundtrip_and_diff():
    X, y = _data(seed=1, n=300, f=5)
    bst = _train({"objective": "binary", "num_leaves": 7,
                  "linear_tree": True}, X, y, 3)
    models = bst.models
    back = recovery.deserialize_models_blob(
        recovery.serialize_models_blob(models))
    assert len(back) == len(models)
    assert model_state_hash(back, rank=-1) == model_state_hash(models,
                                                               rank=-1)
    assert not any(recovery._trees_differ(a, b)
                   for a, b in zip(models, back))
    assert [b.leaf_coeff for b in back] == [m.leaf_coeff for m in models]
    back[1].leaf_value = back[1].leaf_value + 1e-3
    assert recovery._trees_differ(models[1], back[1])


# -------------------------------------------------- resume identity
def _assert_resume_identity(tmp_path, params, n1, n2, valid=None,
                            cbs_factory=lambda: [], data=_data):
    """Train n2 rounds straight through against n1 and a resume to n2:
    byte-equal model text. Every run has the same parameters
    (``checkpoint_dir`` is echoed into the model text), the directory
    wiped in between."""
    ck = tmp_path / "ck"
    params = dict(params, checkpoint_dir=str(ck), checkpoint_period=3)
    X, y = data()
    ref = _train(params, X, y, n2, valid=valid, cbs=cbs_factory())
    ref_str = ref.model_to_string(num_iteration=-1)
    shutil.rmtree(ck)
    _train(params, X, y, n1, valid=valid, cbs=cbs_factory())
    resumed = _train(params, X, y, n2, valid=valid, cbs=cbs_factory(),
                     resume=str(ck))
    assert resumed.model_to_string(num_iteration=-1) == ref_str
    assert resumed.num_trees() == ref.num_trees()
    return ref, resumed, ck


def _class3():
    X, _ = _data()
    return X, np.minimum((X[:, 0] * 3).astype(int), 2).astype(np.float32)


BIN = {"objective": "binary", "num_leaves": 7}
RESUME_CASES = {
    "gbdt_bagging_ff_early_stop": (dict(
        BIN, bagging_fraction=0.7, bagging_freq=2, feature_fraction=0.8),
        5, 14, "megastep"),
    "epilogue": (dict(BIN, tpu_megastep=False, bagging_fraction=0.7,
                      bagging_freq=1), 6, 10, "epilogue"),
    # learning_rate 0.2: GOSS sampling (and its MT19937 stream) engages
    # from iteration 5, straddling the resume
    "goss": (dict(BIN, boosting="goss", learning_rate=0.2), 8, 12, "sync"),
    "dart": ({"objective": "regression", "boosting": "dart",
              "num_leaves": 7, "drop_rate": 0.5}, 6, 10, "sync"),
    "rf": (dict(BIN, boosting="rf", bagging_fraction=0.7, bagging_freq=1),
           6, 10, "sync"),
    "multiclass": ({"objective": "multiclass", "num_class": 3,
                    "num_leaves": 7}, 6, 10, "megastep"),
    "linear_tree": ({"objective": "regression", "linear_tree": True,
                     "num_leaves": 7}, 6, 10, "sync"),
    "quant16_screening": (dict(
        BIN, tpu_quantized_grad=16, tpu_gain_screening=True,
        tpu_screening_warmup=2, tpu_screening_keep_ratio=0.5), 6, 10,
        "megastep"),
}


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_resume_identity(case, tmp_path, monkeypatch):
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    params, n1, n2, body = RESUME_CASES[case]
    ran = {"megastep": 0, "epilogue": 0, "sync": 0}
    # RF's own train_one_iter is its synchronous body
    for name, cls, attr in (("megastep", gbdt_mod.GBDT, "_fused_iter_body"),
                            ("epilogue", gbdt_mod.GBDT, "_epi_iter_body"),
                            ("sync", gbdt_mod.GBDT, "_sync_iter_body"),
                            ("sync", gbdt_mod.RF, "train_one_iter")):
        real = getattr(cls, attr)

        def counted(self, *a, _real=real, _name=name, **k):
            ran[_name] += 1
            return _real(self, *a, **k)
        monkeypatch.setattr(cls, attr, counted)
    valid, cbs = None, (lambda: [])
    if case == "gbdt_bagging_ff_early_stop":
        valid = _noisy_valid()
        cbs = (lambda: [lt.early_stopping(4, verbose=False)])
    ref, resumed, ck = _assert_resume_identity(
        tmp_path, params, n1, n2, valid=valid, cbs_factory=cbs,
        data=_class3 if case == "multiclass" else _data)
    assert ran[body] > 0 and sum(ran.values()) == ran[body], ran
    if valid is not None:
        # early stopping fired after the resume point, from restored bests
        assert n1 < ref.current_iteration() < n2
        assert resumed.best_iteration == ref.best_iteration
        assert resumed.current_iteration() == ref.current_iteration()
    if case == "quant16_screening":
        _, arrays = ckpt_mod.load_rank(
            ckpt_mod.select_checkpoint(str(ck), 1), 0)
        assert np.abs(arrays["gain_ema"]).sum() > 0


def test_resume_records_eval_history(tmp_path):
    ck = tmp_path / "ck"
    Xv, yv = _data(seed=3, n=150)
    params = dict(BIN, checkpoint_dir=str(ck), checkpoint_period=3)
    X, y = _data()
    rec_ref, rec_a, rec_b = {}, {}, {}
    _train(params, X, y, 10, valid=(Xv, yv),
           cbs=[lt.record_evaluation(rec_ref)])
    shutil.rmtree(ck)
    _train(params, X, y, 6, valid=(Xv, yv),
           cbs=[lt.record_evaluation(rec_a)])
    _train(params, X, y, 10, valid=(Xv, yv),
           cbs=[lt.record_evaluation(rec_b)], resume=str(ck))
    # the whole curve, not the tail after the checkpoint at 6
    assert rec_b == rec_ref
    assert len(rec_b["valid_0"]["binary_logloss"]) == 10


def test_resume_key_booster_from_checkpoint_and_init_model(tmp_path):
    """The ``resume`` key resumes as ``resume_from`` does and wins over
    ``init_model``; ``booster_from_checkpoint`` of the last checkpoint
    predicts as the booster at that iteration, and a checkpoint's manifest
    and npz are the per-rank files."""
    ck = tmp_path / "ck"
    params = dict(BIN, checkpoint_dir=str(ck), checkpoint_period=3)
    X, y = _data()
    ref = _train(params, X, y, 9)
    sel = ckpt_mod.select_checkpoint(str(ck), 1)
    assert sel.endswith("ckpt_0000000009")
    b = rstate.booster_from_checkpoint(str(ck), params=dict(CPU))
    assert b.num_trees() == 9
    np.testing.assert_array_equal(b.predict(X, raw_score=True),
                                  ref.predict(X, raw_score=True))
    ref_str = ref.model_to_string(num_iteration=-1)
    shutil.rmtree(ck)
    first = _train(params, X, y, 6)
    resumed = _train(dict(params, resume=str(ck)), X, y, 9,
                     init_model=first)
    assert resumed.model_to_string(num_iteration=-1) == ref_str


@pytest.mark.parametrize("what", ["boosting", "n_valid", "torn"])
def test_resume_refusals(what, tmp_path):
    ck = tmp_path / "ck"
    params = dict(BIN, checkpoint_dir=str(ck), checkpoint_period=2)
    X, y = _data()
    _train(params, X, y, 4)
    kw = {}
    if what == "boosting":
        params = dict(params, boosting="dart")
        match = "checkpoint was written by boosting=gbdt; this run is dart"
    elif what == "n_valid":
        kw["valid"] = _data(seed=3, n=150)
        match = "checkpoint carries 0 valid sets, run has 1"
    else:
        for _, path in ckpt_mod.list_checkpoints(str(ck)):
            with open(os.path.join(path, "rank0.npz"), "r+b") as fh:
                fh.truncate(10)
        match = "no complete 1-rank checkpoint under"
    with pytest.raises(LightGBMError, match=match):
        _train(params, X, y, 8, resume=str(ck), **kw)


@pytest.mark.parametrize("what", ["bag_weight", "scores"])
def test_restore_refuses_another_rows_layout(what, monkeypatch):
    """A rank of a two-process run fed a checkpoint whose rows are not its
    own: a JAX multi-process checkpoint (the full host bag weights beside
    rank-local scores), or one of other data (longer scores)."""
    X, y = _data()
    bst = lt.Booster(params=dict(CPU, **BIN, bagging_fraction=0.5,
                                 bagging_freq=2),
                     train_set=lt.Dataset(X, label=y))
    bst.update()
    gb = bst._gbdt
    payload, arrays = rstate.capture(gb)
    payload["world"] = 2
    arrays = dict(arrays)
    arrays[what] = np.concatenate([arrays[what], arrays[what]], axis=-1)
    monkeypatch.setattr(rstate.mesh, "world", lambda: 2)
    with pytest.raises(LightGBMError,
                       match="a checkpoint from another data layout"):
        rstate.restore(gb, payload, arrays)


def _writers():
    return [t for t in threading.enumerate()
            if t.name.startswith("ckpt-writer")]


def test_reset_parameter_keeps_replaces_and_closes_writer(tmp_path):
    X, y = _data()
    before = len(_writers())
    bst = lt.Booster(params=dict(CPU, **BIN, checkpoint_dir=str(
        tmp_path / "a"), checkpoint_period=1),
        train_set=lt.Dataset(X, label=y))
    gb = bst._gbdt
    first = gb._ckpt
    assert first is not None and len(_writers()) == before + 1
    bst.update()
    assert gb.maybe_checkpoint()
    bst.reset_parameter({"learning_rate": 0.05})   # same directory: kept
    assert gb._ckpt is first
    bst.reset_parameter({"checkpoint_dir": str(tmp_path / "b")})
    assert gb._ckpt is not first and gb._ckpt.root == str(tmp_path / "b")
    # the old writer drained its checkpoint and stopped
    assert ckpt_mod.select_checkpoint(str(tmp_path / "a"), 1) is not None
    assert first._worker is None and len(_writers()) == before + 1
    bst.reset_parameter({"checkpoint_dir": ""})
    assert gb._ckpt is None and len(_writers()) == before


def test_last_checkpoint_committed_when_train_returns(tmp_path,
                                                      monkeypatch):
    """The checkpoint of the last iteration is enqueued after it; the
    writer is slowed, and ``train()`` still returns with it committed."""
    real = ckpt_mod.CheckpointManager._write

    def slow(self, *a):
        time.sleep(0.3)
        return real(self, *a)
    monkeypatch.setattr(ckpt_mod.CheckpointManager, "_write", slow)
    ck = tmp_path / "ck"
    X, y = _data()
    _train(dict(BIN, checkpoint_dir=str(ck), checkpoint_period=3), X, y, 6)
    sel = ckpt_mod.select_checkpoint(str(ck), 1)
    assert sel is not None and sel.endswith("ckpt_0000000006")


def test_cv_with_resilience_keys_does_what_the_jax_cv_does(tmp_path):
    """The JAX package's ``cv`` (``lightgbm_tpu/engine.py:397-470``) hands
    its parameters to each fold's Booster and never reaches a checkpoint
    cadence point, and only ``train`` reads ``resume``: the directory is
    made and stays empty, and a ``resume`` key changes nothing. The port's
    does the same."""
    ck = tmp_path / "ck"
    X, y = _data()
    p = dict(CPU, **BIN, checkpoint_dir=str(ck), checkpoint_period=2)
    want = lt.cv(dict(p), lt.Dataset(X, label=y), 6, nfold=3)
    assert os.listdir(ck) == []
    got = lt.cv(dict(p, resume=str(ck)), lt.Dataset(X, label=y), 6,
                nfold=3)
    assert got == want and len(got["valid binary_logloss-mean"]) == 6
    assert os.listdir(ck) == []
