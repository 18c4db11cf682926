"""Checkpoints, resume, the rank-0 resync and the host-collective guard
under two ranks (``parallel.spawn.run_ranks``, two CPU ranks over gloo).

One spawn, the cases that succeed (:func:`resilience_rank`): each rank
trains its 200 rows of 400 with ``tree_learner=data`` and
``checkpoint_period`` 3, 6 rounds straight, then (the directory wiped) 3,
then a resume to 6. Each rank writes its own manifest and npz,
``select_checkpoint(world=2)`` picks the newest checkpoint both ranks
completed, and the resumed two-rank model is the uninterrupted one byte
for byte. Then the ``diverge`` fault perturbs rank 1's newest tree,
the digests part, and ``_health_resync`` (``resync_from_rank0``) on both
ranks brings them together again: rank 1's model text is rank 0's and its
scores come back to their values before the fault within 1e-6 (the
replays run in f32, so not bit for bit; rank 0 replays its own tree
likewise). Last, a trainer with ``collective_timeout`` set guards its
own gathers from the first, after one that left the policy off. The
parent, one process, is refused the two-rank checkpoint.

A second spawn (:func:`timeout_rank`) sets ``collective_timeout`` 2 and
``collective_retries`` 2: a gather whose first two attempts on rank 0
fail in transport succeeds on the third; then rank 1 sleeps through a
guarded ``multiproc._allgather``, and rank 0 raises ``CollectiveError``
within the timeout, having tried once.
"""
import os
import shutil
import time

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.parallel.spawn import run_ranks
from lightgbm_tpu_torch.resilience import checkpoint as ckpt_mod
from lightgbm_tpu_torch.utils.log import LightGBMError

P = {"objective": "binary", "num_leaves": 7, "verbose": -1,
     "device_type": "cpu", "min_data_in_leaf": 5,
     "bagging_fraction": 0.7, "bagging_freq": 2}


def _data(n=400, f=8):
    rng = np.random.RandomState(0)
    X = rng.rand(n, f).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 1).astype(np.float32)
    return X, y


def resilience_rank(rank, world, ck):
    """The first spawn's checks on one rank (the module docstring)."""
    import torch.distributed as dist
    from lightgbm_tpu_torch.obs.health import model_state_hash
    from lightgbm_tpu_torch.obs.registry import allgather_json
    from lightgbm_tpu_torch.resilience import faults
    X, y = _data()
    half = X.shape[0] // world
    rows = slice(rank * half, (rank + 1) * half)
    params = dict(P, tree_learner="data", checkpoint_dir=ck,
                  checkpoint_period=3)

    def run(rounds, resume=None):
        ds = lt.Dataset(X[rows], label=y[rows], params=dict(params))
        return lt.train(dict(params), ds, rounds, resume_from=resume)
    out = {"ref": run(6).model_to_string(num_iteration=-1)}
    dist.barrier()
    if rank == 0:
        shutil.rmtree(ck)
    dist.barrier()
    run(3)
    dist.barrier()
    sel = ckpt_mod.select_checkpoint(ck, world)
    out["selected"] = sel
    out["files"] = sorted(os.listdir(sel))
    bst = run(6, resume=ck)
    out["resumed"] = bst.model_to_string(num_iteration=-1)
    # diverge rank 1, then repair it from rank 0
    gb = bst._gbdt
    before = gb.scores.clone().numpy()
    gb._faults = faults.FaultRegistry(faults.parse_faults(
        "diverge@6:rank=1"))
    faults.maybe_diverge(gb, 6)
    per_rank = allgather_json({"rank": rank, "hash": model_state_hash(
        gb.models, rank=rank)})
    out["diverged"] = len({p["hash"] for p in per_rank}) == 2
    out["repaired"] = gb._health_resync(6, per_rank)
    out["after"] = bst.model_to_string(num_iteration=-1)
    out["score_err"] = float(np.abs(gb.scores.numpy() - before).max())
    # the previous trainer left the policy off: a trainer with
    # collective_timeout set guards its own gathers from its first, the
    # rank layout's (no bagging: every gather here is the trainer's init)
    from lightgbm_tpu_torch.resilience import comms
    run_with_timeout, guarded = comms._run_with_timeout, [0]

    def counted(*a):
        guarded[0] += 1
        return run_with_timeout(*a)
    comms._run_with_timeout = counted
    plain = dict(P, bagging_freq=0, tree_learner="data")
    lt.train(dict(plain, collective_timeout=30.0),
             lt.Dataset(X[rows], label=y[rows], params=dict(plain)), 1)
    comms._run_with_timeout = run_with_timeout
    out["guarded_gathers"] = guarded[0]
    return out


def timeout_rank(rank, world):
    """The second spawn's checks on one rank (the module docstring)."""
    import torch.distributed as dist
    from lightgbm_tpu_torch.parallel import multiproc
    from lightgbm_tpu_torch.resilience import comms
    comms.set_collective_policy(2.0, retries=2)
    real = dist.all_gather
    calls = {"n": 0, "fail": 2 if rank == 0 else 0}

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["fail"]:
            calls["fail"] -= 1
            raise RuntimeError("transport hiccup")
        return real(*a, **k)
    dist.all_gather = flaky
    out = {"gathered": multiproc._allgather(
        np.array([rank + 10])).reshape(-1).tolist(),
        "attempts": calls["n"]}
    calls["n"] = 0
    if rank == 1:
        time.sleep(4.0)
    t0 = time.perf_counter()
    try:
        multiproc._allgather(np.array([rank]))
        out["timeout"] = None
    except comms.CollectiveError as e:
        out["timeout"] = str(e)
    out["seconds"] = time.perf_counter() - t0
    out["timeout_attempts"] = calls["n"]
    dist.all_gather = real
    # rank 1's late gather paired rank 0's abandoned one: the group is
    # still in step
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("dist_resilience"))
    ck = os.path.join(wd, "ck")
    res = run_ranks(os.path.abspath(__file__) + ":resilience_rank", 2,
                    (ck,), workdir=wd + "/ranks", deadline_s=240)
    return res, ck


def test_per_rank_manifests_and_two_rank_resume(ranks):
    res, ck = ranks
    for r in res:
        assert r["selected"].endswith("ckpt_0000000003")
        assert r["files"] == ["rank0.json", "rank0.npz", "rank1.json",
                              "rank1.npz"]
        assert r["resumed"] == r["ref"]
    assert res[0]["ref"] == res[1]["ref"]
    # the resumed run's checkpoint at 6 is complete on both ranks
    assert ckpt_mod.select_checkpoint(ck, 2).endswith("ckpt_0000000006")
    mans = ckpt_mod.checkpoint_manifests(
        ckpt_mod.select_checkpoint(ck, 2), 2)
    assert [m["rank"] for m in mans] == [0, 1]
    assert {m["world"] for m in mans} == {2}


def test_world2_checkpoint_refused_by_one_process(ranks):
    from lightgbm_tpu_torch.resilience import state as rstate
    _, ck = ranks
    X, y = _data()
    params = dict(P, checkpoint_dir=ck, checkpoint_period=3)
    with pytest.raises(LightGBMError, match="no complete 1-rank checkpoint"):
        lt.train(params, lt.Dataset(X[:200], label=y[:200]), 6,
                 resume_from=ck)
    payload, arrays = ckpt_mod.load_rank(ckpt_mod.select_checkpoint(ck, 2),
                                         0)
    bst = lt.Booster(params=params, train_set=lt.Dataset(X[:200],
                                                         label=y[:200]))
    with pytest.raises(LightGBMError, match="written by a 2-process run; "
                       "this run spans 1 processes"):
        rstate.restore(bst._gbdt, payload, arrays)


def test_diverged_rank_resyncs_from_rank0(ranks):
    res, _ = ranks
    assert all(r["diverged"] and r["repaired"] for r in res)
    assert res[1]["after"] == res[0]["after"] == res[0]["resumed"]
    # rank 0 replays its own tree (subtract, add) as rank 1 replays the
    # repaired one: the same replays on every rank, f32 rounding on both
    assert all(r["score_err"] <= 1e-6 for r in res)


def test_trainer_gathers_under_its_own_policy(ranks):
    res, _ = ranks
    assert all(r["guarded_gathers"] > 0 for r in res)


def test_guarded_gather_times_out_and_retries(tmp_path):
    res = run_ranks(os.path.abspath(__file__) + ":timeout_rank", 2, (),
                    workdir=str(tmp_path), deadline_s=120)
    for r in res:
        assert r["gathered"] == [10, 11]
    assert [r["attempts"] for r in res] == [3, 1]
    r0, r1 = res
    assert "timed out after 2.0s" in r0["timeout"]
    assert r0["seconds"] < 3.0 and r0["timeout_attempts"] == 1
    assert r1["timeout"] is None
