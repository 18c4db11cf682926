"""Checkpoints across the two packages: one format, one digest, one resume.

The JAX package trains 400 x 8 rows, binary, ``num_leaves`` 7, 12 rounds
on its fused engine (``tpu_megastep`` and ``tpu_fused_epilogue`` off, so
its cadence is the engine's per iteration) with ``checkpoint_period`` 6:
checkpoints at 6 and 12. Then:

- ``model_state_hash`` of the same trees is equal in both packages (each
  function on each package's trees, against the JAX manifest's digest);
- the port's ``load_rank`` and ``booster_from_checkpoint`` read the JAX
  checkpoint, and the JAX package's read the port's, with raw predictions
  within 1e-6 of the writing booster's;
- the port resumes from the JAX checkpoint at 6 and trains to 12, and its
  trees are the JAX package's uninterrupted 12-round trees (structure
  equal under tests/torch_parity.py's near-tie rule, leaf values within
  rtol 1e-5, atol 1e-6: f32 sums in another order).

CEGB (``cegb_penalty_feature_coupled``): neither package's checkpoint
holds ``cegb_used``, so a resumed booster pays the coupled penalties again
and parts from the uninterrupted model, in both packages alike; the
port's resumed trees are the JAX package's resumed trees. One JAX
configuration besides it (CEGB takes the XLA engine in both packages).
"""
import shutil

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.obs.health import model_state_hash as j_hash
from lightgbm_tpu.resilience import checkpoint as j_ckpt
from lightgbm_tpu.resilience import state as j_state
from lightgbm_tpu_torch.obs.health import model_state_hash as t_hash
from lightgbm_tpu_torch.resilience import checkpoint as t_ckpt
from lightgbm_tpu_torch.resilience import state as t_state
from torch_parity import assert_same_trees

torch.set_num_threads(1)

P = {"objective": "binary", "num_leaves": 7, "verbose": -1,
     "tpu_engine": "fused", "tpu_megastep": False,
     "tpu_fused_epilogue": False, "checkpoint_period": 6}
CEGB = {"objective": "binary", "num_leaves": 7, "verbose": -1,
        "cegb_penalty_feature_coupled": [5.0] * 8, "checkpoint_period": 3}


def _data():
    rng = np.random.RandomState(0)
    X = rng.rand(400, 8).astype(np.float32)
    y = (X[:, 0] + X[:, 1] + 0.5 * X[:, 2] > 1.2).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("resilience_jax") / "ck")
    X, y = _data()
    bj = lj.train(dict(P, checkpoint_dir=ck), lj.Dataset(X, label=y), 12)
    return bj, ck, X, y


def test_model_state_hash_is_one_digest(jax_run):
    bj, ck, _, _ = jax_run
    payload, arrays = t_ckpt.load_rank(t_ckpt.select_checkpoint(ck, 1), 0)
    port_trees = t_state.trees_from_arrays(payload["trees_meta"], arrays)
    want = payload["model_hash"]
    assert j_hash(bj.models, rank=-1) == want
    assert t_hash(bj.models, rank=-1) == want
    assert t_hash(port_trees, rank=-1) == want
    assert j_hash(port_trees, rank=-1) == want


def test_each_package_reads_the_others_checkpoint(jax_run, tmp_path):
    bj, ck, X, y = jax_run
    # the JAX checkpoint in the port
    payload, _ = t_ckpt.load_rank(ck + "/ckpt_0000000012", 0)
    assert payload["iteration"] == 12 and payload["boosting"] == "gbdt"
    bt = t_state.booster_from_checkpoint(ck, params={"device_type": "cpu"})
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=0,
                               atol=1e-6)
    # the port's checkpoint in the JAX package
    ckt = str(tmp_path / "ck")
    port = lt.train(dict(P, checkpoint_dir=ckt, device_type="cpu"),
                    lt.Dataset(X, label=y), 6)
    sel = j_ckpt.select_checkpoint(ckt, 1)
    assert sel.endswith("ckpt_0000000006")
    payload, arrays = j_ckpt.load_rank(sel, 0)
    assert payload["model_hash"] == t_hash(port.models, rank=-1)
    bjt = j_state.booster_from_checkpoint(ckt)
    np.testing.assert_allclose(bjt.predict(X, raw_score=True),
                               port.predict(X, raw_score=True), rtol=0,
                               atol=1e-6)


def test_port_resumes_a_jax_checkpoint(jax_run):
    bj, ck, X, y = jax_run
    bt = lt.train(dict(P, checkpoint_dir=ck, device_type="cpu"),
                  lt.Dataset(X, label=y), 12,
                  resume_from=ck + "/ckpt_0000000006")
    assert bt.num_trees() == 12
    # the six restored trees are the JAX package's, bit for bit
    assert t_hash(bt.models[:6], rank=-1) == j_hash(bj.models[:6], rank=-1)
    assert_same_trees(bt.models, bj.models, X.astype(np.float64))
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)


def _cegb_runs(pkg, ck, extra):
    X, y = _data()
    p = dict(CEGB, checkpoint_dir=ck, **extra)
    full = pkg.train(p, pkg.Dataset(X, label=y), 6)
    shutil.rmtree(ck)
    pkg.train(p, pkg.Dataset(X, label=y), 3)
    resumed = pkg.train(p, pkg.Dataset(X, label=y), 6, resume_from=ck)
    return full, resumed


def test_cegb_resume_parts_alike_in_both_packages(tmp_path):
    """A documented divergence the port matches: CEGB's used-feature state
    is not checkpointed by the JAX package, so neither resume gives the
    uninterrupted model, and both give the same resumed trees."""
    X, _ = _data()
    j_full, j_res = _cegb_runs(lj, str(tmp_path / "j"), {})
    t_full, t_res = _cegb_runs(lt, str(tmp_path / "t"),
                               {"device_type": "cpu"})
    assert j_res.model_to_string(num_iteration=-1) \
        != j_full.model_to_string(num_iteration=-1)
    assert t_res.model_to_string(num_iteration=-1) \
        != t_full.model_to_string(num_iteration=-1)
    X64 = X.astype(np.float64)
    assert_same_trees(t_full.models, j_full.models, X64)
    assert_same_trees(t_res.models, j_res.models, X64)
