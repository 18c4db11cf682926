"""Two port ranks against the JAX package's two-process run, on the CPU:
the compositions whose distributed semantics is not the serial model's.

The JAX side is two processes of one host device each, joined through
``jax.distributed`` on the CPU with gloo (as ``tests/test_multiproc_train.
py`` starts them); each passes its numpy block of
``torch_dist_ranks.train_data``'s 2 x 4,096 rows, so a JAX process's
block is the port rank's block. It trains every case in sequence in the
background while the two port ranks (``parallel.spawn``, gloo, no JAX)
train the same cases. Both sides run ``tpu_engine="xla"`` (no rank block
is padded), ``tree_learner=data``, 6 columns, ``num_leaves=15`` and four
bare ``Booster.update()`` rounds:

- GOSS with ``learning_rate=0.5``, so sampling starts at 0-based
  iteration 2: each rank samples its own rows from the same seed, and the
  in-bag masks are equal row for row on both ranks at iterations 2 and 3;
- ``regression_l1`` and ``quantile`` (``alpha=0.7``): each renewed leaf
  is the average of the ranks' own percentile outputs;
- RF with ``regression_l1``: fixed gradients, bagging over the global
  rows, renewal against the base score averaged the same way;
- ``lambdarank`` on query-aligned shards with a training ``ndcg``: the
  gradients through the global query map, the metric as sums over each
  rank's queries and one host gather.

Every case: the port ranks' model texts are the same, its trees are the
JAX package's under ``torch_parity``'s tree rule, leaf values and
predictions within 1e-5; the training ``ndcg`` within 1e-7 of the JAX
package's, and the same on both ranks.
"""
import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from torch_parity import assert_same_trees

import torch_dist_ranks as tdr

N_ROWS = 2 * 4096
ROUNDS = 4
XLA = {"tree_learner": "data", "tpu_engine": "xla"}
CASES = [
    dict(name="goss", update=True, rounds=ROUNDS,
         params=dict(XLA, boosting="goss", learning_rate=0.5)),
    dict(name="l1", data="l2", update=True, rounds=ROUNDS,
         params=dict(XLA, objective="regression_l1")),
    dict(name="quantile", data="l2", update=True, rounds=ROUNDS,
         params=dict(XLA, objective="quantile", alpha=0.7)),
    dict(name="rf_l1", data="l2", update=True, rounds=ROUNDS,
         params=dict(XLA, boosting="rf", objective="regression_l1",
                     bagging_fraction=0.5, bagging_freq=1)),
    dict(name="lambdarank", data="rank", query=True, update=True,
         rounds=ROUNDS,
         params=dict(XLA, objective="lambdarank", metric="ndcg",
                     eval_at=[1, 3, 5], is_provide_training_metric=True)),
]
NAMES = [c["name"] for c in CASES]

_JAX_WORKER = """
import os, pickle, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_cpu_collectives_implementation", "gloo")
rank = int(sys.argv[2])
jax.distributed.initialize(coordinator_address=sys.argv[1], num_processes=2,
                           process_id=rank)
assert jax.device_count() == 2 and jax.process_count() == 2
sys.path[:0] = {paths!r}
import numpy as np
import lightgbm_tpu as lj
import torch_dist_ranks as tdr
out = {{}}
for c in {cases!r}:
    X, y = tdr.train_data(c.get("data", "binary"))
    Xr, yr = tdr.rank_rows(X, rank, 2), tdr.rank_rows(y, rank, 2)
    kw = {{"group": tdr.rank_group(len(yr), rank)}} if c.get("query") else {{}}
    p = tdr._case_params(c)
    p.pop("device_type")
    bst = lj.Booster(p, lj.Dataset(Xr, label=yr, **kw))
    bags = []
    for _ in range(c["rounds"]):
        bst.update()
        loc = getattr(bst._gbdt, "_bag_weight_local", None)
        bags.append(None if loc is None
                    else np.asarray(loc)[:len(yr)] > 0)
    bst.num_trees()
    out[c["name"]] = {{
        "text": bst.model_to_string(),
        "pred": bst.predict(X, raw_score=True),
        "bags": bags, "mp": bst._gbdt.mp is not None,
        "evals": (bst.eval_train() if p.get("is_provide_training_metric")
                  else [])}}
with open(sys.argv[3], "wb") as fh:
    pickle.dump(out, fh)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's two processes and the port's two ranks, all
    started here and training side by side."""
    wd = tmp_path_factory.mktemp("dist_matrix_jax")
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(here)
    script = wd / "jax_worker.py"
    script.write_text(_JAX_WORKER.format(paths=[here, repo], cases=CASES))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo)
    env.pop("XLA_FLAGS", None)
    outs = [wd / f"jax{r}.pkl" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), f"127.0.0.1:{port}", str(r),
         str(outs[r])], env=env, cwd=str(wd), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    ranks = tdr.Background(tdr.__file__ + ":train_rank", 2,
                           (CASES, str(wd)), workdir=str(wd / "ranks"),
                           deadline_s=300)
    yield ranks, procs, outs
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


@pytest.fixture(scope="module")
def port(runs):
    return runs[0].result()


@pytest.fixture(scope="module")
def jax_mp(runs):
    """[rank 0's, rank 1's] {case: result} of the JAX two-process run."""
    _, procs, outs = runs
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
    res = []
    for o in outs:
        with open(o, "rb") as fh:
            res.append(pickle.load(fh))
    assert all(r[n]["mp"] for r in res for n in NAMES)
    return res


@pytest.mark.parametrize("name", NAMES)
def test_ranks_train_the_jax_two_process_model(port, jax_mp, name):
    case = CASES[NAMES.index(name)]
    a, b = port[0][name], port[1][name]
    assert "error" not in a, a.get("error")
    assert "error" not in b, b.get("error")
    assert a["text"] == b["text"]
    ja, jb = jax_mp[0][name], jax_mp[1][name]
    assert ja["text"] == jb["text"]
    X, _ = tdr.train_data(case.get("data", "binary"))
    jax_models = lt.Booster(model_str=ja["text"]).models
    assert len(a["models"]) == ROUNDS
    assert_same_trees(a["models"], jax_models, X, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a["pred"], ja["pred"], rtol=1e-5, atol=1e-5)


def test_goss_masks_are_the_jax_masks_row_for_row(port, jax_mp):
    """GOSS samples each rank's own rows from the same seed: at the two
    sampling iterations every rank's in-bag mask is the JAX process's."""
    for r in range(2):
        mine, theirs = port[r]["goss"]["bags"], jax_mp[r]["goss"]["bags"]
        assert len(mine) == len(theirs) == ROUNDS
        assert theirs[0] is None and theirs[1] is None
        for it in (2, 3):
            assert mine[it].shape == theirs[it].shape == (N_ROWS // 2,)
            assert 0 < mine[it].sum() < N_ROWS // 2
            np.testing.assert_array_equal(mine[it], theirs[it])


def test_training_ndcg_is_the_jax_ndcg_on_both_ranks(port, jax_mp):
    ev = [{n: v for d, n, v, _ in port[r]["lambdarank"]["evals"]}
          for r in range(2)]
    jv = {n: v for d, n, v, _ in jax_mp[0]["lambdarank"]["evals"]}
    assert sorted(ev[0]) == sorted(jv) == ["ndcg@1", "ndcg@3", "ndcg@5"]
    for n, v in jv.items():
        assert ev[0][n] == ev[1][n]
        assert abs(ev[0][n] - v) < 1e-7, (n, ev[0][n], v)
        assert 0.5 < v <= 1.0
