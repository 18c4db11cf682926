"""The compositions whose distributed model is the serial one, on two port
ranks on the CPU, and what two ranks still refuse.

One module fixture spawns two ranks (``parallel.spawn``, gloo, no JAX),
each passing its contiguous block of ``torch_dist_ranks.train_data``'s
8,192 rows (every row in the binning sample, so the ranks' mappers are the
serial ones), and trains every case there while the pytest process trains
the JAX package's serial models. Every case's ranks emit the same model
text, and the ranks grow the serial model on all the rows, against the
port's serial run and the JAX package's (structure and leaf counts exact
under ``torch_parity``'s tree rule, leaf values and predictions within
1e-5):

- DART and RF (bagging over the global rows) on the XLA engine;
- CEGB with a split penalty on the depth-wise XLA grower, its lazy
  penalties dropped with the JAX package's warning (so the serial model
  is the one without them);
- forced splits under data and under voting (2 of 6 columns voted; the
  forced features' columns are always summed) on the leaf-wise grower;
- dense EFB on the fused engine, data-parallel: the bundle layout from
  the gathered sample, each rank's rows encoded with it;
- ``rank_xendcg`` on query-aligned shards: the Gumbel draw over the global
  queries, so every query's gradients are the serial ones;
- ``lambdarank`` on the fused engine over rank blocks of 4,000 rows, which
  it pads to 4,096, so the query row map skips pads: the serial trees, and
  the training NDCG and MAP within 1e-7 of the serial metrics' on the
  ranks' own scores.

Voting on bundles (2 of 8 columns voted, the fused engine) is held to the
JAX package's voting model on a two-device mesh holding the same two row
blocks, trained in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=2``: the ranks sum the
winners' decoded planes, as it does. Then the refusals and errors: sparse
input is refused on both ranks in the JAX package's words; a query that
straddles the ranks raises on both; and GOSS with a rank that holds no
rows finishes, every collective joined, as the serial GOSS model of the
other rank's rows.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.binning import mappers_digest
from torch_parity import assert_same_trees

import torch_dist_ranks as tdr

DATA = {"tree_learner": "data"}
XLA = dict(DATA, tpu_engine="xla")
FORCED = {"feature": 0, "threshold": 0.0,
          "left": {"feature": 1, "threshold": 0.0}}
LAZY = [0.5] * 6
SERIAL_CASES = [
    dict(name="dart", params=dict(XLA, boosting="dart")),
    dict(name="rf", params=dict(XLA, boosting="rf", bagging_fraction=0.5,
                                bagging_freq=1)),
    dict(name="cegb", params=dict(XLA, cegb_penalty_split=0.1,
                                  cegb_penalty_feature_lazy=LAZY)),
    dict(name="forced_data", forced=True, params=XLA),
    dict(name="forced_vote", forced=True,
         params=dict(XLA, tree_learner="voting", top_k=2)),
    dict(name="efb", data="efb", params=dict(DATA, tpu_engine="fused")),
    dict(name="xendcg", data="rank", query=True,
         params=dict(XLA, objective="rank_xendcg")),
]
SERIAL_NAMES = [c["name"] for c in SERIAL_CASES]
# the serial model each case must grow: voting grows the data model, and
# CEGB the model without its lazy penalties
SERIAL_OF = {"forced_vote": "forced_data"}
# 2 of the 8 logical columns voted, 4 summed a level. (At top_k=1 the
# first tree's last level takes a split of gain 9.5e-7 that the JAX
# package's planes, decoded in another order, round to <= 0: a zero-gain
# near-tie, which the tree rule does not cover.)
EFB_VOTE = dict(name="efb_vote", data="efb",
                params={"tree_learner": "voting", "top_k": 2,
                        "tpu_engine": "fused"})
# lambdarank on the fused engine with rank blocks of 4,000 rows, which the
# engine pads to 4,096: the row map skips the pads; NDCG and MAP on the
# training rows
RANK_PADDED = dict(name="rank_padded", data="rank", query=True, n=8000,
                   params=dict(DATA, tpu_engine="fused",
                               objective="lambdarank", metric="ndcg,map",
                               eval_at=[1, 3, 5],
                               is_provide_training_metric=True))
REFUSED = [
    dict(name="sparse", sparse=True, params=DATA),
    dict(name="straddle", data="rank", query=True, straddle=True,
         params=dict(XLA, objective="lambdarank")),
    dict(name="goss_zero", drop_rows=True, update=True, rounds=3,
         params=dict(XLA, boosting="goss", learning_rate=0.5)),
]
ROUNDS = 3
SEP = "=== next model ===\n"

_JAX_VOTING = """
import sys
sys.path[:0] = {paths!r}
import lightgbm_tpu as lj, torch_dist_ranks as tdr
X, y = tdr.train_data("efb")
p = tdr._case_params({case!r})
p.pop("device_type")
print(lj.train(p, lj.Dataset(X, label=y), {rounds}).model_to_string())
print({sep!r}, end="")
"""


def _serial_case(c):
    """The serial twin of a case: its params less the parallel keys and
    the lazy CEGB penalties, which two ranks drop."""
    c = dict(SERIAL_CASES[SERIAL_NAMES.index(SERIAL_OF.get(c["name"],
                                                           c["name"]))])
    c["params"] = {k: v for k, v in c["params"].items()
                   if k != "cegb_penalty_feature_lazy"}
    return c


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks and the JAX voting subprocess, started here and running
    while the tests train the serial models in this process."""
    wd = str(tmp_path_factory.mktemp("dist_matrix"))
    with open(f"{wd}/forced.json", "w") as fh:
        json.dump(FORCED, fh)
    here = os.path.dirname(os.path.abspath(__file__))
    code = _JAX_VOTING.format(paths=[here, os.path.dirname(here)],
                              case=EFB_VOTE, rounds=ROUNDS, sep=SEP)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    jax_voting = subprocess.Popen([sys.executable, "-c", code], env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
    cases = SERIAL_CASES + [EFB_VOTE, RANK_PADDED] + REFUSED
    ranks = tdr.Background(tdr.__file__ + ":train_rank", 2, (cases, wd),
                           workdir=wd, deadline_s=300)
    yield ranks, jax_voting, wd
    if jax_voting.poll() is None:
        jax_voting.kill()
    jax_voting.wait()


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0].result()


@pytest.fixture(scope="module")
def serial(runs):
    """{(package, case name): the serial booster}, trained once."""
    import lightgbm_tpu as lj
    cache = {}

    def get(lib, name):
        key = (lib.__name__, SERIAL_OF.get(name, name))
        if key not in cache:
            cache[key] = tdr.serial_run(
                lib, _serial_case({"name": name}), workdir=runs[2])
        return cache[key]
    return lambda name: (get(lt, name), get(lj, name))


@pytest.mark.parametrize("name", SERIAL_NAMES)
def test_ranks_grow_the_serial_model(ranks, serial, name):
    a, b = ranks[0][name], ranks[1][name]
    assert "error" not in a, a.get("error")
    assert "error" not in b, b.get("error")
    assert a["text"] == b["text"]
    case = SERIAL_CASES[SERIAL_NAMES.index(name)]
    port, jax = serial(name)
    X, _ = tdr.train_data(case.get("data", "binary"))
    assert a["digest"] == mappers_digest(port.train_set._inner.mappers)
    assert len(a["models"]) == ROUNDS
    for ref in (port, jax):
        assert_same_trees(a["models"], ref.models, X, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a["pred"], ref.predict(X, raw_score=True),
                                   rtol=1e-5, atol=1e-5)
    if name == "efb":
        assert a["use_bundles"] and port._gbdt.use_bundles
    if name.startswith("forced"):
        # every tree starts with the JSON's two splits
        for m in a["models"]:
            assert list(m.split_feature[:2]) == [0, 1]


def test_padded_rank_blocks_rank_as_the_serial_model(ranks):
    """lambdarank over rank blocks the fused engine pads: the ranks grow
    the port's serial model on all the rows, and their training NDCG and
    MAP (sums over each rank's queries, one host gather) are the serial
    metrics' on the same scores."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.metric import MapMetric, NDCGMetric
    a, b = ranks[0]["rank_padded"], ranks[1]["rank_padded"]
    assert "error" not in a, a.get("error")
    assert "error" not in b, b.get("error")
    assert a["text"] == b["text"] and a["evals"] == b["evals"]
    assert a["block"] == 4096 and a["scores"].shape == (1, 4000)
    port = tdr.serial_run(lt, RANK_PADDED)
    X, _ = tdr.train_data("rank", n=8000)
    assert_same_trees(a["models"], port.models, X, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a["pred"], port.predict(X, raw_score=True),
                               rtol=1e-5, atol=1e-5)
    got = {m: v for _, m, v, _ in a["evals"]}
    assert sorted(got) == ["map@1", "map@3", "map@5", "ndcg@1", "ndcg@3",
                           "ndcg@5"]
    # the serial run's own metrics: its NDCG is the float32 device form
    # (a few f32 ulps of 0.95 apart), its MAP the float64 host form
    want = {m: v for _, m, v, _ in port.eval_train()}
    for m in got:
        tol = 1e-6 if m.startswith("ndcg") else 1e-7
        assert abs(got[m] - want[m]) <= tol, (m, got[m], want[m])
    # the serial metrics' float64 host forms on the ranks' own scores
    md = port.train_set._inner.metadata
    scores = np.concatenate([a["scores"], b["scores"]], axis=1)
    cfg = Config(RANK_PADDED["params"])
    for cls in (NDCGMetric, MapMetric):
        metric = cls(cfg)
        metric.init(md, scores.shape[1])
        for name, v in zip(metric.names, metric.eval(scores, None)):
            assert abs(got[name] - v) <= 1e-7, (name, got[name], v)


def test_lazy_cegb_penalties_are_dropped_with_the_warning(tmp_path):
    """Two ranks warn that the lazy penalties are dropped, in the JAX
    package's words, and train on."""
    out = tdr.Background(tdr.__file__ + ":warned_rank", 2,
                         (dict(SERIAL_CASES[2]),),
                         workdir=str(tmp_path), deadline_s=120).result()
    for said in out:
        assert any("dropping the lazy penalties for this parallel run" in m
                   for m in said), said


def test_voting_on_bundles_is_the_jax_voting_model(runs, ranks):
    a, b = ranks[0]["efb_vote"], ranks[1]["efb_vote"]
    assert "error" not in a, a.get("error")
    assert a["text"] == b["text"] and a["use_bundles"]
    stdout, stderr = runs[1].communicate(timeout=600)
    assert runs[1].returncode == 0, stderr[-3000:]
    text = stdout.split(SEP)[0]
    jm = lt.Booster(model_str=text[text.index("tree\n"):]).models
    X, _ = tdr.train_data("efb")
    assert_same_trees(a["models"], jm, X, rtol=1e-5, atol=1e-5)
    jp = lt.Booster(params={"device_type": "cpu"},
                    model_str=text).predict(X, raw_score=True)
    np.testing.assert_allclose(a["pred"], jp, rtol=1e-5, atol=1e-5)


def test_sparse_input_is_refused_in_the_reference_words(ranks):
    for r in ranks:
        err = r["sparse"].get("error", "")
        assert err.startswith("LightGBMError"), err
        assert ("sparse-built (prebundled) datasets derive their bundle "
                "layout from rank-local CSC columns") in err, err


def test_a_query_that_straddles_the_ranks_raises_on_both(ranks):
    for r in ranks:
        err = r["straddle"].get("error", "")
        assert "query-aligned sharding was violated" in err, err


def test_goss_with_a_rank_without_rows_finishes(ranks):
    a, b = ranks[0]["goss_zero"], ranks[1]["goss_zero"]
    assert "error" not in a, a.get("error")
    assert "error" not in b, b.get("error")
    assert a["text"] == b["text"] and len(a["models"]) == ROUNDS
    assert b["bags"][-1].shape == (0,)
    # rank 0's rows alone: the serial GOSS model of them
    X, y = tdr.train_data()
    X0, y0 = tdr.rank_rows(X, 0, 2), tdr.rank_rows(y, 0, 2)
    p = tdr._case_params(REFUSED[2])
    p.pop("tree_learner")
    bst = lt.Booster(p, lt.Dataset(X0, label=y0))
    for _ in range(ROUNDS):
        bst.update()
    assert_same_trees(a["models"], bst.models, X0, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(a["bags"][-1], bst._gbdt._bag_host)
