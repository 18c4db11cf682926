"""``train()`` with ``tree_learner`` data and voting on two port ranks, on
the CPU.

One module fixture spawns two ranks (``parallel.spawn``: gloo over a
``file://`` store under the test's temporary directory, no JAX in the
ranks), each passing only its own contiguous block of 8,192 rows (a
multiple of 2 x 2048, so no rank block is padded), and trains every
configuration of ``torch_dist_ranks.DRIVER_CASES`` there: binary, L2,
multiclass, bagging, 16-bit quantized gradients, a categorical column with
a basic monotone constraint, a valid set with early stopping, voting with
2 of 6 columns voted, the epilogue body (bare ``Booster.update``) and the
XLA engine. Every rank's model text is the same, and data-parallel grows
the serial model:

- against the JAX package's serial model on all the rows (trained here
  while the ranks run; the other half of the cases in
  ``test_torch_dist_train_jax.py``): structure and leaf counts exact under
  ``torch_parity``'s tree rule, leaf values and predictions within 1e-5,
  the early-stopping iteration equal;
- against the port's serial run on the same rows: the same, the quantized
  leaf values exactly.

Every rank bins from the gathered sample, so its mappers are the serial
ones; ranks of a group that ask for no parallel learner bin and train on
their own rows, and a training Dataset constructed before its params named
the learner (so binned from the rank's rows alone) raises on every rank.
Then the compositions two ranks refused until ROADMAP Queue A item 9c:
GOSS, DART, RF, a leaf-renewal objective, ranking, CEGB, forced splits
and EFB each train one model, the same text on both ranks (their models
are held to the serial and JAX models in test_torch_dist_matrix.py and
test_torch_dist_matrix_jax.py); sparse input and ``linear_tree`` are
refused in the JAX package's words, and a valid set that differs across
ranks raises on both. No
failure hangs: a rank that dies fails the run at once, a peer that never
joins an all-reduce times the waiting rank out (the group's timeout), and
ranks asked for a missing card raise.
"""
import json
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.binning import mappers_digest
from lightgbm_tpu_torch.parallel.spawn import run_ranks

import torch_dist_ranks as tdr

DATA = tdr.DATA
OK_CASES = list(tdr.DRIVER_CASES.values())
# the OK cases held here against the JAX package's serial model; bagging,
# quant16, cat_mono and valid_es are held in test_torch_dist_train_jax.py,
# so that --dist loadfile runs the two halves of the JAX side beside each
# other. Voting (2 of 6 columns voted) and bare update() grow the binary
# case's serial model.
JAX_HERE = ("binary", "l2", "multiclass", "voting", "update", "xla")
SERIAL_TWIN = {"voting": "binary", "update": "binary"}
ONCE_REFUSED = [
    dict(name="goss", params=dict(DATA, boosting="goss")),
    dict(name="dart", params=dict(DATA, boosting="dart")),
    dict(name="rf", params=dict(DATA, boosting="rf", bagging_fraction=0.5,
                                bagging_freq=1)),
    dict(name="l1", data="l2", params=dict(DATA, objective="regression_l1")),
    dict(name="rank", query=True, params=dict(DATA, objective="lambdarank")),
    dict(name="cegb", params=dict(DATA, cegb_penalty_split=0.1)),
    dict(name="forced", forced=True, params=DATA),
    dict(name="efb", data="efb", params=DATA),
    dict(name="sparse", sparse=True, params=DATA),
]
LINEAR = dict(name="linear", params=dict(DATA, linear_tree=True))
DIVERGE = dict(name="diverge", valid="diverge", params=DATA)
# no tree_learner: each rank of the group trains a serial model of its own
# rows, binned from its own sample
OWN = dict(name="own_serial", params={})
# constructed before train() names tree_learner: each rank's own mappers
PRE = dict(name="preconstructed", preconstruct=True, params=DATA)
ALL = OK_CASES + ONCE_REFUSED + [LINEAR, DIVERGE, OWN, PRE]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The two ranks, running in the background while the first test
    trains the JAX package in this process."""
    wd = str(tmp_path_factory.mktemp("dist_train"))
    with open(f"{wd}/forced.json", "w") as fh:
        json.dump({"feature": 0, "threshold": 0.0}, fh)
    return tdr.Background(tdr.__file__ + ":train_rank", 2, (ALL, wd),
                          workdir=wd, deadline_s=300)


@pytest.fixture(scope="module")
def ranks(spawned):
    return spawned.result()


@pytest.fixture(scope="module")
def jax_serial():
    """The JAX package's serial model of a case, trained once."""
    import lightgbm_tpu as lj
    cache = {}

    def get(name):
        name = SERIAL_TWIN.get(name, name)
        if name not in cache:
            cache[name] = tdr.serial_run(lj, tdr.DRIVER_CASES[name])
        return cache[name]
    return get


@pytest.mark.parametrize("name", JAX_HERE)
def test_ranks_train_the_jax_serial_model(spawned, jax_serial, name):
    bj = jax_serial(name)
    ranks = spawned.result()
    a, b = ranks[0][name], ranks[1][name]
    assert "error" not in a, a.get("error")
    assert a["text"] == b["text"]
    tdr.assert_same_as_jax(a, bj, tdr.DRIVER_CASES[name])


@pytest.mark.parametrize("case", OK_CASES, ids=[c["name"] for c in OK_CASES])
def test_ranks_train_the_serial_model(ranks, case):
    a, b = ranks[0][case["name"]], ranks[1][case["name"]]
    assert "error" not in a, a.get("error")
    assert a["text"] == b["text"]
    serial = tdr.serial_run(lt, case)
    assert a["digest"] == mappers_digest(serial.train_set._inner.mappers)
    assert len(a["models"]) == len(serial.models)
    exact = case["name"] == "quant16"
    for ta, ts in zip(a["models"], serial.models):
        assert ta.num_leaves == ts.num_leaves
        for k in ("split_feature", "threshold", "left_child", "right_child",
                  "leaf_count", "decision_type"):
            np.testing.assert_array_equal(getattr(ta, k), getattr(ts, k), k)
        if exact:
            np.testing.assert_array_equal(ta.leaf_value, ts.leaf_value)
        else:
            np.testing.assert_allclose(ta.leaf_value, ts.leaf_value,
                                       rtol=1e-5, atol=1e-6)
    X, _ = tdr.train_data(case.get("data", "binary"))
    np.testing.assert_allclose(a["pred"], serial.predict(X, raw_score=True),
                               rtol=1e-5, atol=1e-5)
    if case.get("early_stop"):
        assert a["best_iteration"] == serial.best_iteration
        assert 0 < a["best_iteration"] < case["rounds"]


def test_a_group_without_tree_learner_bins_and_trains_per_rank(ranks):
    """A process group alone is no request to distribute: ranks that pass
    no tree_learner bin from their own rows and train their own serial
    models, as one process would, without a collective."""
    X, y = tdr.train_data()
    texts = []
    for r in range(2):
        res = ranks[r]["own_serial"]
        assert "error" not in res, res.get("error")
        assert res["trace"][0] == 0
        ds = lt.Dataset(tdr.rank_rows(X, r, 2), label=tdr.rank_rows(y, r, 2))
        bst = lt.train(tdr._case_params(OWN), ds, 3)
        assert res["digest"] == mappers_digest(ds._inner.mappers)
        assert res["text"] == bst.model_to_string()
        texts.append(res["text"])
    assert ranks[0]["own_serial"]["digest"] != ranks[1]["own_serial"]["digest"]
    assert texts[0] != texts[1]


def test_voting_moves_fewer_bytes_than_data(ranks):
    assert ranks[0]["voting"]["trace"][1] < ranks[0]["binary"]["trace"][1]
    assert "int32" in ranks[0]["voting"]["trace"][2]


@pytest.mark.parametrize("case", ONCE_REFUSED,
                         ids=[c["name"] for c in ONCE_REFUSED])
def test_unported_combinations_raise_item_9c(ranks, case):
    """The compositions ROADMAP Queue A item 9c ported: each trains one
    model whose text is the same on both ranks; sparse input alone stays
    refused, on both ranks, in the JAX package's words."""
    a, b = (r[case["name"]] for r in ranks)
    if case["name"] == "sparse":
        for res in (a, b):
            err = res.get("error", "")
            assert err.startswith("LightGBMError"), err
            assert ("sparse-built (prebundled) datasets derive their "
                    "bundle layout from rank-local CSC columns and are not "
                    "supported with multi-process training") in err, err
        return
    assert "error" not in a, a.get("error")
    assert "error" not in b, b.get("error")
    assert a["text"] == b["text"]
    assert len(a["models"]) == 3
    assert any(m.num_leaves > 1 for m in a["models"])
    if case["name"] == "efb":
        assert a["use_bundles"]


def test_linear_tree_is_refused_in_the_reference_words(ranks):
    for r in ranks:
        err = r["linear"].get("error", "")
        assert "linear_tree is serial-only" in err, err


def test_divergent_valid_sets_raise_on_every_rank(ranks):
    for r in ranks:
        err = r["diverge"].get("error", "")
        assert "valid set differs across ranks" in err, err


def test_mappers_that_differ_across_ranks_raise(ranks):
    for r in ranks:
        err = r["preconstructed"].get("error", "")
        assert "bin mappers differ across ranks" in err, err


def test_one_rank_trains_serially_with_the_warning():
    """No group: ``tree_learner=data`` warns and trains the serial model
    (the JAX package's rule for fewer than two devices)."""
    from lightgbm_tpu_torch.utils import log
    X, y = tdr.train_data()
    p = tdr._case_params({})
    serial = lt.train(p, lt.Dataset(X, label=y), 2)
    said = []
    log.register_logger(said.append)
    try:
        dp = lt.train(dict(p, tree_learner="data"), lt.Dataset(X, label=y),
                      2)
    finally:
        log.register_logger(None)
    assert any("only one device is visible; training serially" in m
               for m in said), said
    for ta, ts in zip(dp.models, serial.models):
        np.testing.assert_array_equal(ta.leaf_value, ts.leaf_value)
        np.testing.assert_array_equal(ta.split_feature, ts.split_feature)


def test_a_dead_rank_fails_the_run(tmp_path):
    """A rank that exits ends the run at once: every rank is killed and
    the error names the rank (the parent never waits for the deadline)."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 exited with code 3"):
        run_ranks(tdr.__file__ + ":dead_rank", 2, ("exit",),
                  workdir=str(tmp_path), deadline_s=120)
    assert time.monotonic() - t0 < 60


def test_a_missing_peer_times_the_collective_out(tmp_path):
    """A peer that never joins an all-reduce: the group's timeout raises
    in the waiting rank instead of blocking it for good."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 exited"):
        run_ranks(tdr.__file__ + ":dead_rank", 2, ("late",),
                  workdir=str(tmp_path), deadline_s=120, timeout_s=3)
    assert time.monotonic() - t0 < 20


def test_no_rank_carries_on_without_its_card(tmp_path):
    """Ranks asked for the card on a machine without one raise; none
    trains on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device is present"):
        run_ranks(tdr.__file__ + ":dead_rank", 2, ("exit",),
                  workdir=str(tmp_path), device_type="cuda",
                  backend="gloo", deadline_s=120)
