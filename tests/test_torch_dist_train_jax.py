"""Two port ranks' ``train()`` against the JAX package, on the CPU.

The ranks (``parallel.spawn``, gloo, no JAX) train on their contiguous
blocks of ``torch_dist_ranks.train_data``'s 8,192 rows; the JAX package
trains in the pytest process, or, for voting, in a subprocess with two
host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=2``), so
that its mesh holds the port's two row blocks:

- ``tree_learner=data`` on the XLA engine: the JAX package's serial model
  (data-parallel's contract), under ``torch_parity``'s tree rule, the
  predictions within 1e-5;
- ``tree_learner=voting``, 2 of 6 columns voted, on the XLA engine and on
  the fused engine: the JAX package's voting model on the same two row
  blocks;
- the driver's options on the fused engine (the other half of
  ``torch_dist_ranks.DRIVER_CASES`` is held in test_torch_dist_train.py):
  bagging drawn over the global rows, 16-bit quantized gradients (the
  group's scales, the dither hashing global rows), a categorical column
  with a basic monotone constraint, and a valid set with early stopping
  (metrics on the global view): the JAX package's serial model, structure
  and leaf counts exact, leaf values and predictions within 1e-5, the
  early-stopping iteration equal. Against the port's own serial run the
  quantized model is exact (test_torch_dist_train.py).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from torch_parity import assert_same_trees

import torch_dist_ranks as tdr

XLA = {"tpu_engine": "xla"}
OPTIONS = ("bagging", "quant16", "cat_mono", "valid_es")
CASES = [
    dict(name="xla_data", params=dict(XLA, tree_learner="data")),
    dict(name="xla_vote", params=dict(XLA, tree_learner="voting", top_k=2)),
    tdr.DRIVER_CASES["voting"],
] + [tdr.DRIVER_CASES[n] for n in OPTIONS]
ROUNDS = 3
VOTING = (CASES[1], CASES[2])
SEP = "=== next model ===\n"

_JAX_VOTING = """
import sys
sys.path[:0] = {paths!r}
import numpy as np, lightgbm_tpu as lj, torch_dist_ranks as tdr
X, y = tdr.train_data()
for params in {params!r}:
    p = dict(tdr._case_params({{}}), tpu_engine="fused")
    p.update(params)
    p.pop("device_type")
    print(lj.train(p, lj.Dataset(X, label=y), {rounds}).model_to_string())
    print({sep!r}, end="")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ranks and the JAX voting subprocess, both started here
    and running while the tests train the JAX package in this process."""
    wd = str(tmp_path_factory.mktemp("dist_train_jax"))
    here = os.path.dirname(os.path.abspath(__file__))
    code = _JAX_VOTING.format(paths=[here, os.path.dirname(here)],
                              params=[c["params"] for c in VOTING],
                              rounds=ROUNDS, sep=SEP)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    jax_voting = subprocess.Popen([sys.executable, "-c", code], env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
    ranks = tdr.Background(tdr.__file__ + ":train_rank", 2, (CASES, wd),
                           workdir=wd, deadline_s=300)
    yield ranks, jax_voting
    if jax_voting.poll() is None:
        jax_voting.kill()
    jax_voting.wait()


@pytest.fixture(scope="module")
def jax_voting_texts(runs):
    """{case name: the JAX package's 2-device voting model text}."""
    stdout, stderr = runs[1].communicate(timeout=300)
    assert runs[1].returncode == 0, stderr[-3000:]
    texts = stdout.split(SEP)[:len(VOTING)]
    return {c["name"]: t[t.index("tree\n"):] for c, t in zip(VOTING, texts)}


@pytest.fixture(scope="module")
def jax_serial():
    """The JAX package's serial model of a DRIVER_CASES case, trained
    once."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = tdr.serial_run(lj, tdr.DRIVER_CASES[name])
        return cache[name]
    return get


def _port_models(text):
    return lt.Booster(model_str=text).models


def _assert_same_text_trees(port, jax, rtol=1e-5, atol=1e-6):
    """Trees read from model text (real-valued thresholds, no bins):
    equal structure and thresholds, leaf values within rtol/atol."""
    assert len(port) == len(jax)
    for a, b in zip(port, jax):
        assert a.num_leaves == b.num_leaves
        for k in ("split_feature", "threshold", "left_child", "right_child",
                  "leaf_count", "decision_type"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=rtol,
                                   atol=atol)


def test_data_parallel_xla_is_the_jax_serial_model(runs):
    X, y = tdr.train_data()
    p = tdr._case_params(CASES[0])
    p.pop("device_type")
    p.pop("tree_learner")
    bj = lj.train(p, lj.Dataset(X, label=y), ROUNDS)
    bj.num_trees()          # drains the lazily built host trees
    ranks = runs[0].result()
    a, b = ranks[0]["xla_data"], ranks[1]["xla_data"]
    assert a["text"] == b["text"]
    assert_same_trees(a["models"], bj.models, X)
    np.testing.assert_allclose(a["pred"], bj.predict(X, raw_score=True),
                               rtol=1e-5, atol=1e-5)


def test_voting_xla_is_the_jax_voting_model(runs, jax_voting_texts):
    ranks = runs[0].result()
    a, b = ranks[0]["xla_vote"], ranks[1]["xla_vote"]
    assert a["text"] == b["text"]
    _assert_same_text_trees(_port_models(a["text"]),
                            _port_models(jax_voting_texts["xla_vote"]))


def test_voting_fused_is_the_jax_voting_model(runs, jax_voting_texts):
    ranks = runs[0].result()
    a, b = ranks[0]["voting"], ranks[1]["voting"]
    assert "error" not in a, a.get("error")
    assert a["text"] == b["text"]
    _assert_same_text_trees(_port_models(a["text"]),
                            _port_models(jax_voting_texts["voting"]))


@pytest.mark.parametrize("name", OPTIONS)
def test_driver_options_are_the_jax_serial_model(runs, jax_serial, name):
    bj = jax_serial(name)
    ranks = runs[0].result()
    a, b = ranks[0][name], ranks[1][name]
    assert "error" not in a, a.get("error")
    assert a["text"] == b["text"]
    tdr.assert_same_as_jax(a, bj, tdr.DRIVER_CASES[name])


def test_quantized_data_parallel_first_tree_is_the_jax_tree(runs,
                                                            jax_serial):
    """The first quantized tree (its gradients from a constant score) under
    the serial tests' bar, rtol 1e-5 and atol 1e-6."""
    X, _ = tdr.train_data()
    bj = jax_serial("quant16")
    ranks = runs[0].result()
    a = ranks[0]["quant16"]
    assert a["text"] == ranks[1]["quant16"]["text"]
    assert bj._gbdt.quant_bits == 16
    assert_same_trees(a["models"][:1], bj.models[:1], X)
