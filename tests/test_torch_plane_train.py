"""The fused engine's histogram-plane cuts, as a slice, against the JAX
package.

``tpu_quantized_grad``, ``tpu_adaptive_bins`` and ``tpu_gain_screening``
through the port's ``grow_tree_fused`` and ``train()`` on the CPU (the
kernels' plain versions), on tests/test_hist_plane.py's mixed-cardinality
data and parameters:

- the grower with each cut against ``lightgbm_tpu.models.frontier2``'s:
  ``tests/test_torch_plane_grow.py`` (a file of its own, so that
  ``--dist loadfile`` runs it beside this one);
- adaptive bins: the port's trees byte-identical to its own padded run, and
  equal to the JAX fused engine's under tests/torch_parity.py's rule (f32
  sums in another order);
- quantized gradients: the first tree equal to the JAX package's (its
  gradients come from a constant score); later trees held to the JAX
  package's own bar across its training loops (accuracy within 0.04, the
  same tree count: an ulp of score drift may flip a dither); reruns
  byte-identical;
- gain screening alone: every tree equal to the JAX package's, and the
  gain EMA within rtol 1e-5;
- screening re-entry, the cuts dropped off the fused engine, the epilogue
  body refused under each cut, rollback under the packed layout, and the
  port's model text read by the JAX package.

The JAX package's packed programs fail to compile on XLA's CPU backend
("Unsupported element type for DotThunk::Execute: BF16 x BF16 = F32"),
and so does its reference test of all three cuts; under
``jax.disable_jit()`` the same code runs op by op, and the packed JAX runs
here use that.
"""
import jax
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from torch_parity import assert_same_trees

# small shapes: intra-op threads would only contend with the other test
# workers' processes
torch.set_num_threads(1)

KNOBS = {"tpu_quantized_grad": 16, "tpu_gain_screening": True,
         "tpu_screening_warmup": 2, "tpu_screening_explore_period": 4,
         "tpu_adaptive_bins": True}
BASE = {"objective": "binary", "max_bin": 63, "num_leaves": 7,
        "min_data_in_leaf": 5, "verbose": -1, "metric": "None",
        "tpu_engine": "fused", "num_iterations": 4}
CUTS = {"quant16": {"tpu_quantized_grad": 16},
        "quant8": {"tpu_quantized_grad": 8},
        "adaptive": {"tpu_adaptive_bins": True},
        "screening": {"tpu_gain_screening": True,
                      "tpu_screening_warmup": 2,
                      "tpu_screening_explore_period": 4}}


def _mixed_data(seed=0, n=512, f=8):
    """tests/test_hist_plane.py's data with its columns reversed: the
    8-level features come first, so the packed layout (widest first)
    really permutes bins_T's rows."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    X[:, f // 2:] = np.floor(X[:, f // 2:] * 8.0) / 8.0   # 8 levels
    y = (X @ rng.randn(f).astype(np.float32) > 0).astype(np.float32)
    return np.ascontiguousarray(X[:, ::-1]), y


def _port(params, X, y, n=None):
    p = dict(BASE, device_type="cpu", **params)
    if n is not None:
        p["num_iterations"] = n
    return lt.train(p, lt.Dataset(X, label=y))


def _jax(params, X, y):
    ds = lj.Dataset(X, label=y, params={"max_bin": 63, "verbose": -1})
    bst = lj.train(dict(BASE, **params), ds)
    bst.num_trees()                       # settles the pipelined trees
    return bst


def _trees(bst):
    return bst.model_to_string().split("\nparameters:")[0]


def _accuracy(bst, X, y):
    return float(np.mean((bst.predict(X) > 0.5) == y))


# ---------------------------------------------------------- train(), parity
@pytest.fixture(scope="module")
def mixed():
    return _mixed_data()


@pytest.fixture(scope="module")
def port_runs(mixed):
    X, y = mixed
    return {name: _port(p, X, y) for name, p in
            [("base", {}), ("knobs", KNOBS)] + list(CUTS.items())}


def test_adaptive_bins_byte_identical_to_padded(port_runs):
    """The packed layout is a re-indexing: the trees are the padded run's,
    byte for byte, alone and under quant16 + screening."""
    assert _trees(port_runs["adaptive"]) == _trees(port_runs["base"])
    g = port_runs["adaptive"]._gbdt
    assert list(g.fused_packed.feat_order) == [4, 5, 6, 7, 0, 1, 2, 3]
    assert g.fused_packed.fb < g.fused_f_oh * g.fused_Bp
    X, y = _mixed_data()
    mixed_no_pack = dict(KNOBS, tpu_adaptive_bins=False)
    assert _trees(port_runs["knobs"]) == _trees(_port(mixed_no_pack, X, y))


def test_adaptive_bins_train_matches_jax(mixed, port_runs):
    X, y = mixed
    with jax.disable_jit():
        bj = _jax({"tpu_adaptive_bins": True}, X, y)
    bt = port_runs["adaptive"]
    assert bj._gbdt.use_adaptive_bins and bt._gbdt.use_adaptive_bins
    assert_same_trees(bt.models, bj.models, X)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)


def test_quant16_train_matches_jax(mixed, port_runs):
    X, y = mixed
    bj = _jax(CUTS["quant16"], X, y)
    bt = port_runs["quant16"]
    assert bj._gbdt.quant_bits == bt._gbdt.quant_bits == 16
    assert bt._gbdt.fused_nch == 5
    assert_same_trees(bt.models[:1], bj.models[:1], X)
    assert bt.num_trees() == bj.num_trees() == BASE["num_iterations"]
    assert abs(_accuracy(bt, X, y) - _accuracy(bj, X, y)) <= 0.04


def test_screening_train_matches_jax(mixed, port_runs):
    """Gain screening alone keeps the f32 path: every tree equal to the JAX
    fused engine's (warm-up 2, exploration every 4th round, so rounds 2
    and 3 grow under the EMA mask)."""
    X, y = mixed
    bj = _jax(CUTS["screening"], X, y)
    bt = port_runs["screening"]
    assert bj._gbdt.use_screening and bt._gbdt.use_screening
    assert_same_trees(bt.models, bj.models, X)
    np.testing.assert_allclose(bt._gbdt._gain_ema.numpy(),
                               np.asarray(bj._gbdt._gain_ema_dev),
                               rtol=1e-5)


@pytest.mark.parametrize("cut", ["quant16", "quant8", "knobs"])
def test_quantized_rerun_byte_identical(mixed, port_runs, cut):
    X, y = mixed
    params = KNOBS if cut == "knobs" else CUTS[cut]
    again = _port(params, X, y)
    assert _trees(again) == _trees(port_runs[cut])
    # quantization changes the model, not its quality much
    assert _trees(port_runs[cut]) != _trees(port_runs["base"])
    assert _accuracy(again, X, y) >= _accuracy(port_runs["base"], X, y) \
        - 0.05


def test_all_cuts_accuracy_near_f32(mixed, port_runs):
    X, y = mixed
    bt = port_runs["knobs"]
    g = bt._gbdt
    assert g.quant_bits == 16 and g.use_adaptive_bins and g.use_screening
    assert bt.num_trees() == BASE["num_iterations"]
    assert abs(_accuracy(bt, X, y) - _accuracy(port_runs["base"], X, y)) \
        <= 0.05


# ------------------------------------------------------------- screening
def test_screening_reentry():
    """A decisive feature adversarially screened out (its EMA pinned to
    the bottom) re-enters through an exploration round and wins splits
    again (tests/test_hist_plane.py::test_screening_reentry)."""
    rng = np.random.RandomState(8)
    n, f = 512, 6
    X = rng.rand(n, f).astype(np.float32)
    y = (X[:, 0] > 0.5).astype(np.float32)      # feature 0 is everything
    params = dict(BASE, tpu_gain_screening=True, tpu_screening_warmup=0,
                  tpu_screening_keep_ratio=0.34,
                  tpu_screening_explore_period=3, num_iterations=6,
                  device_type="cpu")
    bst = lt.Booster(params=params, train_set=lt.Dataset(X, label=y))
    g = bst._gbdt
    assert g.use_screening and not g._use_epilogue()
    ema = np.zeros(g.fused_f_oh, np.float32)
    ema[1:f] = 100.0
    g._gain_ema = torch.as_tensor(ema)
    masks = []
    for it in range(6):
        explore = g._screening_explore(it)
        masks.append(explore)
        bst.update()
    assert masks == [True, False, False, True, False, False]
    used = set()
    for ht in g.models:
        used.update(int(v) for v in np.asarray(ht.split_feature))
    assert 0 in used, "screened-out decisive feature never re-entered"
    assert float(g._gain_ema[0]) > 0.0


# ------------------------------------------------------------- gating
def test_cuts_dropped_off_the_fused_engine(mixed):
    """tpu_engine=frontier: the cuts are dropped and training is the
    frontier engine's without them (the JAX package's
    test_knobs_degrade_off_fused)."""
    X, y = mixed
    p = {"tpu_engine": "frontier"}
    with_knobs = _port(dict(p, **KNOBS), X, y, n=2)
    g = with_knobs._gbdt
    assert g.use_frontier
    assert g.quant_bits == 0 and not g.use_screening \
        and not g.use_adaptive_bins
    assert with_knobs.num_trees() == 2
    assert _trees(with_knobs) == _trees(_port(p, X, y, n=2))


def test_bad_quantized_grad_is_fatal(mixed):
    X, y = mixed
    with pytest.raises(lt.LightGBMError, match="0, 8 or 16"):
        _port({"tpu_quantized_grad": 4}, X, y, n=1)


@pytest.mark.parametrize("cut", list(CUTS))
def test_epilogue_refused_under_each_cut(mixed, cut):
    """A bare update() loop takes the megastep body under any cut (the
    epilogue kernel is f32 and padded)."""
    X, y = mixed
    bst = lt.Booster(params=dict(BASE, device_type="cpu", **CUTS[cut]),
                     train_set=lt.Dataset(X, label=y))
    assert not bst._gbdt._use_epilogue()
    bst.update()
    assert bst._gbdt._epi_carry is None and bst.num_trees() == 1


def test_epilogue_taken_without_cuts(mixed):
    X, y = mixed
    bst = lt.Booster(params=dict(BASE, device_type="cpu"),
                     train_set=lt.Dataset(X, label=y))
    assert bst._gbdt._use_epilogue()


# ------------------------------------------------------------- rollback
def test_rollback_under_packing(mixed):
    """rollback_one_iter routes the logical bins, not the permuted bins_T:
    after a rollback the scores are the shorter run's."""
    X, y = mixed
    p = dict(BASE, device_type="cpu", tpu_adaptive_bins=True,
             tpu_quantized_grad=16, num_leaves=15)
    bst = lt.Booster(params=p, train_set=lt.Dataset(X, label=y))
    g = bst._gbdt
    for _ in range(2):
        bst.update()
    two = bst.train_scores().clone()
    bst.update()
    bst.rollback_one_iter()
    assert bst.num_trees() == 2
    np.testing.assert_allclose(bst.train_scores().numpy(), two.numpy(),
                               rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- model text
def test_model_text_read_by_jax(mixed, port_runs):
    X, _ = mixed
    bt = port_runs["knobs"]
    bj = lj.Booster(model_str=bt.model_to_string())
    np.testing.assert_allclose(bj.predict(X, raw_score=True),
                               bt.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)
