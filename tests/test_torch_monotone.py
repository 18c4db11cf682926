"""Monotone constraints (basic mode) through the port against the JAX
package's fused engine.

``tests/test_monotone.py``'s 6,000-row adversarial fixture (y rises then
falls in x0), with a constant column in front (a dropped feature, so the
constraint on column 1 is indexed through the used features), 20 rounds
at num_leaves=31 with ``monotone_constraints=[0, 1, 0]``:
``lightgbm_tpu_torch.train`` (the megastep body) and a bare ``update()``
loop (the epilogue body) against ``lightgbm_tpu.train(...,
tpu_engine="fused")`` and its ``update()`` loop. The trees equal
(``torch_parity.assert_same_trees``), at least one child output was
clipped by a bound, both packages' predictions are monotone in x0 and the
unconstrained control is not. The bookkeeping helpers are held to the JAX
package's on random [L] and [L, F] states.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.models import learner as jl
from lightgbm_tpu_torch.models import frontier2
from lightgbm_tpu_torch.models import learner as tl
from torch_parity import assert_same_trees

torch.set_num_threads(1)

ROUNDS = 20
PARAMS = {"objective": "regression", "num_leaves": 31, "verbose": -1,
          "min_data_in_leaf": 10, "monotone_constraints": [0, 1, 0]}
JAX_ENGINE = {"tpu_engine": "fused", "tpu_fused_epilogue": False}


def adversarial(R=6000, seed=0):
    """tests/test_monotone.py's ``_adversarial`` rows behind a constant
    column: y = sin(3 x0) + 0.3 x1 + noise."""
    rng = np.random.RandomState(seed)
    x0 = rng.rand(R).astype(np.float32)
    x1 = rng.rand(R).astype(np.float32)
    y = (np.sin(3.0 * x0) + 0.3 * x1 + 0.05 * rng.randn(R)) \
        .astype(np.float32)
    return np.stack([np.ones(R, np.float32), x0, x1], 1), y


def worst_step(bst, n_grid=200):
    """The most negative step of predict along x0 over a grid, x1 fixed
    (tests/test_monotone.py's ``_check_monotone``)."""
    grid = np.linspace(0.01, 0.99, n_grid).astype(np.float32)
    worst = 0.0
    for other in (0.1, 0.5, 0.9):
        X = np.stack([np.ones(n_grid, np.float32), grid,
                      np.full(n_grid, other, np.float32)], 1)
        worst = min(worst, float(np.min(np.diff(bst.predict(X)))))
    return worst


def count_clipped(monkeypatch):
    """Wrap the grower's split search; the returned dict counts winners
    whose output equals a finite bound of its slot (a clipped output)."""
    seen = {"clipped": 0}
    orig = frontier2.best_split_cm

    def wrapper(*args, **kw):
        out = orig(*args, **kw)
        lo, hi = kw.get("bound_lo"), kw.get("bound_hi")
        if lo is not None:
            ok = out.feature >= 0
            for o in (out.left_output, out.right_output):
                hit = ((o == lo) & torch.isfinite(lo)) \
                    | ((o == hi) & torch.isfinite(hi))
                seen["clipped"] += int((hit & ok).sum())
        return out
    monkeypatch.setattr(frontier2, "best_split_cm", wrapper)
    return seen


def _update(pkg, params, X, y, n=ROUNDS):
    bst = pkg.Booster(params, pkg.Dataset(X, label=y))
    for _ in range(n):
        bst.update()
    return bst


@pytest.mark.parametrize("body", ["megastep", "epilogue"])
def test_basic_matches_jax(body, monkeypatch):
    X, y = adversarial()
    clipped = count_clipped(monkeypatch)
    if body == "megastep":
        bt = lt.train(dict(PARAMS, device_type="cpu"), lt.Dataset(X, label=y),
                      ROUNDS)
        bj = lj.train(dict(PARAMS, **JAX_ENGINE), lj.Dataset(X, label=y),
                      ROUNDS)
    else:
        bt = _update(lt, dict(PARAMS, device_type="cpu"), X, y)
        bj = _update(lj, dict(PARAMS, tpu_engine="fused"), X, y)
        assert bt._gbdt._use_epilogue() and bj._gbdt._use_epilogue()
    assert bt._gbdt.use_mono_bounds and bt._gbdt.mono_mode == "basic"
    assert bt._gbdt.fused_meta.monotone.tolist()[:2] == [1, 0]
    assert bj.num_trees() == bt.num_trees() == ROUNDS
    assert clipped["clipped"] > 0
    assert_same_trees(bt.models, bj.models, X)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-5,
                               atol=1e-6)
    assert worst_step(bt) >= -1e-6
    assert worst_step(bj) >= -1e-6
    assert "monotone_constraints=0 1 0" in bt.model_to_string()


def test_unconstrained_control_violates():
    X, y = adversarial()
    p = {k: v for k, v in PARAMS.items() if k != "monotone_constraints"}
    bt = lt.train(dict(p, device_type="cpu"), lt.Dataset(X, label=y), ROUNDS)
    assert not bt._gbdt.use_mono_bounds
    assert worst_step(bt) < -1e-3


def test_frontier_degrades_to_fused():
    X, y = adversarial(R=2000)
    bt = lt.train(dict(PARAMS, device_type="cpu", tpu_engine="frontier"),
                  lt.Dataset(X, label=y), 2)
    assert not bt._gbdt.use_frontier and bt._gbdt.use_mono_bounds


def test_length_checked():
    X, y = adversarial(R=500)
    with pytest.raises(lt.LightGBMError, match="length mismatch"):
        lt.Dataset(X, label=y, params={"monotone_constraints": [1, 0],
                                       "device_type": "cpu"}).construct()


# ------------------------------------------- the bookkeeping helpers
def _state(seed, L=16, F=4, n_leaves=9, n_sel=4):
    rng = np.random.RandomState(seed)
    lv = rng.randn(L).astype(np.float32)
    lo = np.where(rng.rand(L) < 0.5, -np.inf, lv - rng.rand(L)) \
        .astype(np.float32)
    hi = np.where(rng.rand(L) < 0.5, np.inf, lv + rng.rand(L)) \
        .astype(np.float32)
    rlo = rng.randint(0, 4, (L, F)).astype(np.int32)
    rhi = (rlo + rng.randint(1, 5, (L, F))).astype(np.int32)
    sel = np.zeros(L, bool)
    sel[rng.choice(n_leaves, n_sel, replace=False)] = True
    k_of = (np.cumsum(sel) - sel).astype(np.int32)
    feat = rng.randint(0, F, L).astype(np.int32)
    thr = rng.randint(0, 6, L).astype(np.int32)
    cat = rng.rand(L) < 0.2
    lout = rng.randn(L).astype(np.float32)
    rout = rng.randn(L).astype(np.float32)
    mono = np.array([1, -1, 0, 1][:F], np.int32)
    return lv, lo, hi, rlo, rhi, sel, k_of, feat, thr, cat, lout, rout, mono


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mono_child_bounds_matches_jax(seed):
    lv, lo, hi, _, _, sel, k_of, feat, _, _, lout, rout, mono = _state(seed)
    L = len(lv)
    mono_dir = mono[feat]
    new_idx = np.where(sel, 9 + k_of, -1).astype(np.int32)
    slots = np.arange(L, dtype=np.int32)
    want = jl.mono_child_bounds(lo, hi, lo, hi, sel, mono_dir, lout, rout,
                                slots, new_idx)
    t = torch.as_tensor
    got = tl.mono_child_bounds(t(lo), t(hi), t(sel), t(mono_dir), t(lout),
                               t(rout), t(slots), t(new_idx))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_region_adjacency_matches_jax(seed):
    _, _, _, rlo, rhi, sel, _, _, _, _, _, _, mono = _state(seed)
    rng = np.random.RandomState(seed + 10)
    c_lo = rng.randint(0, 4, (2, rlo.shape[1])).astype(np.int32)
    c_hi = (c_lo + rng.randint(1, 5, c_lo.shape)).astype(np.int32)
    mask = rng.rand(rlo.shape[0]) < 0.7
    want = jl.region_adjacency(rlo, rhi, c_lo, c_hi, mask, mono)
    t = torch.as_tensor
    got = tl.region_adjacency(t(rlo), t(rhi), t(c_lo), t(c_hi), t(mask),
                              t(mono))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mono_inter_level_update_matches_jax(seed):
    (lv, lo, hi, rlo, rhi, sel, k_of, feat, thr, cat, lout, rout,
     mono) = _state(seed)
    n_sel = int(sel.sum())
    want = jl.mono_inter_level_update(
        *[jnp.asarray(a) for a in (lv, lo, hi, rlo, rhi, sel, k_of, feat,
                                   thr, cat, lout, rout, mono)], 9, 8)
    t = torch.as_tensor
    got = tl.mono_inter_level_update(t(lv), t(lo), t(hi), t(rlo), t(rhi),
                                     t(sel), t(k_of), t(feat), t(thr),
                                     t(cat), t(lout), t(rout), t(mono), 9,
                                     n_sel)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
