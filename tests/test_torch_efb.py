"""Exclusive feature bundling modules of lightgbm_tpu_torch against the JAX
package, piece by piece.

- ``ops/efb.py`` (a numpy copy): the bundles, the ``BundleLayout`` fields,
  the encoded matrix and ``logical_histograms`` exactly equal to
  ``lightgbm_tpu.ops.efb`` on tests/test_efb.py-shaped fixtures, the
  tolerated-conflict case included.
- ``build_route_table_bundled`` exactly equal to the JAX function, with a
  categorical member and a missing-value member; ``bundle_plane_views``
  (and ``models/learner.bundle_views``) exactly equal on integer-valued
  planes, whose f32 sums are exact in any order, and within rtol 1e-5,
  atol 1e-5 on random planes (the FixHistogram residual is an f32 sum
  over the bins, which XLA and PyTorch reduce in different orders: last
  bits differ).
- ``level_pass`` and ``route_pass`` on bundle columns and a bundled route
  table (the plain versions the port runs on the CPU) against the JAX
  ``level_pass``/``route_pass`` in Pallas interpret mode: new leaves
  equal, f32 planes within rtol 1e-5, atol 1e-5 (the same f32 values
  summed in another order), the count plane exact, quantized planes
  exact.
Small shapes; the interpret-mode kernels compile in seconds.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.models import learner as jlearner
from lightgbm_tpu.ops import efb as jefb
from lightgbm_tpu.ops import fused_level as jfl
from lightgbm_tpu_torch.models import learner as tlearner
from lightgbm_tpu_torch.ops import efb as tefb
from lightgbm_tpu_torch.ops import fused_level as tfl

# small shapes: intra-op threads would only contend with the other test
# workers' processes
torch.set_num_threads(1)


def _exclusive(R=4000, seed=0):
    """Three mutually exclusive sparse features and one dense one
    (tests/test_efb.py ``_sparse_data``)."""
    rng = np.random.RandomState(seed)
    owner = rng.randint(0, 4, R)
    bins = np.zeros((R, 4), np.int64)
    for f in range(3):
        m = owner == f
        bins[m, f] = rng.randint(1, 8, int(m.sum()))
    bins[:, 3] = rng.randint(0, 16, R)
    return bins, [8, 8, 8, 16], [0, 0, 0, 0]


def _tolerated(R=50000):
    """tests/test_efb.py's tolerated-conflict case: f1 overlaps f0 on 3
    rows (under the 1e-4 budget), ``tiny`` conflicts on all its 40."""
    rng = np.random.RandomState(1)
    f0 = rng.rand(R) < 0.1
    f1 = np.zeros(R, bool)
    f1[np.where(~f0)[0][:2000]] = True
    f1[np.where(f0)[0][:3]] = True
    tiny = np.zeros(R, bool)
    tiny[np.where(f0)[0][:40]] = True
    return [f0, f1, tiny]


def _many(R=3000, seed=5):
    """Forty sparse features in four exclusive families plus two dense."""
    rng = np.random.RandomState(seed)
    bins = np.zeros((R, 42), np.int64)
    nb = [4] * 40 + [32, 32]
    for fam in range(4):
        owner = rng.randint(-1, 10, R)
        for i in range(10):
            m = owner == i
            bins[m, fam * 10 + i] = rng.randint(1, 4, int(m.sum()))
    bins[:, 40] = rng.randint(0, 32, R)
    bins[:, 41] = rng.randint(0, 32, R)
    return bins, nb, [0] * 42


FIXTURES = {"exclusive": _exclusive, "many": _many}


@pytest.mark.parametrize("name,kw", [
    ("exclusive", {}), ("many", {}),
    ("many", dict(max_bundle_bins=16)),
    ("tolerated", dict(max_conflict_rate=1e-4)),
    ("tolerated", dict(max_conflict_rate=0.0)),
    ("tolerated", dict(max_conflict_rate=1.0)),
])
def test_find_bundles_and_layout_equal_jax(name, kw):
    if name == "tolerated":
        masks = _tolerated()
        nb = [2, 2, 2]
    else:
        bins, nb, db = FIXTURES[name]()
        masks = [bins[:, f] != db[f] for f in range(bins.shape[1])]
    R = len(masks[0])
    got = tefb.find_bundles(masks, R, num_bin_per_feat=nb, **kw)
    want = jefb.find_bundles(masks, R, num_bin_per_feat=nb, **kw)
    assert got == want
    lt, lj = tefb.BundleLayout(got, nb), jefb.BundleLayout(want, nb)
    np.testing.assert_array_equal(lt.col_of_feat, lj.col_of_feat)
    np.testing.assert_array_equal(lt.offset_of_feat, lj.offset_of_feat)
    assert lt.col_num_bin == lj.col_num_bin
    assert lt.num_columns == lj.num_columns


@pytest.mark.parametrize("name", ["exclusive", "many"])
def test_encode_and_logical_histograms_equal_jax(name):
    bins, nb, db = FIXTURES[name]()
    masks = [bins[:, f] != db[f] for f in range(bins.shape[1])]
    bundles = jefb.find_bundles(masks, len(bins), num_bin_per_feat=nb)
    lt, lj = tefb.BundleLayout(bundles, nb), jefb.BundleLayout(bundles, nb)
    enc_t = tefb.encode_bundles(bins, db, lt)
    enc_j = jefb.encode_bundles(bins, db, lj)
    assert enc_t.dtype == enc_j.dtype
    np.testing.assert_array_equal(enc_t, enc_j)
    rng = np.random.RandomState(2)
    Bc = max(lt.col_num_bin)
    bh = rng.randn(2, lt.num_columns, Bc, 3)
    totals = rng.randn(2, 3)
    np.testing.assert_array_equal(
        tefb.logical_histograms(bh, totals, lt, nb, db, max(nb)),
        jefb.logical_histograms(bh, totals, lj, nb, db, max(nb)))


def _bundled_meta(seed=3):
    """A layout of 3 bundle columns: column 0 a dense numerical feature
    with NaN missing; column 1 three exclusive members (one zero-missing,
    one categorical); column 2 two members. Returns the per-feature
    arrays, the layout and Bc_p."""
    nb = np.array([20, 6, 9, 5, 7, 4], np.int32)
    mt = np.array([2, 1, 0, 0, 0, 2], np.int32)       # NaN, zero, none
    db = np.array([0, 3, 0, 0, 0, 0], np.int32)
    mfb = np.array([4, 3, 0, 0, 1, 0], np.int32)
    layout = tefb.BundleLayout([[0], [1, 2, 3], [4, 5]], nb)
    Bc_p = 32
    return nb, mt, db, mfb, layout, Bc_p


def _slots(Sp, seed):
    rng = np.random.RandomState(seed)
    feat = np.array([0, 1, 2, 3, 4, 5, -1, 1][:Sp], np.int32)
    thr = rng.randint(0, 4, Sp).astype(np.int32)
    dl = rng.rand(Sp) < 0.5
    cat_flag = np.array([False, False, True, False, False, False, False,
                         True][:Sp])
    cat_mask = rng.rand(Sp, 32) < 0.4
    cat_mask[:, 0] = False
    return feat, thr, dl, cat_flag, cat_mask


@pytest.mark.parametrize("categorical", [False, True])
def test_route_table_bundled_equals_jax(categorical):
    nb, mt, db, mfb, layout, Bc_p = _bundled_meta()
    feat, thr, dl, cf, cm = _slots(8, 1)
    C = layout.num_columns
    cat = dict(cat_flag=cf, cat_mask=cm) if categorical else {}
    args = (feat, thr, dl, nb, mt, db, mfb, layout.col_of_feat,
            layout.offset_of_feat)
    W_j = jfl.build_route_table_bundled(
        *[jnp.asarray(a) for a in args], C, Bc_p,
        **{k: jnp.asarray(v) for k, v in cat.items()})
    W_t = tfl.build_route_table_bundled(
        *[torch.as_tensor(np.asarray(a)) for a in args], C, Bc_p,
        **{k: torch.as_tensor(v) for k, v in cat.items()})
    np.testing.assert_array_equal(W_t.float().numpy(),
                                  np.asarray(W_j, np.float32))
    # one slab per active W row: the owning column's
    Wn = W_t.float().numpy().reshape(8, C, Bc_p)
    for k in range(8):
        cols = np.nonzero(Wn[k].any(1))[0]
        assert len(cols) <= 1
        if len(cols):
            assert cols[0] == layout.col_of_feat[feat[k]]


def _views_args(seed=4, integer=False):
    nb, mt, db, mfb, layout, Bc_p = _bundled_meta()
    F, B, C = len(nb), 32, layout.num_columns
    flat_idx = np.zeros((F, B), np.int32)
    valid = np.zeros((F, B), bool)
    for f in range(F):
        base = layout.col_of_feat[f] * Bc_p + layout.offset_of_feat[f]
        flat_idx[f, :nb[f]] = base + np.arange(nb[f])
        valid[f, :nb[f]] = True
    rng = np.random.RandomState(seed)
    plane = (rng.randint(-50, 50, (3, C, Bc_p, 3)) if integer
             else rng.randn(3, C, Bc_p, 3)).astype(np.float32)
    return plane, flat_idx, valid, mfb


def _assert_views_equal(got, want, integer):
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("squeeze", [False, True])
def test_bundle_plane_views_equal_jax(squeeze, integer):
    plane, flat_idx, valid, mfb = _views_args(integer=integer)
    if squeeze:
        plane = plane[..., 0]
    want = jfl.bundle_plane_views(jnp.asarray(plane), jnp.asarray(flat_idx),
                                  jnp.asarray(valid), jnp.asarray(mfb))
    got = tfl.bundle_plane_views(torch.as_tensor(plane),
                                 torch.as_tensor(flat_idx),
                                 torch.as_tensor(valid),
                                 torch.as_tensor(mfb))
    _assert_views_equal(got.numpy(), np.asarray(want), integer)


@pytest.mark.parametrize("integer", [True, False])
def test_bundle_views_equal_jax(integer):
    plane, flat_idx, valid, mfb = _views_args(seed=6, integer=integer)
    nb, mt, db, _, layout, _ = _bundled_meta()
    t, j = torch.as_tensor, jnp.asarray
    cfg_t = tlearner.BundleCfg(t(flat_idx), t(valid), t(mfb),
                               t(layout.col_of_feat),
                               t(layout.offset_of_feat))
    cfg_j = jlearner.BundleCfg(j(flat_idx), j(valid), j(mfb),
                               j(layout.col_of_feat),
                               j(layout.offset_of_feat))
    _assert_views_equal(tlearner.bundle_views(t(plane), cfg_t).numpy(),
                        np.asarray(jlearner.bundle_views(j(plane), cfg_j)),
                        integer)


def _bundled_operands(quant_bits, seed=7):
    """Level-pass operands over the 3 bundle columns of ``_bundled_meta``
    (rows encoded from logical bins, mutually exclusive members), a
    bundled route table with a categorical slot, both packages' tensors."""
    nb, mt, db, mfb, layout, Bc_p = _bundled_meta()
    rng = np.random.RandomState(seed)
    R, Rp = 1800, 2048
    F = len(nb)
    bins = np.zeros((R, F), np.int64)
    bins[:, 0] = rng.randint(0, nb[0], R)
    for members in layout.bundles[1:]:
        owner = rng.randint(-1, len(members), R)
        for i, f in enumerate(members):
            bins[:, f] = mfb[f]
            m = owner == i
            bins[m, f] = rng.randint(0, nb[f], int(m.sum()))
    enc = tefb.encode_bundles(bins, mfb, layout)
    C = layout.num_columns
    bins_T = np.zeros((8, Rp), np.int16)
    bins_T[:C, :R] = enc.T
    Sp = 8
    leaf = np.full((1, Rp), -1, np.int32)
    leaf[0, :R] = rng.randint(0, 6, R)
    feat, thr, dl, cf, cm = _slots(Sp, 2)
    tbl = np.zeros((Sp, 128), np.int32)
    tbl[:, 0] = np.where(feat >= 0, np.arange(Sp), -2)
    tbl[:, 1] = np.where(feat >= 0, Sp, 0)
    tbl[:, 2] = rng.randint(0, 2, Sp)
    w = (rng.rand(Rp) >= 0.3).astype(np.float32)
    w[R:] = 0
    g = rng.randn(Rp).astype(np.float32) * w
    h = rng.rand(Rp).astype(np.float32) * 0.25 * w
    args = (feat, thr, dl, nb, mt, db, mfb, layout.col_of_feat,
            layout.offset_of_feat)
    t, j = torch.as_tensor, jnp.asarray
    W_t = tfl.build_route_table_bundled(*[t(np.asarray(a)) for a in args],
                                        C, Bc_p, cat_flag=t(cf),
                                        cat_mask=t(cm))
    W_j = jfl.build_route_table_bundled(*[j(a) for a in args], C, Bc_p,
                                        cat_flag=j(cf), cat_mask=j(cm))
    if quant_bits:
        gh_t, _ = tfl.pack_gh_quant(t(g), t(h), t(w), quant_bits, seed=1)
        gh_j = j(gh_t.numpy())
    else:
        gh_t = tfl.pack_gh(t(g), t(h), t(w), 5)
        gh_j = jfl.pack_gh(j(g), j(h), j(w), 5)
    tx = (t(bins_T), t(leaf), gh_t, W_t, t(tbl))
    jx = (j(bins_T), j(leaf), gh_j, W_j, j(tbl))
    return tx, jx, C, Bc_p, Sp


@pytest.mark.parametrize("quant_bits", [0, 16])
def test_bundled_level_pass_matches_jax(quant_bits):
    from lightgbm_tpu_torch.ops.quantize import QNCH
    tx, jx, C, Bc_p, Sp = _bundled_operands(quant_bits)
    nch = QNCH[quant_bits] if quant_bits else 5
    kw = dict(num_bins=Bc_p, f_oh=C, nch=nch, quant_bits=quant_bits)
    hist_j, leaf_j = jfl.level_pass(*jx, num_slots=Sp, tile_rows=256,
                                    interpret=True, **kw)
    before = dict(tfl.launches)
    hist_t, leaf_t = tfl.level_pass(*tx, **kw)
    assert tfl.launches == before          # CPU tensors: plain version
    np.testing.assert_array_equal(leaf_t.numpy(), np.asarray(leaf_j))
    if quant_bits:
        np.testing.assert_array_equal(hist_t.numpy(), np.asarray(hist_j))
        return
    pj = jfl.hist_planes(hist_j, nch, Sp, C, Bc_p)
    pt = tfl.hist_planes(hist_t, nch, Sp, C, Bc_p)
    for a, b in zip(pj[:2], pt[:2]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(pt[2].numpy(), np.asarray(pj[2]))
    want = jfl.route_pass(jx[0], jx[1], jx[3], jx[4], num_slots=Sp,
                          num_bins=Bc_p, f_oh=C, tile_rows=256,
                          interpret=True)
    got = tfl.route_pass(tx[0], tx[1], tx[3], tx[4], num_bins=Bc_p, f_oh=C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
