"""lightgbm_tpu_torch's histogram-plane kernel variants vs the JAX package.

The quantized (8 and 16 bits), packed (adaptive bins) and masked (gain
screening) variants of ``level_pass``, and the packed ``route_pass``: the
port's plain versions (what its wrappers run on CPU tensors) against
``lightgbm_tpu.ops.fused_level`` in Pallas interpret mode, on
tests/test_hist_plane.py's mixed-cardinality layout (num_bin
``[63]*4 + [9]*4``). ``new_leaf`` and every int32 histogram are exactly
equal; f32 planes agree to rtol 1e-5, atol 1e-5 (the same f32 values summed
in another order) with the count plane exact. The layout helpers,
``pack_gh_quant`` and the route-table re-index are bit-equal; the quantized
decode agrees to rtol 1e-6 (XLA may fold the ``max|g| / 127`` scale into a
product with its reciprocal, an ulp from the port's division).
tests/test_torch_cuda.py holds the CUDA kernels against these plain
versions on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import fused_level as jfl
from lightgbm_tpu.ops import layout as jlayout
from lightgbm_tpu_torch.ops import fused_level as tfl
from lightgbm_tpu_torch.ops import layout as tlayout
from lightgbm_tpu_torch.ops.quantize import QNCH

# small shapes: intra-op threads would only contend with the other test
# workers' processes
torch.set_num_threads(1)

NUM_BIN = np.array([63] * 4 + [9] * 4, np.int32)
R = 2048
SP = 8


@pytest.mark.parametrize("num_bin,max_bin", [
    (NUM_BIN, 63),
    (np.array([63, 9, 9, 2, 63, 17, 9, 9, 9, 9, 9, 0], np.int32), 63),
    (np.array([200, 3, 255, 40, 7], np.int32), 255),
    (np.array([5], np.int32), 15)])
def test_packed_layout_matches_jax(num_bin, max_bin):
    F_oh, _ = tlayout.feature_layout(len(num_bin), max_bin)
    want = jlayout.packed_feature_layout(num_bin, max_bin, f_oh=F_oh)
    got = tlayout.packed_feature_layout(num_bin, max_bin, f_oh=F_oh)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    for name in ("flat_offsets", "padded_to_packed", "padded_valid",
                 "packed_to_padded", "packed_valid", "feat_of_packed"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), name)


def _grad_hess(seed=5):
    rng = np.random.RandomState(seed)
    g = np.zeros(R, np.float32)
    h = np.zeros(R, np.float32)
    w = (rng.rand(R) < 0.9).astype(np.float32)     # some out of the bag
    g[:] = rng.randn(R) * w
    h[:] = (np.abs(rng.randn(R)) + 0.1) * w
    return g, h, w


@pytest.mark.parametrize("bits", [8, 16])
def test_pack_gh_quant_bitwise(bits):
    g, h, w = _grad_hess()
    want, ws = jfl.pack_gh_quant(jnp.asarray(g), jnp.asarray(h),
                                 jnp.asarray(w), bits, np.uint32(77))
    t = torch.as_tensor
    got, gs = tfl.pack_gh_quant(t(g), t(h), t(w), bits, seed=77)
    assert got.dtype == torch.int8 and tuple(got.shape) == (8, R)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def _operands(quant_bits, packed, seed=6):
    """Both packages' level operands on the mixed layout: rows in leaves
    0..2, three active slots (a wide feature, a narrow one with zero-missing
    routing, a narrow one with NaN-missing routing), five inactive."""
    rng = np.random.RandomState(seed)
    F = len(NUM_BIN)
    F_oh, Bp = jfl.feature_layout(F, 63)
    pk = (tlayout.packed_feature_layout(NUM_BIN, 63, f_oh=F_oh)
          if packed else None)
    pk_j = (jlayout.packed_feature_layout(NUM_BIN, 63, f_oh=F_oh)
            if packed else None)
    bins = np.stack([rng.randint(0, nb, R) for nb in NUM_BIN])
    order = np.asarray(pk.feat_order) if packed else np.arange(F)
    bins_T = np.zeros((max(F_oh, 8), R), np.int8)
    bins_T[:len(order)] = bins[order]
    leaf = rng.randint(0, 3, R).astype(np.int32)[None, :]
    mt = np.array([0, 0, 0, 0, 1, 2, 0, 0], np.int32)
    db = np.array([0, 0, 0, 0, 3, 0, 0, 0], np.int32)
    feat = np.array([2, 4, 5] + [-1] * 5, np.int32)
    thr = np.array([30, 4, 6] + [0] * 5, np.int32)
    dl = np.array([True, True, False] + [False] * 5)
    tbl = np.zeros((SP, 128), np.int32)
    tbl[:, 0] = [0, 1, 2] + [-2] * 5
    tbl[:3, 1] = 3
    tbl[:3, 2] = [1, 0, 1]
    g, h, w = _grad_hess(seed)
    j = jnp.asarray
    W_j = jfl.build_route_table(j(feat), j(thr), j(dl), j(NUM_BIN), j(mt),
                                j(db), SP, F_oh, Bp)
    t = torch.as_tensor
    W_t = tfl.build_route_table(t(feat), t(thr), t(dl), t(NUM_BIN), t(mt),
                                t(db), SP, F_oh, Bp)
    if packed:
        W_j = jfl.pack_route_table(W_j, pk_j)
        W_t = tfl.pack_route_table(W_t, pk)
        np.testing.assert_array_equal(np.asarray(W_j, np.float32),
                                      W_t.float().numpy())
    scales = None
    if quant_bits:
        gh_j, scales = jfl.pack_gh_quant(j(g), j(h), j(w), quant_bits,
                                         np.uint32(seed))
        gh_t, _ = tfl.pack_gh_quant(t(g), t(h), t(w), quant_bits,
                                    seed=seed)
        nch = QNCH[quant_bits]
    else:
        gh_j = jfl.pack_gh(j(g), j(h), j(w), 5)
        gh_t = tfl.pack_gh(t(g), t(h), t(w), 5)
        nch = 5
    jx = (j(bins_T), j(leaf), gh_j, W_j, j(tbl))
    tx = (t(bins_T), t(leaf), gh_t, W_t, t(tbl))
    return jx, tx, (pk_j, pk, F_oh, Bp, nch, scales)


# features 1, 4 and 6 screened out (feature 0, the leaf-totals column,
# never is: the grower keeps it live). Slot 1 splits on feature 4: with its
# slab zeroed, the routing sum is 0 and its rows all go right
FMASK = np.array([True, False, True, True, False, True, False, True])


@pytest.mark.parametrize("quant_bits,packed,masked", [
    (8, False, False), (16, False, False), (0, True, False),
    (16, True, False), (0, False, True), (8, True, True)],
    ids=["quant8", "quant16", "packed-f32", "packed-quant16", "fmask-f32",
         "packed-quant8-fmask"])
def test_level_pass_variant_matches_jax(quant_bits, packed, masked):
    jx, tx, (pk_j, pk, F_oh, Bp, nch, scales) = _operands(quant_bits,
                                                          packed)
    fm_j = fm_t = None
    if masked:
        fb = jfl.expand_feature_mask(jnp.asarray(FMASK), F_oh, Bp, pk_j)
        fm_j = jnp.broadcast_to(fb[:, None], (fb.shape[0], 128))
        fm_t = torch.as_tensor(FMASK)
        np.testing.assert_array_equal(
            tfl.expand_feature_mask(fm_t, F_oh, Bp, pk).numpy(),
            np.asarray(fb))
    hist_j, leaf_j = jfl.level_pass(*jx, fm_j, num_slots=SP, num_bins=Bp,
                                    f_oh=F_oh, nch=nch, interpret=True,
                                    quant_bits=quant_bits, packed=pk_j)
    before = dict(tfl.launches)
    hist_t, leaf_t = tfl.level_pass(*tx, fm_t, num_bins=Bp, f_oh=F_oh,
                                    nch=nch, quant_bits=quant_bits,
                                    packed=pk)
    assert tfl.launches == before          # CPU tensors: plain version
    np.testing.assert_array_equal(leaf_t.numpy(), np.asarray(leaf_j))
    hist_j = np.asarray(hist_j)
    assert tuple(hist_t.shape) == hist_j.shape
    if quant_bits:
        assert hist_t.dtype == torch.int32
        np.testing.assert_array_equal(hist_t.numpy(), hist_j)
        assert hist_t.abs().sum() > 0
    else:
        np.testing.assert_allclose(hist_t.numpy(), hist_j, rtol=1e-5,
                                   atol=1e-5)
        w = slice((nch - 1) * SP, nch * SP)
        np.testing.assert_array_equal(hist_t[:, w].numpy(), hist_j[:, w])
    if masked:
        keep = tfl.expand_feature_mask(torch.as_tensor(FMASK), F_oh, Bp, pk)
        assert not hist_t[~keep].any()
        moved = leaf_t[0] != tx[1][0]
        assert moved[tx[1][0] == 1].all()    # slot 1's rows all went right


def test_route_pass_packed_matches_jax():
    jx, tx, (pk_j, pk, F_oh, Bp, _, _) = _operands(0, True, seed=8)
    bins_j, leaf_j, _, W_j, tbl_j = jx
    bins_t, leaf_t, _, W_t, tbl_t = tx
    want = jfl.route_pass(bins_j, leaf_j, W_j, tbl_j, num_slots=SP,
                          num_bins=Bp, f_oh=F_oh, interpret=True,
                          packed=pk_j)
    got = tfl.route_pass(bins_t, leaf_t, W_t, tbl_t, num_bins=Bp, f_oh=F_oh,
                         packed=pk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got != leaf_t).any()


@pytest.mark.parametrize("quant_bits", [0, 16])
def test_hist_planes_decode_matches_jax(quant_bits):
    """The port's decode (packed re-index, int32 rescale) of the JAX
    kernel's own histogram against the JAX decode."""
    jx, _, (pk_j, pk, F_oh, Bp, nch, scales) = _operands(quant_bits, True,
                                                         seed=9)
    hist_j, _ = jfl.level_pass(*jx, num_slots=SP, num_bins=Bp, f_oh=F_oh,
                               nch=nch, interpret=True,
                               quant_bits=quant_bits, packed=pk_j)
    want = jfl.hist_planes(hist_j, nch, SP, F_oh, Bp, packed=pk_j,
                           quant_bits=quant_bits, scales=scales)
    hist_t = torch.as_tensor(np.array(hist_j))
    np.testing.assert_array_equal(
        tfl.unpack_packed_flat(hist_t, pk).numpy(),
        np.asarray(jfl.unpack_packed_flat(hist_j, pk_j)))
    got = tfl.hist_planes(hist_t, nch, SP, F_oh, Bp, packed=pk,
                          quant_bits=quant_bits,
                          scales=torch.as_tensor(np.array(scales))
                          if quant_bits else None)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_wrappers_reject_what_the_kernels_do_not_take():
    _, (bins, leaf, gh, W, tbl), (_, pk, F_oh, Bp, _, _) = _operands(
        0, True)
    kw = dict(num_bins=Bp, f_oh=F_oh, packed=pk)
    q8 = gh.to(torch.int8)
    with pytest.raises(ValueError):          # int8 channels, quant_bits 0
        tfl.level_pass(bins, leaf, q8, W, tbl, nch=5, **kw)
    with pytest.raises(ValueError):          # bf16 channels, quant_bits 16
        tfl.level_pass(bins, leaf, gh, W, tbl, nch=5, quant_bits=16, **kw)
    with pytest.raises(ValueError):          # quant8 carries 3 channels
        tfl.level_pass(bins, leaf, q8, W, tbl, nch=5, quant_bits=8, **kw)
    with pytest.raises(ValueError):
        tfl.level_pass(bins, leaf, q8, W, tbl, nch=3, quant_bits=4, **kw)
    with pytest.raises(ValueError):          # W on the padded layout
        tfl.level_pass(bins, leaf, gh, torch.zeros(SP, F_oh * Bp,
                                                   dtype=torch.bfloat16),
                       tbl, **kw)
    bad = dataclasses.replace(pk, widths=pk.widths[:-1])
    with pytest.raises(ValueError):          # a slab table one row short
        tfl.route_pass(bins, leaf, W, tbl, num_bins=Bp, f_oh=F_oh,
                       packed=bad)
    with pytest.raises(ValueError):          # fmask is [f_oh] bool
        tfl.level_pass(bins, leaf, gh, W, tbl, torch.ones(F_oh + 1,
                                                          dtype=torch.bool),
                       **kw)
