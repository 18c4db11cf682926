"""lightgbm_tpu_torch fused-level kernels vs the JAX package's Pallas kernels.

The port's plain PyTorch versions (what the wrappers run on CPU tensors)
against ``lightgbm_tpu.ops.fused_level`` in interpret mode, on the cases of
tests/test_fused_level.py: a root pass, a mid level with zero- and
NaN-missing routing, nch 5 and 3, int8 and int16 bins. ``new_leaf`` and the
lookup must be exactly equal; the decoded histogram planes agree to
rtol=1e-5, atol=1e-5 (the two sum the same f32 values in another order) and
the count plane exactly. tests/test_torch_cuda.py holds the CUDA kernels
against these plain versions on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import fused_level as jfl
from lightgbm_tpu_torch.ops import fused_level as tfl

# small shapes: intra-op threads would only contend with the other test
# workers' processes
torch.set_num_threads(1)


def _setup(R, F, B, seed):
    rng = np.random.RandomState(seed)
    nb = np.array([B, B - 3, B, 7, B, B - 1], np.int32)[:F]
    mt = np.array([0, 1, 2, 0, 2, 1], np.int32)[:F]
    db = np.array([0, 4, 0, 0, 0, 2], np.int32)[:F]
    bins = np.stack([rng.randint(0, nb[f], size=R) for f in range(F)], 1)
    grad = rng.randn(R).astype(np.float32)
    hess = (np.abs(rng.randn(R)) + 0.1).astype(np.float32)
    return bins, grad, hess, (nb, mt, db)


def _operands(R, F, B, seed, leaf, slots, nch):
    """Same operands for both packages: (jax tuple, torch tuple, F_oh)."""
    bins, grad, hess, (nb, mt, db) = _setup(R, F, B, seed)
    F_oh, Bp = jfl.feature_layout(F, B)
    assert Bp == B
    Rp = ((R + 255) // 256) * 256
    np_dt = np.int8 if B <= 128 else np.int16
    bins_T = np.zeros((max(F_oh, 8), Rp), np_dt)
    bins_T[:F, :R] = bins.T
    leaf_T = np.full((1, Rp), -1, np.int32)
    leaf_T[0, :R] = leaf
    g = np.zeros(Rp, np.float32)
    h = np.zeros(Rp, np.float32)
    w = np.zeros(Rp, np.float32)
    g[:R], h[:R], w[:R] = grad, hess, 1.0
    Sp = len(slots)
    feat = np.array([s[1] if s[0] >= 0 else -1 for s in slots], np.int32)
    thr = np.array([s[2] for s in slots], np.int32)
    dl = np.array([bool(s[3]) for s in slots])
    tbl = np.zeros((Sp, 128), np.int32)
    for k, (lf, _, _, _, delta, small_left) in enumerate(slots):
        tbl[k, :3] = (lf if lf >= 0 else -2, delta, int(small_left))
    W_j = jfl.build_route_table(jnp.asarray(feat), jnp.asarray(thr),
                                jnp.asarray(dl), jnp.asarray(nb),
                                jnp.asarray(mt), jnp.asarray(db), Sp, F_oh, B)
    gh_j = jfl.pack_gh(jnp.asarray(g), jnp.asarray(h), jnp.asarray(w), nch)
    t = torch.as_tensor
    W_t = tfl.build_route_table(t(feat), t(thr), t(dl), t(nb), t(mt), t(db),
                                Sp, F_oh, B)
    gh_t = tfl.pack_gh(t(g), t(h), t(w), nch)
    jx = (jnp.asarray(bins_T), jnp.asarray(leaf_T), gh_j, W_j,
          jnp.asarray(tbl))
    tx = (t(bins_T), t(leaf_T), gh_t, W_t, t(tbl))
    return jx, tx, F_oh


ROOT = [(0, 0, 15, True, 0, 1)] + [(-1, 0, 0, 0, 0, 0)] * 7
MID = [(0, 1, 5, True, 3, 1),     # zero-missing feature, default left
       (1, 2, 7, False, 3, 0),    # NaN-missing feature, default right
       (2, 3, 2, True, 3, 1)] + [(-1, 0, 0, 0, 0, 0)] * 5


def _bf16_bits(x):
    return np.asarray(jnp.asarray(x).view(jnp.uint16))


@pytest.mark.parametrize("nch", [tfl.NCH_PRECISE, tfl.NCH_FAST])
def test_pack_gh_and_route_table_bitwise(nch):
    (_, _, gh_j, W_j, _), (_, _, gh_t, W_t, _), _ = _operands(
        2048, 5, 16, 0, np.zeros(2048, np.int32), MID, nch)
    np.testing.assert_array_equal(
        _bf16_bits(gh_j), gh_t.view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_array_equal(np.asarray(W_j, np.float32),
                                  W_t.float().numpy())


@pytest.mark.parametrize("case,nch,B", [
    ("root", tfl.NCH_PRECISE, 16),
    ("mid", tfl.NCH_PRECISE, 16),
    ("mid", tfl.NCH_FAST, 16),
    ("mid", tfl.NCH_PRECISE, 256),    # int16 bins
])
def test_level_pass_matches_jax(case, nch, B):
    R, F = 2048, 5
    rng = np.random.RandomState(1)
    if case == "root":
        leaf, slots = np.zeros(R, np.int32), ROOT
    else:
        leaf, slots = rng.randint(0, 3, R).astype(np.int32), MID
    jx, tx, F_oh = _operands(R, F, B, 3, leaf, slots, nch)
    Sp = len(slots)
    hist_j, leaf_j = jfl.level_pass(*jx, num_slots=Sp, num_bins=B,
                                    f_oh=F_oh, nch=nch, tile_rows=256,
                                    interpret=True)
    before = dict(tfl.launches)
    hist_t, leaf_t = tfl.level_pass(*tx, num_bins=B, f_oh=F_oh, nch=nch)
    assert tfl.launches == before          # CPU tensors: plain version
    np.testing.assert_array_equal(np.asarray(leaf_j), leaf_t.numpy())
    pj = jfl.hist_planes(hist_j, nch, Sp, F_oh, B)
    pt = tfl.hist_planes(hist_t, nch, Sp, F_oh, B)
    for a, b in zip(pj[:2], pt[:2]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(pt[2].numpy(), np.asarray(pj[2]))


@pytest.mark.parametrize("B", [16, 256])
def test_route_pass_matches_jax(B):
    R = 2048
    leaf = np.random.RandomState(2).randint(0, 3, R).astype(np.int32)
    jx, tx, F_oh = _operands(R, 5, B, 4, leaf, MID, tfl.NCH_PRECISE)
    bins_j, leaf_j, _, W_j, tbl_j = jx
    bins_t, leaf_t, _, W_t, tbl_t = tx
    want = jfl.route_pass(bins_j, leaf_j, W_j, tbl_j, num_slots=len(MID),
                          num_bins=B, f_oh=F_oh, tile_rows=256,
                          interpret=True)
    got = tfl.route_pass(bins_t, leaf_t, W_t, tbl_t, num_bins=B, f_oh=F_oh)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_table_lookup_matches_jax():
    rng = np.random.RandomState(0)
    R, L = 4096, 255
    idx = rng.randint(-1, L + 3, size=R).astype(np.int32)
    table = rng.randn(L).astype(np.float32)
    want = jfl.table_lookup(jnp.asarray(idx[None, :]), jnp.asarray(table),
                            tile_rows=1024, interpret=True)
    got = tfl.table_lookup(torch.as_tensor(idx[None, :]),
                           torch.as_tensor(table))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_wrappers_reject_what_the_kernels_do_not_take():
    _, (bins, leaf, gh, W, tbl), F_oh = _operands(
        2048, 5, 16, 0, np.zeros(2048, np.int32), ROOT, 5)
    with pytest.raises(ValueError):
        tfl.level_pass(bins.to(torch.int32), leaf, gh, W, tbl, num_bins=16,
                       f_oh=F_oh)
    with pytest.raises(ValueError):
        tfl.level_pass(bins, leaf, gh.float(), W, tbl, num_bins=16,
                       f_oh=F_oh)
    with pytest.raises(ValueError):
        tfl.level_pass(bins, leaf, gh, W, tbl, num_bins=16, f_oh=F_oh, nch=4)
    with pytest.raises(ValueError):
        tfl.table_lookup(leaf.long(), torch.zeros(3))
