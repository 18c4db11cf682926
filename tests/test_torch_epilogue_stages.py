"""The stages of lightgbm_tpu_torch's ``route_pass`` and ``epilogue_pass``
on the CPU.

On the card both start with the slab table of W (for each W row, the one
kernel row whose slab is non-zero), then route a row with one bin and one
W entry (a W row over several slabs: the full sum; none: right); the
epilogue then computes the rows' scores, gradients and channels, and the
root histogram in kernels of their own. Their plain versions
(``slab_table_plain``, ``route_slabs_plain``, ``epilogue_rows_plain``,
``root_hist_plain``) composed must give ``route_pass_plain`` and
``epilogue_pass_plain`` exactly. The route is checked
on the grower's W, a W row over two slabs and all-zero W rows, padded
and packed; and the plain
versions route such a W as the JAX package's ``route_pass`` and
``epilogue_pass`` do (Pallas interpret mode). tests/test_torch_cuda.py
holds the CUDA kernels against these plain versions on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import fused_level as jfl
from lightgbm_tpu_torch.ops import fused_level as tfl
from torch_parity import kernel_slabs, level_operands, odd_route_table

torch.set_num_threads(1)

NUM_BIN = np.array([63, 63, 63, 8, 8, 8, 17, 2], np.int32)
R, RP = 1500, 2048


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("odd", [False, True])
def test_route_stages_compose_to_route_pass_plain(packed, odd):
    ops, _, kw = level_operands(R, RP, NUM_BIN, 64, 8, packed=packed,
                                seed=3 + packed)
    bins_T, leaf_T, _, W, tbl = ops
    if odd:
        W = odd_route_table(W, kernel_slabs(kw))
    rkw = dict(num_bins=64, f_oh=kw["f_oh"], packed=kw["packed"])
    slab_of = tfl.slab_table_plain(W, **rkw)
    if odd:
        assert slab_of[0] == tfl.SLAB_MANY
        assert slab_of[2] == tfl.SLAB_NONE
    else:
        assert bool((slab_of[:-1] >= 0).all())          # one slab each
    assert slab_of[-1] == tfl.SLAB_NONE                   # inactive slot
    got = tfl.route_slabs_plain(bins_T, leaf_T, W, tbl, slab_of, **rkw)
    want = tfl.route_pass_plain(bins_T, leaf_T, W, tbl, **rkw)
    assert torch.equal(got, want)
    assert not torch.equal(want, leaf_T)
    if odd:       # slot 2's rows all go right
        rows = leaf_T[0] == 2
        assert bool(rows.any())
        assert torch.equal(want[0, rows], leaf_T[0, rows] + tbl[2, 1])


def _epilogue_args(B, nch, kind, odd, seed):
    (bins_T, leaf_T, _, W, tbl), _, kw = level_operands(
        R, RP, [B - 1] * 6, B, 8, nch=nch, seed=seed)
    if odd:
        W = odd_route_table(W, kernel_slabs(kw))
    rng = np.random.RandomState(seed)
    t = torch.as_tensor
    lv = t((rng.randn(7) * 0.1).astype(np.float32))
    score = np.zeros((1, RP), np.float32)
    score[0, :R] = rng.randn(R)
    ops = np.zeros((8, RP), np.float32)
    ops[0, :R] = (np.where(rng.rand(R) < 0.4, 1.0, -1.0)
                  if kind == "binary" else rng.randn(R) * 3.0)
    ops[1, :R] = rng.uniform(0.5, 2.0, R)
    bag = np.zeros((1, RP), np.float32)
    bag[0, :R] = rng.rand(R) >= 0.3
    args = (bins_T, leaf_T, W, tbl, lv, t(score), t(ops), t(bag))
    return args, dict(num_bins=B, f_oh=kw["f_oh"], nch=nch, kind=kind)


def _assert_hist_close(got, want, bins_T, gh_T, B, f_oh, nch):
    """g/h planes within 1e-5 of the plane's largest per-cell sum of
    |channel| (the scale of any f32 summation order's rounding error, as
    chip_smoke.py holds the kernel); the weight channel and slots 1-7
    exact."""
    live = torch.zeros(nch * 8, dtype=torch.bool)
    live[::8] = True
    assert not got[:, ~live].any()
    abs_sum = tfl.root_hist_plain(bins_T, gh_T.float().abs().to(
        torch.bfloat16), num_bins=B, f_oh=f_oh, nch=nch)
    for c in range(nch - 1):
        err = float((got[:, 8 * c] - want[:, 8 * c]).abs().max())
        assert err <= 1e-5 * float(abs_sum[:, 8 * c].max()), c
    assert torch.equal(got[:, 8 * (nch - 1)], want[:, 8 * (nch - 1)])


@pytest.mark.parametrize("B,nch,kind,odd", [
    (64, 5, "binary", False), (64, 3, "l2", True), (16, 5, "l2", True),
    (256, 5, "binary", True), (256, 3, "binary", False)])
def test_epilogue_stages_compose_to_epilogue_pass_plain(B, nch, kind, odd):
    args, kw = _epilogue_args(B, nch, kind, odd, seed=B + nch)
    bins_T, leaf_T, W, tbl, lv, score, ops, bag = args
    f_oh = kw["f_oh"]
    hist_p, score_p, gh_p = tfl.epilogue_pass_plain(*args, **kw)
    slab_of = tfl.slab_table_plain(W, num_bins=B, f_oh=f_oh)
    new_leaf = tfl.route_slabs_plain(bins_T, leaf_T, W, tbl, slab_of,
                                     num_bins=B, f_oh=f_oh)
    score_s, gh_s = tfl.epilogue_rows_plain(new_leaf, lv, score, ops, bag,
                                            nch=nch, kind=kind)
    hist_s = tfl.root_hist_plain(bins_T, gh_s, num_bins=B, f_oh=f_oh,
                                 nch=nch)
    assert torch.equal(score_s, score_p)
    assert torch.equal(gh_s, gh_p)
    assert torch.equal(hist_s, hist_p)
    # rows out of the bag and padding rows add nothing: each feature's
    # weight plane counts the bag
    w = hist_p[:, 8 * (nch - 1)].view(f_oh, B).sum(1)
    assert torch.equal(w, torch.full_like(w, float(bag.sum())))


def test_route_plain_matches_jax_on_odd_route_tables():
    """A W row over two slabs and all-zero W rows route in the plain
    version as in the JAX package's route_pass."""
    ops, _, kw = level_operands(R, RP, [15] * 8, 16, 8, seed=5)
    bins_T, leaf_T, _, W, tbl = ops
    W = odd_route_table(W, kernel_slabs(kw))
    want = jfl.route_pass(jnp.asarray(bins_T.numpy()),
                          jnp.asarray(leaf_T.numpy()),
                          jnp.asarray(W.float().numpy()).astype(jnp.bfloat16),
                          jnp.asarray(tbl.numpy()), num_slots=8,
                          num_bins=16, f_oh=kw["f_oh"], tile_rows=256,
                          interpret=True)
    got = tfl.route_pass_plain(bins_T, leaf_T, W, tbl, num_bins=16,
                               f_oh=kw["f_oh"])
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_epilogue_plain_matches_jax_on_odd_route_tables():
    """The same for the JAX package's epilogue_pass (binary, nch 5, B=16),
    at tests/test_torch_epilogue.py's tolerances: new_score rtol 1e-6,
    decoded gh_T rtol 1e-6, the histogram as _assert_hist_close says."""
    args, kw = _epilogue_args(16, 5, "binary", True, seed=9)
    bins_T, leaf_T, W, tbl, lv, score, ops, bag = args
    j = [jnp.asarray(a.numpy()) for a in (bins_T, leaf_T)]
    hist_j, score_j, gh_j = jfl.epilogue_pass(
        *j, jnp.asarray(W.float().numpy()).astype(jnp.bfloat16),
        *[jnp.asarray(a.numpy()) for a in (tbl, lv, score, ops, bag)],
        num_bins=16, f_oh=kw["f_oh"], nch=5, kind="binary", sigmoid=1.0,
        tile_rows=1024, interpret=True)
    hist_t, score_t, gh_t = tfl.epilogue_pass_plain(*args, **kw)
    np.testing.assert_allclose(score_t.numpy(), np.asarray(score_j),
                               rtol=1e-6)
    g = gh_t.float().numpy()
    gj = np.asarray(gh_j, np.float32)
    for a, b in ((g[0] + g[1], gj[0] + gj[1]), (g[2] + g[3], gj[2] + gj[3]),
                 (g[4], gj[4])):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-30)
    _assert_hist_close(torch.as_tensor(np.array(hist_j)), hist_t, bins_T,
                       gh_t, 16, kw["f_oh"], 5)
