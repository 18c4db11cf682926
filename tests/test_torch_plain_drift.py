"""The plain root histogram against float64 and against the JAX kernel.

On real rows a tree's first epilogue sees few distinct scores (about 255
at the Higgs-shaped cell), so about 10^5 equal gradients meet in one
histogram cell. An f32 ``index_add_`` in row order then drifts from the
exact sum (7.1e-4 of the absolute sum was measured at 1M rows). The port's
plain versions — ``root_hist_plain`` (the epilogue's), ``_hist_plain``
(``level_pass_plain``'s) and ``hist_pass_plain`` — sum in float64 and
round once to f32. Here, on 2^17 rows with 255 distinct scores, the plain
root histogram must be no further from the float64 sum of the same bf16
channel values than the JAX package's ``epilogue_pass`` (Pallas
``interpret=True``) is from the float64 sum of its own channels; the f32
row-order sum is measured beside them to show the drift it repairs. The
error of each channel is its largest cell error over the channel's
absolute sum.
"""
import numpy as np
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import fused_level as jfl
from lightgbm_tpu_torch.ops import fused_level as tfl
from lightgbm_tpu_torch.ops.layout import feature_layout

torch.set_num_threads(1)

R = 1 << 17
F, B = 4, 16


def _operands(seed=0):
    rng = np.random.RandomState(seed)
    F_oh, _ = feature_layout(F, B)
    bins = np.zeros((max(F_oh, 8), R), np.int8)
    bins[:F] = rng.randint(0, B, (F, R))
    leaf = np.zeros((1, R), np.int32)
    levels = np.linspace(-2.0, 2.0, 255).astype(np.float32)
    score = levels[rng.randint(0, 255, R)][None, :]
    ops = np.zeros((8, R), np.float32)
    ops[0] = np.where(rng.rand(R) < 0.5, 1.0, -1.0)
    ops[1] = 1.0
    bag = np.ones((1, R), np.float32)
    Sp = 8
    W = np.zeros((Sp, F_oh * B), np.float32)
    tbl = np.zeros((Sp, 128), np.int32)
    tbl[:, 0] = -2                         # all inactive: nothing routes
    lv = np.zeros(7, np.float32)
    return (bins, leaf, W, tbl, lv, score, ops, bag), F_oh


def _err(hist, gh, bins, F_oh, nch):
    """Per channel: the largest |hist - float64 sum| over the channel's
    absolute sum (the float64 sums of the same bf16 channel values)."""
    ch = np.asarray(gh, np.float64)[:nch]
    want = np.zeros((F_oh * B, nch))
    for f in range(F_oh):
        idx = f * B + bins[f].astype(np.int64)
        for c in range(nch):
            np.add.at(want[:, c], idx, ch[c])
    got = np.asarray(hist, np.float64)[:, ::8][:, :nch]
    scale = np.abs(ch).sum(1) * F_oh
    return np.abs(got - want).max(0) / scale


def test_plain_root_histogram_is_no_further_from_float64_than_jax():
    args, F_oh = _operands()
    bins, leaf, W, tbl, lv, score, ops, bag = args
    t = torch.as_tensor
    hist_t, _, gh_t = tfl.epilogue_pass(
        t(bins), t(leaf), t(W).to(torch.bfloat16), t(tbl), t(lv), t(score),
        t(ops), t(bag), num_bins=B, f_oh=F_oh, nch=5, kind="binary")
    hist_j, _, gh_j = jfl.epilogue_pass(
        *[jnp.asarray(a) for a in (bins, leaf)],
        jnp.asarray(W).astype(jnp.bfloat16),
        *[jnp.asarray(a) for a in (tbl, lv, score, ops, bag)],
        num_bins=B, f_oh=F_oh, nch=5, kind="binary", sigmoid=1.0,
        tile_rows=2048, interpret=True)
    gh_t = gh_t.float().numpy()
    err_plain = _err(hist_t.numpy(), gh_t, bins, F_oh, 5)
    err_jax = _err(np.asarray(hist_j), np.asarray(gh_j, np.float32), bins,
                   F_oh, 5)
    # the f32 row-order sum the plain version replaced, on the same values
    f32 = torch.zeros(F_oh * B * 40)
    vals = torch.as_tensor(gh_t[:5])
    for f in range(F_oh):
        cell = (f * B + torch.as_tensor(bins[f]).long()) * 40
        f32.index_add_(0, (cell[None, :] + torch.arange(5)[:, None] * 8)
                       .reshape(-1), vals.reshape(-1))
    err_f32 = _err(f32.reshape(-1, 40).numpy(), gh_t, bins, F_oh, 5)
    print("max err over the abs sum: plain", err_plain.max(), "jax",
          err_jax.max(), "f32 row order", err_f32.max())
    assert (err_plain <= err_jax).all(), (err_plain, err_jax)
    assert err_plain.max() < 1e-7
    assert err_f32.max() > 10 * err_plain.max(), (err_f32, err_plain)
