"""The stages of lightgbm_tpu_torch's ``hist_pass`` on the CPU.

On the card the slot-keyed histogram of the frontier-v1 engine counts the
rows that add anything per slot, writes them into slot buckets in a fixed
order (by slot, then by row), adds each block's share of the bucketed rows
into per-slot partial slices in shared memory, and reduces the slices in a
fixed order. Their plain versions (``hist_bucket_plain``,
``hist_tiles_plain``, ``hist_reduce_plain``) composed must give
``hist_pass_plain``: exactly for int32 sums and the f32 weight channel,
and the f32 g/h planes within 1e-5 of each plane's largest per-cell sum of
|value| (the same bf16 values summed in another order). They must also
match the JAX package's ``_hist_kernel`` in Pallas interpret mode, as
tests/test_torch_hist.py runs it. tests/test_torch_cuda.py holds the CUDA
kernels against these plain versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import pallas_histogram as jph
from lightgbm_tpu_torch.ops import pallas_histogram as tph
from lightgbm_tpu_torch.ops import quantize as tq

torch.set_num_threads(1)


def _inputs(R, F, B, S, bits, slots, seed):
    """[R, Fp] int32 bins, gh (f32 g, h, w with ~20% of the rows out of the
    bag: all three zero; or the int8 channels of ``bits``) and the slots:
    ``random`` in [0, S) with ~30% at -1, ``one`` every row in slot 0,
    ``none`` every row at -1, ``sparse`` only slots 1 and S - 2 used."""
    rng = np.random.RandomState(seed)
    Fp, Bp = tph.pad_feature_layout(F, B)
    bins = np.zeros((R, Fp), np.int32)
    bins[:, :F] = rng.randint(0, B, (R, F))
    slot = rng.randint(0, S, R).astype(np.int32)
    slot[rng.rand(R) < 0.3] = -1
    if slots == "one":
        slot[:] = 0
    elif slots == "none":
        slot[:] = -1
    elif slots == "sparse":
        slot = np.where(rng.rand(R) < 0.5, 1, S - 2).astype(np.int32)
    bag = (rng.rand(R) >= 0.2).astype(np.float64)
    gh = np.stack([rng.randn(R) * bag, rng.rand(R) * bag, bag], 1)
    gh = torch.as_tensor(gh.astype(np.float32))
    if bits:
        g, h = gh[:, 0], gh[:, 1]
        scales = tq.quant_scales(g, h, bits)
        gh = torch.stack(tq.encode_channels(
            *tq.quantize_gh(g, h, scales, bits, seed), gh[:, 2], bits),
            1).contiguous()
    return torch.as_tensor(bins), gh, torch.as_tensor(slot), Bp


def _stages(bins, gh, slot, S, Bp, quant, blocks):
    off, brow = tph.hist_bucket_plain(gh, slot, S=S, quant=quant)
    part = tph.hist_tiles_plain(bins, gh, brow, off, Bp=Bp, nch=gh.shape[1],
                                blocks=blocks, quant=quant)
    return off, brow, tph.hist_reduce_plain(part, off, blocks=blocks)


def _assert_planes(got, want, gh, bins, slot, kw):
    assert got.shape == want.shape and got.dtype == want.dtype
    if kw["quant"]:
        assert torch.equal(got, want)
        return
    abs_sum = tph.hist_pass_plain(bins, gh.abs(), slot, **kw)
    for c in range(2):
        err = float((got[c] - want[c]).abs().max())
        assert err <= 1e-5 * float(abs_sum[c].max()), c
    assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("R,F,B,S,bits,slots,blocks", [
    (1001, 6, 16, 13, 0, "random", 7),     # R not a multiple of any block
    (777, 28, 64, 8, 0, "one", 5),         # the root: one slot, many blocks
    (900, 28, 64, 64, 16, "random", 3),    # deep level, quant16
    (600, 40, 16, 8, 8, "random", 4),      # Fp > 32: two feature groups
    (500, 5, 16, 13, 0, "sparse", 6),      # empty slots between used ones
    (400, 6, 16, 8, 0, "none", 2),         # no row slotted
    (300, 6, 16, 8, 16, "random", 50),     # more blocks than rows
])
def test_hist_stages_compose_to_hist_pass_plain(R, F, B, S, bits, slots,
                                                blocks):
    bins, gh, slot, Bp = _inputs(R, F, B, S, bits, slots, seed=R + S + bits)
    quant = bool(bits)
    kw = dict(S=S, Bp=Bp, nch=gh.shape[1], quant=quant)
    off, brow, got = _stages(bins, gh, slot, S, Bp, quant, blocks)
    want = tph.hist_pass_plain(bins, gh, slot, **kw)
    _assert_planes(got, want, gh, bins, slot, kw)
    # the buckets: every live row once, by slot then by row; out-of-bag
    # rows (all channels zero) and unslotted ones in none
    Sp = off.numel() - 1
    live = (slot >= 0) & (slot < Sp) & (gh != 0).any(1)
    assert int(off[-1]) == brow.numel() == int(live.sum())
    key = slot[brow.long()].long() * R + brow.long()
    assert bool((key[1:] > key[:-1]).all())
    counts = torch.bincount(slot[live].long(), minlength=Sp)
    assert torch.equal(off[1:] - off[:-1], counts.to(torch.int32))


@pytest.mark.parametrize("bits", [0, 16])
def test_hist_stages_match_jax(bits):
    """The composed stages against the JAX package's _hist_kernel in Pallas
    interpret mode: the f32 planes within 1e-5 of each plane's largest |sum|
    with the weight plane exact; the int32 planes exactly."""
    R, F, B, S = 700, 6, 16, 13
    bins, gh, slot, Bp = _inputs(R, F, B, S, bits, "random", seed=11)
    quant = bool(bits)
    _, _, got = _stages(bins, gh, slot, S, Bp, quant, blocks=4)
    j = [jnp.asarray(t.numpy()) for t in (bins, gh, slot)]
    if quant:
        want = np.asarray(jph._run_hist_kernel(
            *j, S=S, Bp=Bp, C=512, nch=gh.shape[1], quant=True,
            interpret=True))
        np.testing.assert_array_equal(got.numpy(), want)
        return
    cm = jph.build_histograms_pallas_cm(*j, num_slots=S, num_bins=Bp,
                                        interpret=True)
    for c in range(3):
        a, b = got[c, :S].numpy(), np.asarray(cm[c])
        if c == 2:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * np.abs(b).max())
    assert not got[:, S:].any()            # slots past S stay zero
