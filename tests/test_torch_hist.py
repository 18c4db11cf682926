"""The port's slot-keyed histogram (``ops/pallas_histogram.py``) and
fixed-point quantization (``ops/quantize.py``) against the JAX package's.

On CPU tensors the wrappers run ``hist_pass_plain``; the JAX package runs
its Pallas ``_hist_kernel`` in interpret mode, as tests/test_hist_plane.py
does. Same numpy inputs: R not a multiple of the TPU's 512-row tile, S in
{1, 5, 8, 13} (Sp rounding and empty slots), Bp 16 and 64, ~30% of rows at
slot -1 with non-zero gh. Tolerances:

- f32 g/h planes: rtol 1e-5 with atol 1e-5 of the plane's largest |value|
  (the same bf16 values summed in f32 in another order); the weight
  channel exactly;
- quant: the int32 accumulator planes exactly (integer sums do not depend
  on order); the decoded count plane exactly and the decoded g/h planes at
  rtol 1e-6 — XLA compiles the JAX wrapper's ``max|g| / QMAX`` scale
  fused into its decode as a product with the reciprocal, which can move
  the scale by an ulp (the port computes the quotient the source names,
  as eager JAX does);
- ``quantize.*``: bit-equal to ``lightgbm_tpu.ops.quantize`` run eagerly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import pallas_histogram as jph
from lightgbm_tpu.ops import quantize as jq
from lightgbm_tpu_torch.ops import fused_level as tfl
from lightgbm_tpu_torch.ops import pallas_histogram as tph
from lightgbm_tpu_torch.ops import quantize as tq

# small shapes: intra-op threads would only contend with the other test
# workers' processes
torch.set_num_threads(1)

CASES = [(1000, 6, 16, 1), (1000, 6, 16, 5), (777, 3, 64, 8),
         (1300, 5, 64, 13)]
IDS = ["S1", "S5", "S8-Bp64", "S13-Bp64"]


def _inputs(R, F, B, S, seed):
    rng = np.random.RandomState(seed)
    Fp, Bp = jph.pad_feature_layout(F, B)
    assert (Fp, Bp) == tph.pad_feature_layout(F, B)
    bins = np.zeros((R, Fp), np.int32)
    bins[:, :F] = rng.randint(0, B, (R, F))
    slot = rng.randint(0, S, R).astype(np.int32)
    slot[rng.rand(R) < 0.3] = -1
    g = rng.randn(R) * 3.0
    h = rng.rand(R) * 0.25
    w = (rng.rand(R) < 0.8).astype(np.float64)     # some rows out of bag
    gh = np.stack([g * w, h * w, w], 1).astype(np.float32)
    return bins, gh, slot, Bp


def _close_f32(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("R,F,B,S", CASES, ids=IDS)
def test_f32_histograms_match_jax(R, F, B, S):
    bins, gh, slot, Bp = _inputs(R, F, B, S, seed=R + S)
    j = [jnp.asarray(a) for a in (bins, gh, slot)]
    t = [torch.as_tensor(a) for a in (bins, gh, slot)]
    before = dict(tfl.launches)
    cm_j = jph.build_histograms_pallas_cm(*j, num_slots=S, num_bins=Bp,
                                          interpret=True)
    cm_t = tph.build_histograms_pallas_cm(*t, num_slots=S, num_bins=Bp)
    for a, b in zip(cm_t[:2], cm_j[:2]):
        _close_f32(a, b)
    np.testing.assert_array_equal(cm_t[2].numpy(), np.asarray(cm_j[2]))
    cmin_j = jph.build_histograms_pallas(*j, num_slots=S, num_bins=Bp,
                                         interpret=True)
    cmin_t = tph.build_histograms_pallas(*t, num_slots=S, num_bins=Bp)
    _close_f32(cmin_t[..., :2], np.asarray(cmin_j)[..., :2])
    np.testing.assert_array_equal(cmin_t[..., 2].numpy(),
                                  np.asarray(cmin_j)[..., 2])
    assert tfl.launches == before            # CPU tensors: plain version
    # the weight plane of feature 0 counts the in-bag slotted rows
    assert cm_t[2][:, 0].sum() == ((slot >= 0) & (gh[:, 2] > 0)).sum()


def test_unslotted_rows_add_nothing_and_slots_past_s_stay_zero():
    bins, gh, slot, Bp = _inputs(900, 4, 16, 5, seed=3)
    t = torch.as_tensor
    full = tph.hist_pass(t(bins), t(gh), t(slot), S=5, Bp=Bp, nch=3)
    gh0 = gh.copy()
    gh0[slot < 0] = 0.0
    zeroed = tph.hist_pass(t(bins), t(gh0), t(slot), S=5, Bp=Bp, nch=3)
    assert full.shape == (3, 8, bins.shape[1], Bp)     # Sp = 8
    assert torch.equal(full, zeroed)
    assert not full[:, 5:].any() and full[2].sum() > 0


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("R,F,B,S", CASES, ids=IDS)
def test_quant_histograms_match_jax(R, F, B, S, bits):
    bins, gh, slot, Bp = _inputs(R, F, B, S, seed=R + S + bits)
    seed = 7 + S
    # the kernel's int32 planes from the same int8 channels: exact
    g, h, w = (jnp.asarray(gh[:, c]) for c in range(3))
    scales = jq.quant_scales(g, h, bits)
    rows = jq.encode_channels(*jq.quantize_gh(g, h, scales, bits, seed), w,
                              bits)
    gh_q = np.stack([np.asarray(r) for r in rows], 1)
    raw_j = jph._run_hist_kernel(jnp.asarray(bins), jnp.asarray(gh_q),
                                 jnp.asarray(slot), S=S, Bp=Bp, C=512,
                                 nch=len(rows), quant=True, interpret=True)
    raw_t = tph.hist_pass(torch.as_tensor(bins), torch.as_tensor(gh_q),
                          torch.as_tensor(slot), S=S, Bp=Bp, nch=len(rows),
                          quant=True)
    assert raw_t.dtype == torch.int32 and raw_t.shape[0] == tq.QNCH[bits]
    np.testing.assert_array_equal(raw_t.numpy(), np.asarray(raw_j))
    # the decoded planes through the public wrappers
    dec_j = jph.build_histograms_pallas_quant(
        jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(slot), num_slots=S,
        num_bins=Bp, quant_bits=bits, seed=seed, interpret=True)
    dec_t = tph.build_histograms_pallas_quant(
        torch.as_tensor(bins), torch.as_tensor(gh), torch.as_tensor(slot),
        num_slots=S, num_bins=Bp, quant_bits=bits, seed=seed)
    for a, b in zip(dec_t[:2], dec_j[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=0)
    np.testing.assert_array_equal(dec_t[2].numpy(), np.asarray(dec_j[2]))


@pytest.mark.parametrize("seed", [0, 123, 2 ** 32 - 5])
@pytest.mark.parametrize("bits", [8, 16])
def test_quantize_bit_equal(bits, seed):
    rng = np.random.RandomState(seed % 1000)
    g = (rng.randn(3001) * 2.0).astype(np.float32)
    h = rng.rand(3001).astype(np.float32)
    w = (rng.rand(3001) < 0.7).astype(np.float32)
    tg, th, tw = (torch.as_tensor(a) for a in (g, h, w))
    jg, jh, jw = (jnp.asarray(a) for a in (g, h, w))
    s_j = jq.quant_scales(jg, jh, bits)
    s_t = tq.quant_scales(tg, th, bits)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    q_j = jq.quantize_gh(jg, jh, s_j, bits, seed)
    q_t = tq.quantize_gh(tg, th, s_t, bits, seed)
    for a, b in zip(q_t, q_j):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    e_j = jq.encode_channels(*q_j, jw, bits)
    e_t = tq.encode_channels(*q_t, tw, bits)
    assert len(e_t) == len(e_j) == tq.QNCH[bits]
    for a, b in zip(e_t, e_j):
        assert a.dtype == torch.int8
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    planes = [rng.randint(-5000, 5000, (4, 16)).astype(np.int32)
              for _ in e_t]
    d_j = jq.decode_sums([jnp.asarray(p) for p in planes], s_j, bits)
    d_t = tq.decode_sums([torch.as_tensor(p) for p in planes], s_t, bits)
    for a, b in zip(d_t, d_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = (rng.randn(3, 257) * 40.0).astype(np.float32)     # 2-D dither
    np.testing.assert_array_equal(
        tq.stochastic_round(torch.as_tensor(x), seed).numpy(),
        np.asarray(jq.stochastic_round(jnp.asarray(x), seed)))
    assert tq.quant_elem_bytes(bits) == jq.quant_elem_bytes(bits)


def test_hist_pass_refuses_what_the_kernel_does_not_take():
    bins, gh, slot, Bp = _inputs(300, 4, 16, 3, seed=1)
    t = torch.as_tensor
    kw = dict(S=3, Bp=Bp, nch=3)
    bad = [(t(bins).long(), t(gh), t(slot), kw),
           (t(bins), t(gh).double(), t(slot), kw),
           (t(bins), t(gh)[:, :2], t(slot), kw),
           (t(bins), t(gh), t(slot)[:100], kw),
           (t(bins), t(gh), t(slot), dict(kw, quant=True)),
           (t(bins), t(gh), t(slot), dict(kw, nch=9))]
    for b, g, s, k in bad:
        with pytest.raises(ValueError):
            tph.hist_pass(b, g, s, **k)
