"""The XLA engine's histograms: the port's ``ops/histogram.py`` against the
JAX package's ``build_histograms`` (``lightgbm_tpu/ops/histogram.py``).

The same bins, gradients and slots (numpy, seeded) go through both. The
f32 sums agree within 1e-5 of each cell's sum of |value| (the JAX package
sums in f32 in its own order, the plain version in float64 rounded once);
the weight channel is equal. The quantized histograms are equal bit for
bit to the JAX package's int32 segment sums rescaled once, with the JAX
function run eagerly (``jax.disable_jit()``): under its jit XLA computes
the scale ``max|g| / qmax`` one ulp off the quotient, which moves the
stochastic rounding of a few rows, while the port (and the JAX package's
``quantize`` functions called alone) take the quotient as written.
``hist_pass_plain``'s unrounded variant is held to the float64 sum of the
values as given, and its bf16-rounded one differs from it.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lightgbm_tpu.ops import histogram as jh
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import pallas_histogram as ph

R, F, B = 2000, 6, 16


def _inputs(dtype, S, seed):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (R, F)).astype(dtype)
    w = (rng.rand(R) > 0.3).astype(np.float32)
    gh = np.stack([rng.randn(R), rng.rand(R), w], 1).astype(np.float32)
    slot = rng.randint(-1, S, R).astype(np.int32)   # slot -1: non-zero gh
    return bins, gh, slot


def _jax(bins, gh, slot, S, **kw):
    return np.asarray(jh.build_histograms(
        jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(slot), num_slots=S,
        num_bins=B, **kw))


def _port(bins, gh, slot, S, **kw):
    return th.build_histograms(
        torch.as_tensor(bins.astype(np.int32)), torch.as_tensor(gh),
        torch.as_tensor(slot), num_slots=S, num_bins=B, **kw).numpy()


def _abs_sum(bins, gh, slot, S):
    return _port(bins, np.abs(gh), slot, S)


@pytest.mark.parametrize("impl", ["segment", "onehot"])
@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_build_histograms_matches_jax(dtype, S, impl):
    bins, gh, slot = _inputs(dtype, S, seed=S)
    want = _jax(bins, gh, slot, S, impl=impl)
    got = _port(bins, gh, slot, S, impl=impl)
    assert got.shape == want.shape == (S, F, B, 3)
    scale = _abs_sum(bins, gh, slot, S)[..., :2].max()
    assert np.abs(got[..., :2] - want[..., :2]).max() <= 1e-5 * scale
    np.testing.assert_array_equal(got[..., 2], want[..., 2])


@pytest.mark.parametrize("quant_bits", [8, 16])
@pytest.mark.parametrize("S", [1, 8])
def test_build_histograms_quantized_exact(quant_bits, S):
    bins, gh, slot = _inputs(np.uint8, S, seed=10 + S)
    with jax.disable_jit():
        want = _jax(bins, gh, slot, S, quant_bits=quant_bits, seed=3)
    got = _port(bins, gh, slot, S, quant_bits=quant_bits, seed=3)
    np.testing.assert_array_equal(got, want)


def test_histogram_subtract_and_impl_names():
    bins, gh, slot = _inputs(np.uint8, 2, seed=4)
    whole = _port(bins, gh, np.where(slot >= 0, 0, -1).astype(np.int32), 1)
    two = _port(bins, gh, slot, 2)
    sib = th.histogram_subtract(torch.as_tensor(whole[0]),
                                torch.as_tensor(two[0])).numpy()
    np.testing.assert_allclose(sib, two[1], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(_port(bins, gh, slot, 2, impl="auto"),
                                  two)
    with pytest.raises(ValueError, match="impl"):
        _port(bins, gh, slot, 2, impl="pallas")


def test_hist_pass_plain_unrounded_is_the_float64_sum():
    bins, gh, slot = _inputs(np.uint8, 3, seed=7)
    Fp, _ = ph.pad_feature_layout(F, B)
    b32 = th.hist_bins(torch.as_tensor(bins), B)
    assert tuple(b32.shape) == (R, Fp) and b32.dtype == torch.int32
    kw = dict(S=3, Bp=B, nch=3)
    got = ph.hist_pass_plain(b32, torch.as_tensor(gh), torch.as_tensor(slot),
                             unrounded=True, **kw).numpy()
    want = np.zeros((3, 8, Fp, B))
    padded = np.zeros((R, Fp), np.int64)       # padding features: bin 0
    padded[:, :F] = bins
    for r in np.nonzero(slot >= 0)[0]:
        for f in range(Fp):
            want[:, slot[r], f, padded[r, f]] += gh[r].astype(np.float64)
    np.testing.assert_array_equal(got, want.astype(np.float32))
    rounded = ph.hist_pass_plain(b32, torch.as_tensor(gh),
                                 torch.as_tensor(slot), **kw).numpy()
    assert not np.array_equal(rounded[:2], got[:2])
    with pytest.raises(ValueError, match="nch <= 3"):
        ph.hist_pass(b32, torch.zeros((R, 4)), torch.as_tensor(slot), S=3,
                     Bp=B, nch=4, unrounded=True)
