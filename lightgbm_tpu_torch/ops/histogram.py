"""Gradient/hessian histograms of the XLA engine's growers.

PyTorch counterpart of ``lightgbm_tpu/ops/histogram.py``
(``build_histograms``, ``histogram_subtract``): for every row r whose slot
``row_slot[r] = s`` lies in [0, num_slots) and every feature f,

    hist[s, f, bins[r, f], :] += gh[r, :]

with the channels (sum_grad, sum_hess, count) summed in f32 as they are
given (no bf16 rounding: that is the frontier engine's contract, not this
one's). Rows with slot -1 add nothing whatever their gh.

The JAX module has two formulations, ``segment`` (a segment-sum over a
joint (slot, feature, bin) index) and ``onehot`` (a one-hot contraction on
the MXU), and cuts the rows into chunks to bound the one-hot's memory on
the TPU. Both compute the same sums; here ``impl`` is accepted and named
and both take one path: on the card the unrounded f32 variant of the CUDA
``hist_pass`` (``ops/pallas_histogram.py``, ``csrc/hist_pass.cu``), on the
CPU its plain version (float64 sums rounded once). The chunking is a TPU
memory device and is not carried over.

``quant_bits`` 8 or 16 stochastically round g and h onto the fixed-point
grid (``ops/quantize.py``) and sum them exactly in int32, through the
quant variant of ``hist_pass`` (int8 channels); the count channel counts
the rows of non-zero weight, as the JAX package's ``(w > 0)``. The
16-bit grid travels as two int8 channels per value,
``q = 256 * hi + lo' + 128`` with a sixth channel of ones carrying the
recentering (a row of zero weight may hold a non-zero gradient here, which
the trainers' ``encode_channels`` never sees), recombined in int64 before
the one f32 rescale, so the result equals the JAX package's int32
segment sums rescaled, bit for bit, where that function runs eagerly
(under its jit XLA takes the scale's quotient one ulp off).

The kernel takes ``bins`` as an int32 ``[R, Fp]`` row-major copy,
feature-padded (``hist_bins``): the growers keep one per dataset and call
``histogram_planes``; ``build_histograms`` makes one per call. The
leaf-wise grower calls it for the root only: its children no longer go
through ``histogram_planes`` but through ``ops/data_partition.leaf_hist``,
which reads only the rows listed in the child's segment (the same sums
over the same rows).
"""
from __future__ import annotations

import torch

from . import quantize
from .pallas_histogram import hist_pass, pad_feature_layout

NUM_CH = 3
IMPLS = ("auto", "segment", "onehot")


def hist_bins(bins: torch.Tensor, num_bins: int) -> torch.Tensor:
    """The kernel's copy of ``bins`` [R, F]: int32 [R, Fp], the features
    padded with bin 0 to ``pad_feature_layout``'s width."""
    R, F = bins.shape
    Fp, _ = pad_feature_layout(max(F, 1), num_bins)
    out = torch.zeros((R, Fp), dtype=torch.int32, device=bins.device)
    out[:, :F] = bins.to(torch.int32)
    return out


def histogram_planes(bins_i32: torch.Tensor, gh: torch.Tensor,
                     row_slot: torch.Tensor, *, num_slots: int,
                     num_bins: int, num_features: int) -> torch.Tensor:
    """The growers' form: (grad, hess, count) planes [3, S, F, B] f32 from
    the kernel's bin copy (``hist_bins``), ``gh`` [R, 3] f32 and
    ``row_slot`` [R] int32."""
    out = hist_pass(bins_i32, gh, row_slot, S=num_slots, Bp=num_bins,
                    nch=NUM_CH, unrounded=True)
    return out[:, :num_slots, :num_features]


def build_histograms(bins: torch.Tensor, gh: torch.Tensor,
                     row_slot: torch.Tensor, *, num_slots: int,
                     num_bins: int, impl: str = "auto", quant_bits: int = 0,
                     seed: int = 0) -> torch.Tensor:
    """Histograms of a batch of target leaves (the JAX package's
    ``build_histograms``).

    Args:
      bins: [R, F] uint8/uint16 bins (or int16 bundle columns).
      gh: [R, 3] float32 (grad, hess, count weight).
      row_slot: [R] int32 target slot of each row, or -1.
      num_slots, num_bins: S and B of the result.
      impl: "auto", "segment" or "onehot" (the same sums).
      quant_bits: 0, or 8/16 for the exact fixed-point sums (``seed`` the
        dither's).

    Returns [num_slots, F, num_bins, 3] float32.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}; got {impl!r}")
    F = bins.shape[1]
    bins = hist_bins(bins, num_bins)
    gh = gh.to(torch.float32).contiguous()
    row_slot = row_slot.to(torch.int32).contiguous()
    if quant_bits:
        hist = _quant_planes(bins, gh, row_slot, num_slots, num_bins,
                             int(quant_bits), seed)[:, :, :F]
    else:
        hist = histogram_planes(bins, gh, row_slot, num_slots=num_slots,
                                num_bins=num_bins, num_features=F)
    return hist.permute(1, 2, 3, 0).contiguous()


def _quant_planes(bins_i32, gh, row_slot, S, B, bits, seed):
    """(grad, hess, count) planes [3, S, Fp, B] of the fixed-point sums,
    rescaled once to f32."""
    g, h, w = gh[:, 0], gh[:, 1], gh[:, 2]
    scales = quantize.quant_scales(g, h, bits)
    qg, qh = quantize.quantize_gh(g, h, scales, bits, seed)
    w8 = (w > 0).to(torch.int8)
    if bits == 8:
        rows = [qg.to(torch.int8), qh.to(torch.int8), w8]
    else:
        def split(q):
            hi = torch.div(q, 256, rounding_mode="floor")
            return [hi.to(torch.int8), (q - 256 * hi - 128).to(torch.int8)]
        rows = split(qg) + split(qh) + [w8, torch.ones_like(w8)]
    q = torch.stack(rows, 1).contiguous()
    p = hist_pass(bins_i32, q, row_slot, S=S, Bp=B, nch=len(rows),
                  quant=True)[:, :S].to(torch.int64)
    if bits == 8:
        sg, sh, sw = p[0], p[1], p[2]
    else:                     # q = 256 * hi + lo' + 128, exactly
        sg = p[0] * 256 + p[1] + 128 * p[5]
        sh = p[2] * 256 + p[3] + 128 * p[5]
        sw = p[4]
    f32 = torch.float32
    return torch.stack([sg.to(f32) * scales[0], sh.to(f32) * scales[1],
                        sw.to(f32)])


def histogram_subtract(parent: torch.Tensor,
                       child: torch.Tensor) -> torch.Tensor:
    """Sibling histogram by subtraction (ref: feature_histogram.hpp
    Subtract, serial_tree_learner.cpp:423-425)."""
    return parent - child
