"""The slot-keyed histogram of the frontier-v1 engine.

PyTorch counterpart of ``lightgbm_tpu/ops/pallas_histogram.py`` (the
module keeps the JAX module's name so a reader finds the counterpart; it
holds no Pallas). The TPU kernel ``_hist_kernel`` becomes the CUDA kernel
``csrc/hist_pass.cu`` behind :func:`hist_pass`, with its plain PyTorch
version :func:`hist_pass_plain` beside it. On a CPU tensor the wrapper
runs the plain version; on a CUDA tensor it launches the kernel or raises.

Contract (``pallas_histogram.py:60-132``): for every row r whose slot
``row_slot[r] = s`` lies in [0, Sp), every feature f < Fp and channel
ch < nch, ``out[ch, s, f, bins[r, f]] += v[r, ch]``, with
``Sp = round_up(max(S, 8), 8)``:

- f32 variant: ``v = bf16(gh[r, ch])`` (round to nearest even, as the TPU
  kernel's ``gh.astype(bfloat16)``), summed in f32. This rounding of g, h
  and w is part of the frontier engine's numbers;
- quant variant: ``v`` is an int8 channel from
  :func:`ops.quantize.encode_channels`, summed exactly in int32.

Rows with slot -1 add nothing whatever their gh. Layouts: ``bins_i32``
[R, Fp] int32 row-major (feature-padded so ``Fp * Bp % 128 == 0``),
``row_slot`` [R] int32, ``gh`` [R, nch] f32 or int8, out [nch, Sp, Fp, Bp]
f32 or int32. Any R.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import quantize
from .fused_level import (_raise_on, _require_cuda, _stream, cuda_launches,
                          launches)
from .layout import feature_layout

NUM_CH = 3


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_feature_layout(num_features: int, max_bin: int) -> Tuple[int, int]:
    """(Fp, Bp) with Bp = pow2 >= max_bin and (Fp * Bp) % 128 == 0: the
    layout contract shared with the fused kernels (``ops/layout.py``)."""
    return feature_layout(num_features, max_bin)


def _check(bins_i32, gh, row_slot, S, Bp, nch, quant) -> Tuple[int, int, int]:
    if bins_i32.dim() != 2 or bins_i32.dtype != torch.int32:
        raise ValueError("bins_i32 must be a 2-D int32 tensor; got "
                         f"{tuple(bins_i32.shape)} {bins_i32.dtype}")
    R, Fp = bins_i32.shape
    if not 1 <= nch <= 8:
        raise ValueError(f"nch must be in [1, 8]; got {nch}")
    want = torch.int8 if quant else torch.float32
    if tuple(gh.shape) != (R, nch) or gh.dtype != want:
        raise ValueError(f"gh must be [{R}, {nch}] {want}; got "
                         f"{tuple(gh.shape)} {gh.dtype}")
    if tuple(row_slot.shape) != (R,) or row_slot.dtype != torch.int32:
        raise ValueError(f"row_slot must be [{R}] int32")
    if S < 1 or Bp < 1:
        raise ValueError(f"S and Bp must be positive; got S={S} Bp={Bp}")
    for name, t in (("gh", gh), ("row_slot", row_slot)):
        if t.device != bins_i32.device:
            raise ValueError(f"{name} is on {t.device}, bins_i32 on "
                             f"{bins_i32.device}")
    return R, Fp, _round_up(max(S, 8), 8)


def hist_pass_plain(bins_i32: torch.Tensor, gh: torch.Tensor,
                    row_slot: torch.Tensor, *, S: int, Bp: int, nch: int,
                    quant: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`hist_pass`: one ``index_add_`` of
    every (slotted row, feature) pair's channels into a flat
    [Sp*Fp*Bp, nch] buffer."""
    R, Fp = bins_i32.shape
    Sp = _round_up(max(S, 8), 8)
    dev = bins_i32.device
    acc = torch.int32 if quant else torch.float32
    rows = torch.nonzero((row_slot >= 0) & (row_slot < Sp)).squeeze(1)
    s = row_slot[rows].long()
    b = bins_i32[rows].long()                                     # [n, Fp]
    vals = (gh[rows].to(torch.int32) if quant
            else gh[rows].to(torch.bfloat16).float())             # [n, nch]
    cell = (s[:, None] * Fp + torch.arange(Fp, device=dev)) * Bp + b
    ok = (b >= 0) & (b < Bp)
    out = torch.zeros((Sp * Fp * Bp, nch), dtype=acc, device=dev)
    src = vals[:, None, :].expand(-1, Fp, -1)
    out.index_add_(0, cell[ok], src[ok])
    return out.t().reshape(nch, Sp, Fp, Bp)


def hist_pass(bins_i32: torch.Tensor, gh: torch.Tensor,
              row_slot: torch.Tensor, *, S: int, Bp: int, nch: int,
              quant: bool = False) -> torch.Tensor:
    """The slot-keyed histogram (module docstring): [nch, Sp, Fp, Bp] f32,
    or int32 when ``quant``."""
    R, Fp, Sp = _check(bins_i32, gh, row_slot, S, Bp, nch, quant)
    if bins_i32.device.type == "cpu":
        return hist_pass_plain(bins_i32, gh, row_slot, S=S, Bp=Bp, nch=nch,
                               quant=quant)
    _require_cuda(bins_i32, gh, row_slot)
    from .cuda_build import library
    out = torch.zeros((nch, Sp, Fp, Bp),
                      dtype=torch.int32 if quant else torch.float32,
                      device=bins_i32.device)
    rc = library().lgbt_hist_pass(
        bins_i32.data_ptr(), gh.data_ptr(), row_slot.data_ptr(),
        out.data_ptr(), R, Fp, Bp, Sp, nch, int(bool(quant)),
        _stream(bins_i32.device))
    _raise_on(rc, "hist_pass")
    launches["hist_pass"] += 1
    cuda_launches["hist_pass"] += 1
    return out


def build_histograms_pallas(bins_i32: torch.Tensor, gh3: torch.Tensor,
                            row_slot: torch.Tensor, *, num_slots: int,
                            num_bins: int) -> torch.Tensor:
    """[num_slots, Fp, num_bins, 3] f32 (g, h, w channel-minor) from
    ``gh3`` [R, 3] f32; slot -1 rows contribute nothing."""
    hist = hist_pass(bins_i32, gh3, row_slot, S=num_slots, Bp=num_bins,
                     nch=NUM_CH)[:, :num_slots]
    return hist.permute(1, 2, 3, 0)


def build_histograms_pallas_cm(bins_i32: torch.Tensor, gh3: torch.Tensor,
                               row_slot: torch.Tensor, *, num_slots: int,
                               num_bins: int):
    """Channel-major variant: (grad, hess, count) planes [S, Fp, Bp]."""
    hist = hist_pass(bins_i32, gh3, row_slot, S=num_slots, Bp=num_bins,
                     nch=NUM_CH)
    return hist[0, :num_slots], hist[1, :num_slots], hist[2, :num_slots]


def build_histograms_pallas_quant(bins_i32: torch.Tensor, gh3: torch.Tensor,
                                  row_slot: torch.Tensor, *, num_slots: int,
                                  num_bins: int, quant_bits: int = 16,
                                  seed: int = 0):
    """Quantized variant (``tpu_quantized_grad``): grad/hess stochastically
    rounded onto the fixed-point grid (``ops/quantize.py``), int8 channels
    summed exactly in int32, decoded to (grad, hess, count) f32 planes
    [S, Fp, Bp]."""
    g, h, w = gh3[:, 0], gh3[:, 1], gh3[:, 2]
    scales = quantize.quant_scales(g, h, quant_bits)
    qg, qh = quantize.quantize_gh(g, h, scales, quant_bits, seed)
    rows = quantize.encode_channels(qg, qh, w, quant_bits)
    gh_q = torch.stack(rows, 1).contiguous()                 # [R, nch] int8
    hist = hist_pass(bins_i32, gh_q, row_slot, S=num_slots, Bp=num_bins,
                     nch=len(rows), quant=True)
    g_s, h_s, c_s = quantize.decode_sums(list(hist), scales, quant_bits)
    return g_s[:num_slots], h_s[:num_slots], c_s[:num_slots]
