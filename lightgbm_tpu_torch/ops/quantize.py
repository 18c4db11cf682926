"""Fixed-point gradient/hessian quantization for histogram accumulation.

PyTorch counterpart of ``lightgbm_tpu/ops/quantize.py`` (grounding: arxiv
2011.02022). Gradients and hessians are stochastically rounded onto a
signed ``2^(bits-1)-1`` grid under one global scale per channel, the
histograms sum the integer grid values exactly in int32 (integer addition
does not depend on order, so the kernel's atomics give the same sums as
the plain version), and one f32 rescale happens at the decode boundary,
before the split search.

The 16-bit grid travels as two int8 channels per value:

    q = 256 * hi + lo' + 128 * w      with lo' in [-128, 127], w in {0, 1}

The ``128 * w`` recentering keeps lo' signed while zero-weight rows add
exactly zero; the count channel ``w`` supplies the recentering sum.

The dither of row i is a murmur-style hash of (i, seed) alone, so the
result is deterministic given (values, seed) and bit-equal to the JAX
package's. The hash is uint32 wrap-around arithmetic: here it runs in
int64 masked to 32 bits after every product (torch has no uint32 multiply
on every device), which gives the same bits.

Under a process group (data-parallel ranks, each holding a block of the
global padded rows) the scales are the group's MAX of the local ones
(``quant_scales(..., group)``) and row i of the rank whose block starts at
``row_offset`` hashes its GLOBAL index ``row_offset + i``, as the JAX
package's global sharded array gives it: every rank then quantizes on the
serial grid with the serial dither, and the int32 histogram sums, which do
not depend on order, are the serial ones.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

QMAX = {8: 127, 16: 32767}
# channel count per bit width: 8 -> (g, h, w); 16 -> (g_hi, g_lo, h_hi,
# h_lo, w), as the f32 path's NCH_FAST / NCH_PRECISE
QNCH = {8: 3, 16: 5}
_M32 = 0xFFFFFFFF


def quant_elem_bytes(quant_bits: int) -> int:
    """Element width of the quantized grid (4 = the f32 default)."""
    return {0: 4, 8: 1, 16: 2}[int(quant_bits)]


def _mix(h: torch.Tensor) -> torch.Tensor:
    """murmur3-style avalanche over uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    h = h ^ (h >> 16)
    return h


def stochastic_round(x: torch.Tensor, seed: int,
                     row_offset: int = 0) -> torch.Tensor:
    """floor(x) + (u < frac(x)) as int32, u in [0, 1) hashed from (index
    along the last axis plus ``row_offset``, seed): unbiased, and
    value-independent so an ulp of drift in x flips a rounding only when
    it straddles u."""
    n = x.shape[-1]
    idx = torch.arange(row_offset, row_offset + n, dtype=torch.int64,
                       device=x.device)
    seed = int(seed) & _M32
    h = _mix(((idx * 2654435761) & _M32) ^ ((seed * 0x27D4EB2F) & _M32))
    u = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
    if x.dim() > 1:
        u = u.expand(x.shape)
    x = x.to(torch.float32)
    lo = torch.floor(x)
    frac = x - lo
    return lo.to(torch.int32) + (u < frac).to(torch.int32)


def quant_scales(grad: torch.Tensor, hess: torch.Tensor,
                 bits: int, group=None) -> torch.Tensor:
    """[2] f32 global scales (grad, hess): max|x| / QMAX (at least
    1e-30 / QMAX); the max is taken over every rank of ``group``."""
    qmax = torch.tensor(float(QMAX[bits]), dtype=torch.float32,
                        device=grad.device)
    tiny = torch.tensor(1e-30, dtype=torch.float32, device=grad.device)
    amax = torch.stack([grad.abs().max(), hess.abs().max()])
    if group is not None:
        from .collectives import record_pmax
        amax = record_pmax(amax, group)
    return (torch.maximum(amax, tiny) / qmax).to(torch.float32)


def quantize_gh(grad: torch.Tensor, hess: torch.Tensor,
                scales: torch.Tensor, bits: int, seed: int,
                row_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_grad, q_hess) int32 on the signed grid, clipped to +-QMAX, with
    distinct dither streams per channel."""
    qmax = QMAX[bits]
    seed = int(seed) & _M32
    qg = stochastic_round(grad / scales[0], seed, row_offset)
    qh = stochastic_round(hess / scales[1], seed ^ 0x9E3779B9, row_offset)
    return qg.clamp(-qmax, qmax), qh.clamp(-qmax, qmax)


def encode_channels(qg: torch.Tensor, qh: torch.Tensor, w01: torch.Tensor,
                    bits: int) -> List[torch.Tensor]:
    """int8 channel rows: bits=8 [g, h, w]; bits=16 [g_hi, g_lo', h_hi,
    h_lo', w] with the 128*w recentering (zero-weight rows encode zero)."""
    w8 = (w01 > 0).to(torch.int8)
    if bits == 8:
        return [qg.to(torch.int8), qh.to(torch.int8), w8]
    w32 = w8.to(torch.int32)

    def split(q):
        hi = torch.div(q, 256, rounding_mode="floor")
        lo = q - 256 * hi - 128 * w32
        return hi.to(torch.int8), lo.to(torch.int8)
    g_hi, g_lo = split(qg)
    h_hi, h_lo = split(qh)
    return [g_hi, g_lo, h_hi, h_lo, w8]


def decode_sums(planes: List[torch.Tensor], scales: torch.Tensor,
                bits: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(grad, hess, count) f32 sums from the int32 accumulator planes. The
    16-bit hi/lo recombination happens in f32 (``hi_sum * 256`` is exact
    below 2^24; in int32 it would overflow at ~65K rows per bin)."""
    f32 = torch.float32
    if bits == 8:
        return (planes[0].to(f32) * scales[0], planes[1].to(f32) * scales[1],
                planes[2].to(f32))
    w = planes[4].to(f32)
    g = (planes[0].to(f32) * 256.0 + planes[1].to(f32) + 128.0 * w) \
        * scales[0]
    h = (planes[2].to(f32) * 256.0 + planes[3].to(f32) + 128.0 * w) \
        * scales[1]
    return g, h, w
