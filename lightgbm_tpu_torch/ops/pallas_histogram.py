"""The slot-keyed histogram of the frontier-v1 engine (and, unrounded, of
the XLA engine: ``ops/histogram.py``).

PyTorch counterpart of ``lightgbm_tpu/ops/pallas_histogram.py`` (the
module keeps the JAX module's name so a reader finds the counterpart; it
holds no Pallas). The TPU kernel ``_hist_kernel`` becomes five CUDA
kernels (``csrc/hist_pass.cu``, ``fused_level.HIST_KERNELS``: per-slot
row counts, their scan, slot buckets, shared-memory tiles, a fixed-order
reduce) behind :func:`hist_pass`, with its plain PyTorch version
:func:`hist_pass_plain` beside it and plain versions of the stages
(:func:`hist_bucket_plain`, :func:`hist_tiles_plain`,
:func:`hist_reduce_plain`). On a CPU tensor the wrapper runs the plain
version; on a CUDA tensor it launches the kernels or raises.

Contract (``pallas_histogram.py:60-132``): for every row r whose slot
``row_slot[r] = s`` lies in [0, Sp), every feature f < Fp and channel
ch < nch, ``out[ch, s, f, bins[r, f]] += v[r, ch]``, with
``Sp = round_up(max(S, 8), 8)``:

- f32 variant: ``v = bf16(gh[r, ch])`` (round to nearest even, as the TPU
  kernel's ``gh.astype(bfloat16)``), summed in f32. This rounding of g, h
  and w is part of the frontier engine's numbers;
- quant variant: ``v`` is an int8 channel from
  :func:`ops.quantize.encode_channels`, summed exactly in int32;
- unrounded f32 variant (``unrounded=True``, nch <= 3): ``v = gh[r, ch]``
  as given, summed in f32: the XLA engine's ``build_histograms``
  (``lightgbm_tpu/ops/histogram.py:71``), which sums its f32 channels as
  they are. Its records on the card are ``(g, h, w, row)``, 16 bytes.

Rows with slot -1 add nothing whatever their gh. Layouts: ``bins_i32``
[R, Fp] int32 row-major (feature-padded so ``Fp * Bp % 128 == 0``),
``row_slot`` [R] int32, ``gh`` [R, nch] f32 or int8, out [nch, Sp, Fp, Bp]
f32 or int32. Any R.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from . import quantize
from .fused_level import (HIST_KERNELS, _count_kernels, _raise_on,
                          _require_cuda, _stream, launches)
from .layout import feature_layout

NUM_CH = 3


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_feature_layout(num_features: int, max_bin: int) -> Tuple[int, int]:
    """(Fp, Bp) with Bp = pow2 >= max_bin and (Fp * Bp) % 128 == 0: the
    layout contract shared with the fused kernels (``ops/layout.py``)."""
    return feature_layout(num_features, max_bin)


def _check(bins_i32, gh, row_slot, S, Bp, nch, quant,
           unrounded=False) -> Tuple[int, int, int]:
    if quant and unrounded:
        raise ValueError("quant and unrounded exclude each other")
    if unrounded and nch > 3:
        raise ValueError(f"the unrounded f32 variant takes nch <= 3; got "
                         f"{nch}")
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
                    quant: bool = False,
                    unrounded: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`hist_pass`: one ``index_add_`` of
    every (slotted row, feature) pair's channels into a flat
    [Sp*Fp*Bp, nch] buffer — exact int32 sums, or the f32 channels (bf16-
    rounded, or as given when ``unrounded``) summed in float64 and rounded
    once to f32."""
    R, Fp = bins_i32.shape
    Sp = _round_up(max(S, 8), 8)
    dev = bins_i32.device
    acc = torch.int32 if quant else torch.float64
    rows = torch.nonzero((row_slot >= 0) & (row_slot < Sp)).squeeze(1)
    s = row_slot[rows].long()
    b = bins_i32[rows].long()                                     # [n, Fp]
    vals = _values(gh[rows], quant, unrounded)                    # [n, nch]
    cell = (s[:, None] * Fp + torch.arange(Fp, device=dev)) * Bp + b
    ok = (b >= 0) & (b < Bp)
    out = torch.zeros((Sp * Fp * Bp, nch), dtype=acc, device=dev)
    src = vals[:, None, :].expand(-1, Fp, -1).to(acc)
    out.index_add_(0, cell[ok], src[ok])
    out = out if quant else out.to(torch.float32)
    return out.t().reshape(nch, Sp, Fp, Bp)


def _values(gh: torch.Tensor, quant: bool,
            unrounded: bool = False) -> torch.Tensor:
    """The channel values the histogram adds: int8 widened to int32, f32
    rounded to bf16 (nearest even) and back, or (``unrounded``) f32 as
    given."""
    if quant:
        return gh.to(torch.int32)
    return gh if unrounded else gh.to(torch.bfloat16).float()


def _variant(quant: bool, unrounded: bool) -> int:
    """The C entries' variant code: 0 f32 (bf16-rounded), 1 int8, 2
    unrounded f32."""
    return 1 if quant else 2 if unrounded else 0


# ------------------------------------------- the card's stages, plainly
# On the card hist_pass is five CUDA kernels (``fused_level.HIST_KERNELS``,
# ``csrc/hist_pass.cu``): count the live rows per slot and block, scan the
# counts into bucket offsets, write the rows into slot buckets, add each
# block's share of the bucketed rows into per-slot partial slices, and
# reduce the slices. The three plain versions below model the buckets, the
# slices and the reduce; composed they give hist_pass_plain (exactly for
# int32 sums and the f32 weight channel).

def hist_bucket_plain(gh: torch.Tensor, row_slot: torch.Tensor, *, S: int,
                      quant: bool = False):
    """(slot_off [Sp+1] int32, brow [n] int32): the rows that add anything
    (slot in [0, Sp), a channel non-zero as the histogram takes it) in
    bucket order — by slot, then by row, the card's fixed order — and
    where each slot's bucket starts (slot_off[Sp] = n)."""
    Sp = _round_up(max(S, 8), 8)
    live = ((row_slot >= 0) & (row_slot < Sp)
            & (_values(gh, quant) != 0).any(1))
    rows = torch.nonzero(live).squeeze(1)
    slots = row_slot[rows].long()
    brow = rows[torch.sort(slots, stable=True).indices].to(torch.int32)
    counts = torch.bincount(slots, minlength=Sp)
    slot_off = torch.zeros(Sp + 1, dtype=torch.int64, device=gh.device)
    slot_off[1:] = torch.cumsum(counts, 0)
    return slot_off.to(torch.int32), brow


def _share(n: int, blocks: int) -> int:
    """Bucketed rows per tile block: each block x takes [x*share,
    (x+1)*share) of the n (at least 1, so an empty bucket divides)."""
    return max(1, -(-n // blocks))


def hist_tiles_plain(bins_i32: torch.Tensor, gh: torch.Tensor,
                     brow: torch.Tensor, slot_off: torch.Tensor, *, Bp: int,
                     nch: int, blocks: int,
                     quant: bool = False) -> torch.Tensor:
    """The partial slices [blocks + Sp - 1, nch, Fp, Bp]: ``blocks`` blocks
    take even shares of the bucketed rows, and block x adds its rows of
    slot k into slice x + k (a slice no block holds rows for stays 0)."""
    R, Fp = bins_i32.shape
    Sp = slot_off.numel() - 1
    dev = bins_i32.device
    n = brow.numel()
    e = torch.arange(n, device=dev)
    k = torch.searchsorted(slot_off[1:].long(), e, right=True)
    sl = e // _share(n, blocks) + k
    rows = brow.long()
    b = bins_i32[rows].long()                                     # [n, Fp]
    cell = (sl[:, None] * Fp + torch.arange(Fp, device=dev)) * Bp + b
    ok = (b >= 0) & (b < Bp)
    src = _values(gh[rows], quant)[:, None, :].expand(-1, Fp, -1)
    part = torch.zeros(((blocks + Sp - 1) * Fp * Bp, nch),
                       dtype=torch.int32 if quant else torch.float32,
                       device=dev)
    part.index_add_(0, cell[ok], src[ok])
    return part.reshape(blocks + Sp - 1, Fp, Bp, nch).permute(0, 3, 1, 2)


def hist_reduce_plain(part: torch.Tensor, slot_off: torch.Tensor, *,
                      blocks: int) -> torch.Tensor:
    """out [nch, Sp, Fp, Bp]: slot k's cells are the sum, in block order,
    of slices x + k of the blocks x that hold rows of slot k (none: 0)."""
    Sp = slot_off.numel() - 1
    off = [int(v) for v in slot_off]
    share = _share(off[-1], blocks)
    out = part.new_zeros((part.shape[1], Sp) + tuple(part.shape[2:]))
    for k in range(Sp):
        if off[k + 1] > off[k]:
            for x in range(off[k] // share, (off[k + 1] - 1) // share + 1):
                out[:, k] += part[x + k]
    return out


# --------------------------------------------------------- on the card
HIST_WINDOW = 512     # slots per launch of the card's kernels


@functools.lru_cache(maxsize=64)
def _hist_plan(dev_index: int, R: int, Fp: int, Bp: int, Sw: int, nch: int,
               variant: int) -> Tuple[int, ...]:
    """(cnt int32s, record bytes, partial elements, tile blocks, channels
    per tile block, adding warps, channel pack bytes) of one window of Sw
    slots."""
    import ctypes
    from .cuda_build import library
    sizes = (ctypes.c_longlong * 7)()
    with torch.cuda.device(dev_index):
        _raise_on(library().lgbt_hist_plan(R, Fp, Bp, Sw, nch, variant,
                                           sizes), "hist_pass")
    return tuple(sizes)


def hist_buffers(bins_i32: torch.Tensor, *, S: int, Bp: int, nch: int,
                 quant: bool = False,
                 unrounded: bool = False) -> Dict[str, object]:
    """The output and scratch of one :func:`hist_pass` call on the card,
    sized for its widest window: the per-block slot counts and their scan,
    the slot offsets, the bucketed rows' records (channel pack, then row
    index), the tile blocks' partial slices; and the tile kernel's
    shape."""
    R, Fp = bins_i32.shape
    dev = bins_i32.device
    Sp = _round_up(max(S, 8), 8)
    Sw = min(Sp, HIST_WINDOW)
    n_cnt, rec, n_part, blocks, cn, warps, pack = _hist_plan(
        dev.index or 0, R, Fp, Bp, Sw, nch, _variant(quant, unrounded))
    acc = torch.int32 if quant else torch.float32

    def empty(n, dtype):
        return torch.empty(max(n, 1), dtype=dtype, device=dev)
    return {"out": torch.empty((nch, Sp, Fp, Bp), dtype=acc, device=dev),
            "cnt": empty(n_cnt, torch.int32),
            "off": empty(n_cnt, torch.int32),
            "slot_off": empty(Sw + 1, torch.int32),
            "recs": empty(R * rec // 4, torch.int32), "rec": rec,
            "pack": pack,
            "part": empty(n_part, acc), "blocks": blocks,
            "channels_per_block": cn, "warps": warps}


def bucket_rows(buf: Dict[str, object], n: int) -> torch.Tensor:
    """The row indices of the first n bucketed records of ``buf``."""
    words = buf["rec"] // 4
    return buf["recs"][:n * words].view(n, words)[:, buf["pack"] // 4]


def _hist_launch(kernels, bins_i32, gh, row_slot, buf, *, Bp: int,
                 nch: int, quant: bool, lo: int = 0,
                 unrounded: bool = False) -> None:
    """Launch the CUDA kernels named in ``kernels`` (of HIST_KERNELS; a
    later one reads what ``buf`` holds from the earlier) for the window of
    slots [lo, lo + HIST_WINDOW) on the current stream, and count those
    the C entry reports launched."""
    import ctypes
    from .cuda_build import library
    R, Fp = bins_i32.shape
    Sp = buf["out"].shape[1]
    stages = sum(1 << HIST_KERNELS.index(k) for k in kernels)
    done = ctypes.c_int(0)
    rc = library().lgbt_hist_pass(
        bins_i32.data_ptr(), gh.data_ptr(), row_slot.data_ptr(),
        buf["out"].data_ptr(), buf["cnt"].data_ptr(),
        buf["off"].data_ptr(), buf["slot_off"].data_ptr(),
        buf["recs"].data_ptr(), buf["part"].data_ptr(), R, Fp, Bp, Sp, lo,
        min(HIST_WINDOW, Sp - lo), nch, _variant(quant, unrounded), stages,
        _stream(bins_i32.device), ctypes.byref(done))
    _count_kernels(HIST_KERNELS, done.value)
    _raise_on(rc, "hist_pass")


def hist_pass(bins_i32: torch.Tensor, gh: torch.Tensor,
              row_slot: torch.Tensor, *, S: int, Bp: int, nch: int,
              quant: bool = False, unrounded: bool = False) -> torch.Tensor:
    """The slot-keyed histogram (module docstring): [nch, Sp, Fp, Bp] f32,
    or int32 when ``quant``; ``unrounded`` takes the f32 channels as given.
    On the card: the five kernels of ``HIST_KERNELS`` per window of up to
    ``HIST_WINDOW`` slots, any Bp."""
    R, Fp, Sp = _check(bins_i32, gh, row_slot, S, Bp, nch, quant, unrounded)
    if bins_i32.device.type == "cpu":
        return hist_pass_plain(bins_i32, gh, row_slot, S=S, Bp=Bp, nch=nch,
                               quant=quant, unrounded=unrounded)
    _require_cuda(bins_i32, gh, row_slot)
    buf = hist_buffers(bins_i32, S=S, Bp=Bp, nch=nch, quant=quant,
                       unrounded=unrounded)
    for lo in range(0, Sp, HIST_WINDOW):
        _hist_launch(HIST_KERNELS, bins_i32, gh, row_slot, buf, Bp=Bp,
                     nch=nch, quant=quant, lo=lo, unrounded=unrounded)
    launches["hist_pass"] += 1
    return buf["out"]


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
