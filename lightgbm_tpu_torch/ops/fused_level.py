"""Fused per-level route + histogram pass, the per-row table lookup, and
the fused boosting epilogue.

PyTorch counterpart of ``lightgbm_tpu/ops/fused_level.py``. The layouts and
contracts are the JAX package's, so the same inputs give the same outputs:

- ``bins_T`` [Fp, Rp] int8 (int16 when Bp > 128), feature-major;
- ``leaf_T`` [1, Rp] int32, -1 on padding rows;
- ``gh_T`` [8, Rp] bfloat16 from :func:`pack_gh` (g_hi, g_lo, h_hi, h_lo, w
  for nch=5; g, h, w for nch=3);
- ``W`` [Sp, F_oh*Bp] bfloat16 0/1 route table from :func:`build_route_table`;
- ``tbl`` [Sp, 128] int32: col 0 leaf_of_slot (-2 inactive), col 1
  right_delta, col 2 small_is_left.

The histogram-plane cuts change three things, each independently:

- ``quant_bits`` 8 or 16 (``tpu_quantized_grad``): ``gh_T`` is the int8
  block of :func:`pack_gh_quant` and the histogram sums it in int32,
  exactly (integer sums do not depend on order);
- ``packed`` (``tpu_adaptive_bins``, ``ops/layout.PackedLayout``):
  ``bins_T``'s rows are in ``packed.feat_order`` and the flat axis is
  ``packed.fb`` wide; kernel row ``j``'s slab starts at
  ``packed.flat_offsets[j]`` (:func:`pack_route_table`,
  :func:`unpack_packed_flat`);
- ``fmask`` (``tpu_gain_screening``): a per-logical-feature [F_oh] bool
  mask; a masked feature's one-hot slab is zeroed, so it adds nothing to
  the histogram and nothing to the routing sum.

Four kernels, each written by hand in CUDA C++ for sm_90a
(``lightgbm_tpu_torch/csrc``): :func:`level_pass`, :func:`route_pass`,
:func:`table_lookup` and :func:`epilogue_pass`. Each wrapper checks its
inputs, allocates its outputs and scratch, launches on the current stream
without synchronising and counts the call in ``launches`` (and the cuts it
ran with in ``variant_launches``) and each CUDA kernel it launched in
``cuda_launches``. ``level_pass`` runs three stages per call: mark (route
+ smaller-child slot + per-(slot, block) counts and their scan; three CUDA
kernels, the first of which finds each slot's split slab in W), partition
(each marked row's bins and channels copied, as one staging record, into
its slot's bucket in row order) and the histogram over the records
(private per-warp tiles in bin groups, summed in a fixed order: two CUDA
kernels), so its f32 sums are the same bits on every call; each stage
also has a wrapper of its own (:func:`level_mark`, :func:`level_partition`,
:func:`level_hist`). Bundled layouts (EFB, ``ops/efb.py``) are kernel rows
of bundle columns: :func:`build_route_table_bundled` writes their route
tables and :func:`bundle_plane_views` decodes their histograms; no kernel
limits the slab width. :func:`route_pass` is two CUDA kernels (the slab table
of W, then the route reading one bin and one W entry per routed row) and
:func:`epilogue_pass` four (the slab table; route, score, gradients and
pack; the root histogram's per-block partials; their reduce), each stage
with a plain version of its own (:func:`slab_table_plain`,
:func:`route_slabs_plain`, :func:`epilogue_rows_plain`,
:func:`root_hist_plain`). On a CPU tensor a wrapper runs the plain PyTorch
version beside it (``*_plain``), which the CPU tests hold against the JAX
package; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from . import quantize
from .layout import PackedLayout

NCH_PRECISE = 5   # g_hi, g_lo, h_hi, h_lo, w
NCH_FAST = 3      # g, h, w
MAX_SLOTS = 128
TBL_COLS = 128

# launches of each kernel since the last reset (CPU calls never count);
# ``hist_pass`` is counted by ops/pallas_histogram.py
launches: Dict[str, int] = {"level_pass": 0, "route_pass": 0,
                            "table_lookup": 0, "epilogue_pass": 0,
                            "hist_pass": 0}


def variant_name(quant_bits: int = 0, packed: bool = False,
                 fmask: bool = False) -> str:
    """The histogram-plane cuts a pass runs with, e.g. ``quant16+packed+
    fmask``; ``f32`` for none (the padded f32 pass)."""
    cuts = ([f"quant{quant_bits}"] if quant_bits else []) \
        + ["packed"] * bool(packed) + ["fmask"] * bool(fmask)
    return "+".join(cuts) or "f32"


# launches of the histogram-plane variants among those, each under the
# exact combination of cuts it ran with
variant_launches: Dict[str, int] = dict.fromkeys(
    ["level_pass:" + variant_name(q, p, m) for q in (0, 8, 16)
     for p in (False, True) for m in (False, True) if q or p or m]
    + ["route_pass:packed"], 0)
EPILOGUE_KINDS = ("binary", "l2")
# the stages of level_pass, in order, and the CUDA kernels of each
LEVEL_STAGES = ("level_mark", "level_partition", "level_hist")
STAGE_KERNELS = {"level_mark": ("level_slabs", "level_mark", "level_scan"),
                 "level_partition": ("level_partition",),
                 "level_hist": ("level_tiles", "level_reduce")}
LEVEL_KERNELS = sum(STAGE_KERNELS.values(), ())
# the CUDA kernels of route_pass (slab table, route) and of epilogue_pass
# (slab table; route, score, gradients and pack; each block's partial root
# histogram; the reduce of the partials), in launch order
ROUTE_KERNELS = ("route_slabs", "route_pass")
EPILOGUE_KERNELS = ("epilogue_slabs", "epilogue_pass", "epilogue_hist",
                    "epilogue_reduce")
# the CUDA kernels of hist_pass (ops/pallas_histogram.py), in launch order:
# per-block slot counts, their scan into bucket offsets, the slot buckets,
# the per-warp tiles' partial slices, their reduce into the output
HIST_KERNELS = ("hist_count", "hist_scan", "hist_bucket", "hist_tiles",
                "hist_reduce")
# CUDA kernel launches since the last reset, by kernel, as the C entries
# report them: a level_pass call launches each of LEVEL_KERNELS once, a
# route_pass call each of ROUTE_KERNELS, an epilogue_pass call each of
# EPILOGUE_KERNELS, a hist_pass call each of HIST_KERNELS once per window
# of slots (one up to 512 slots), table_lookup its one kernel
cuda_launches: Dict[str, int] = dict.fromkeys(
    LEVEL_KERNELS + ROUTE_KERNELS + ("table_lookup",) + EPILOGUE_KERNELS
    + HIST_KERNELS, 0)
# bytes of a block's opt-in shared memory left to the level_tiles kernel's
# static arrays (the slot offsets); the rest holds its histogram tiles
HIST_STATIC_SMEM = 2048
# rows per block of the level mark and partition kernels (kMarkRows), and
# the fewest records worth a block of the level tiles kernel
MARK_ROWS = 2048
MIN_TILE_ROWS = 512
# the slab table's codes for a W row non-zero on no slab or on several
SLAB_NONE, SLAB_MANY = -1, -2


def reset_launch_counts() -> None:
    for counts in (launches, variant_launches, cuda_launches):
        for k in counts:
            counts[k] = 0


def max_slot_cap(FB: int, nch: int, budget: int = 4 * 1024 * 1024) -> int:
    """Largest per-level slot count whose [FB, nch*Sp] f32 histogram fits in
    ``budget`` bytes (the JAX package's level schedule; kept so both
    packages grow the same levels)."""
    cap = budget // (FB * nch * 4)
    cap = 1 << max(3, int(cap).bit_length() - 1)
    return int(min(128, cap))


def pack_gh(grad: torch.Tensor, hess: torch.Tensor, weight: torch.Tensor,
            nch: int) -> torch.Tensor:
    """[8, R] bfloat16 channel block (round-to-nearest-even, as XLA).

    nch=5: g_hi, g_lo, h_hi, h_lo, w  (hi/lo bf16 split => fp32-grade sums)
    nch=3: g, h, w. Rows beyond nch are zero.
    """
    bf = torch.bfloat16
    z = torch.zeros_like(grad, dtype=bf)
    if nch == NCH_PRECISE:
        g_hi = grad.to(bf)
        g_lo = (grad - g_hi.float()).to(bf)
        h_hi = hess.to(bf)
        h_lo = (hess - h_hi.float()).to(bf)
        rows = [g_hi, g_lo, h_hi, h_lo, weight.to(bf), z, z, z]
    else:
        rows = [grad.to(bf), hess.to(bf), weight.to(bf), z, z, z, z, z]
    return torch.stack(rows, 0)


def pack_gh_quant(grad: torch.Tensor, hess: torch.Tensor,
                  weight: torch.Tensor, bits: int, seed: int,
                  row_offset: int = 0,
                  group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized sibling of :func:`pack_gh` (``tpu_quantized_grad``):
    ([8, R] int8 channel block, [2] f32 scales). bits=8 packs (g, h, w);
    bits=16 the hi/lo split (g_hi, g_lo, h_hi, h_lo, w) of
    ``ops/quantize.py``. ``weight`` is a 0/1 in-bag mask; zero-weight rows
    encode exactly zero. Under a data-parallel ``group`` the scales are the
    group's and the dither hashes global rows (``row_offset``: this rank's
    first global row)."""
    scales = quantize.quant_scales(grad, hess, bits, group)
    qg, qh = quantize.quantize_gh(grad, hess, scales, bits, seed,
                                  row_offset)
    rows = quantize.encode_channels(qg, qh, weight, bits)
    z = torch.zeros_like(rows[0])
    return torch.stack(rows + [z] * (8 - len(rows)), 0), scales


_layout_cache: Dict[Tuple[PackedLayout, str], Dict[str, torch.Tensor]] = {}


def layout_tensors(packed: PackedLayout,
                   device) -> Dict[str, torch.Tensor]:
    """The packed layout's index maps as tensors on ``device``, made once
    per (layout, device): ``ktab`` [2, K] int32 (each kernel row's flat
    offset, then its slab width — the kernels' table), ``order`` [K] (the
    logical feature of each kernel row), and the flat maps of
    ops/layout.py."""
    key = (packed, str(torch.device(device)))
    if key not in _layout_cache:
        def t(a, dt=torch.int64):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)
        _layout_cache[key] = {
            "ktab": t(np.stack([packed.flat_offsets,
                                np.asarray(packed.widths, np.int64)]),
                      torch.int32).contiguous(),
            "order": t(packed.feat_order),
            "packed_to_padded": t(packed.packed_to_padded),
            "packed_valid": t(packed.packed_valid, torch.bool),
            "padded_to_packed": t(packed.padded_to_packed),
            "padded_valid": t(packed.padded_valid, torch.bool),
            "feat_of_packed": t(packed.feat_of_packed)}
    return _layout_cache[key]


def pack_route_table(W: torch.Tensor, packed: PackedLayout) -> torch.Tensor:
    """Padded-layout route table [Sp, F_oh*Bp] -> packed layout
    [Sp, packed.fb] (class-padding columns zero)."""
    lt = layout_tensors(packed, W.device)
    Wp = W[:, lt["packed_to_padded"]]
    return torch.where(lt["packed_valid"][None, :], Wp,
                       torch.zeros((), dtype=W.dtype, device=W.device))


def unpack_packed_flat(hist: torch.Tensor,
                       packed: PackedLayout) -> torch.Tensor:
    """[packed.fb, X] kernel histogram -> [F_oh*Bp, X] padded flat layout
    (an exact gather: the per-(feature, bin) sums are the padded layout's,
    re-indexed)."""
    lt = layout_tensors(packed, hist.device)
    out = hist[lt["padded_to_packed"]]
    return torch.where(lt["padded_valid"][:, None], out,
                       torch.zeros((), dtype=hist.dtype,
                                   device=hist.device))


def expand_feature_mask(fm: torch.Tensor, F_oh: int, B: int,
                        packed: PackedLayout = None) -> torch.Tensor:
    """Per-feature bool mask [F_oh] -> per-flat-position bool [FB] in the
    kernel layout (class and feature padding positions False)."""
    if packed is None:
        return fm[:F_oh].repeat_interleave(B)
    lt = layout_tensors(packed, fm.device)
    return fm[lt["feat_of_packed"]] & lt["packed_valid"]


def hist_planes(hist: torch.Tensor, nch: int, Sp: int, F_oh: int, B: int,
                packed: PackedLayout = None, quant_bits: int = 0,
                scales: torch.Tensor = None):
    """[FB, nch*Sp] kernel output -> (grad, hess, cnt) planes [Sp, F_oh, B]
    in float32 (hi/lo recombined when nch=5). ``packed`` re-indexes a
    packed-layout histogram onto the padded layout first (exact);
    ``quant_bits`` decodes the int32 sums through the one f32 rescale
    (``ops/quantize.decode_sums``)."""
    if packed is not None:
        hist = unpack_packed_flat(hist, packed)

    def plane(c):
        return hist[:, c * Sp:(c + 1) * Sp]
    if quant_bits:
        g, h, c = quantize.decode_sums(
            [plane(i) for i in range(quantize.QNCH[quant_bits])], scales,
            quant_bits)
    elif nch == NCH_PRECISE:
        g = plane(0) + plane(1)
        h = plane(2) + plane(3)
        c = plane(4)
    else:
        g, h, c = plane(0), plane(1), plane(2)

    def to(x):
        return x.t().reshape(Sp, F_oh, B)
    return to(g), to(h), to(c)


def build_route_table(feature: torch.Tensor, threshold: torch.Tensor,
                      default_left: torch.Tensor, num_bin: torch.Tensor,
                      missing_type: torch.Tensor, default_bin: torch.Tensor,
                      Sp: int, F_oh: int, B: int,
                      cat_flag: torch.Tensor = None,
                      cat_mask: torch.Tensor = None) -> torch.Tensor:
    """W [Sp, F_oh*B] bfloat16: W[k, f*B+b] = 1 iff a row with bin b of
    feature f goes LEFT under slot k's split. Missing bins ride
    default_left (ref: src/io/dense_bin.hpp Split); feature=-1 rows are
    all-zero (inactive slot). ``num_bin``/``missing_type``/``default_bin``
    are per-feature [F] with F <= F_oh. A categorical slot (``cat_flag``
    [Sp]) sends left exactly the bins of its ``cat_mask`` [Sp, B] row, an
    arbitrary set (lightgbm_tpu/ops/fused_level.py:280-318)."""
    dev = feature.device
    F = num_bin.shape[0]
    f_iota = torch.arange(F_oh, dtype=torch.int32, device=dev)[None, :, None]
    b_iota = torch.arange(B, dtype=torch.int32, device=dev)[None, None, :]

    def pad(a):
        out = torch.zeros(F_oh, dtype=torch.int32, device=dev)
        out[:F] = a
        return out[None, :, None]
    nb, mt, db = pad(num_bin), pad(missing_type), pad(default_bin)
    feat = feature[:, None, None]
    thr = threshold[:, None, None]
    dl = default_left[:, None, None]
    is_missing = (((mt == 1) & (b_iota == db))
                  | ((mt == 2) & (b_iota == nb - 1)))
    go_left = torch.where(is_missing, dl, b_iota <= thr)
    if cat_flag is not None:
        go_left = torch.where(cat_flag[:, None, None], cat_mask[:, None, :],
                              go_left)
    w = (f_iota == feat) & go_left & (feat >= 0)
    return w.reshape(Sp, F_oh * B).to(torch.bfloat16)


def build_route_table_bundled(feature: torch.Tensor, threshold: torch.Tensor,
                              default_left: torch.Tensor,
                              num_bin: torch.Tensor,
                              missing_type: torch.Tensor,
                              default_bin: torch.Tensor,
                              most_freq_bin: torch.Tensor,
                              col_of_feat: torch.Tensor,
                              offset_of_feat: torch.Tensor,
                              C_cols: int, Bp: int,
                              cat_flag: torch.Tensor = None,
                              cat_mask: torch.Tensor = None) -> torch.Tensor:
    """W [Sp, C_cols*Bp] bfloat16 for logical splits over EFB bundle
    columns (lightgbm_tpu/ops/fused_level.py:323-371). A bundle bin bb of
    column c decodes to logical feature f's bin ``bb - offset_f`` inside
    f's window and to f's most-frequent bin outside it (rows default in
    every member share bundle bin 0, ops/efb.py), so the owning column's
    row is non-zero wherever that decoded bin goes left — one slab per W
    row, other columns zero. Missing bins and categorical sets
    (``cat_mask`` [Sp, B_logical]) apply to the DECODED bin."""
    dev = feature.device
    Sp = feature.shape[0]
    c_iota = torch.arange(C_cols, dtype=torch.int32, device=dev)[None, :, None]
    b_iota = torch.arange(Bp, dtype=torch.int32, device=dev)[None, None, :]
    fs = feature.clamp(min=0).long()

    def per_slot(a):
        return a[fs][:, None, None]
    nb, mt, db = per_slot(num_bin), per_slot(missing_type), \
        per_slot(default_bin)
    mfb, col, off = per_slot(most_freq_bin), per_slot(col_of_feat), \
        per_slot(offset_of_feat)
    thr = threshold[:, None, None]
    dl = default_left[:, None, None]
    in_window = (b_iota >= off) & (b_iota < off + nb)
    logical_bin = torch.where(in_window, b_iota - off, mfb)
    is_missing = (((mt == 1) & (logical_bin == db))
                  | ((mt == 2) & (logical_bin == nb - 1)))
    go_left = torch.where(is_missing, dl, logical_bin <= thr)
    if cat_flag is not None:
        B = cat_mask.shape[1]
        lb = logical_bin.clamp(0, B - 1).long()
        cat_left = cat_mask[torch.arange(Sp, device=dev)[:, None, None], lb]
        go_left = torch.where(cat_flag[:, None, None], cat_left, go_left)
    w = (c_iota == col) & go_left & (feature[:, None, None] >= 0)
    return w.reshape(Sp, C_cols * Bp).to(torch.bfloat16)


def bundle_plane_views(plane: torch.Tensor, flat_idx: torch.Tensor,
                       valid: torch.Tensor,
                       default_bin: torch.Tensor) -> torch.Tensor:
    """Bundle histogram -> logical per-feature view with the FixHistogram
    residual on each feature's most-frequent bin (ref:
    src/io/dataset.cpp:1265; lightgbm_tpu/ops/fused_level.py:373-399).

    plane: [Sp, C_cols, Bp] or [Sp, C_cols, Bp, ch]; returns the same rank
    with (C_cols, Bp) -> (F, B). Slot totals come from column 0 — every
    row lands in some bin of every column. Padding features (no valid
    bins) stay all-zero."""
    squeeze = plane.dim() == 3
    if squeeze:
        plane = plane[..., None]
    Sp, C, Bp, ch = plane.shape
    F, B = flat_idx.shape
    flat = plane.reshape(Sp, C * Bp, ch)
    view = flat[:, flat_idx.reshape(-1).long()].reshape(Sp, F, B, ch)
    view = torch.where(valid[None, :, :, None], view,
                       torch.zeros((), dtype=view.dtype, device=view.device))
    totals = plane[:, 0].sum(1)                                 # [Sp, ch]
    residual = totals[:, None, :] - view.sum(2)                 # [Sp, F, ch]
    residual = residual * valid.any(1)[None, :, None].to(residual.dtype)
    out = view.clone()
    out[torch.arange(Sp, device=plane.device)[:, None],
        torch.arange(F, device=plane.device)[None, :],
        default_bin.long()[None, :]] += residual
    return out[..., 0] if squeeze else out


# ---------------------------------------------------------------- checks
def _check_route_inputs(bins_T, leaf_T, W, tbl, num_bins, f_oh,
                        packed=None):
    if bins_T.dim() != 2 or bins_T.dtype not in (torch.int8, torch.int16):
        raise ValueError("bins_T must be a 2-D int8 or int16 tensor; got "
                         f"{tuple(bins_T.shape)} {bins_T.dtype}")
    if bins_T.dtype == torch.int8 and num_bins > 128:
        raise ValueError("int8 bins hold at most 128 bins; use int16")
    Fp, Rp = bins_T.shape
    if Fp < f_oh:
        raise ValueError(f"bins_T has {Fp} feature rows, f_oh={f_oh}")
    if tuple(leaf_T.shape) != (1, Rp) or leaf_T.dtype != torch.int32:
        raise ValueError("leaf_T must be [1, Rp] int32")
    Sp = tbl.shape[0]
    if tbl.dim() != 2 or tbl.shape[1] != TBL_COLS \
            or tbl.dtype != torch.int32:
        raise ValueError("tbl must be [Sp, 128] int32")
    if not 1 <= Sp <= MAX_SLOTS:
        raise ValueError(f"Sp={Sp} outside [1, {MAX_SLOTS}]")
    if packed is not None:
        _check_packed(packed, num_bins, f_oh)
    FB = packed.fb if packed is not None else f_oh * num_bins
    if tuple(W.shape) != (Sp, FB) or W.dtype != torch.bfloat16:
        raise ValueError(f"W must be [{Sp}, {FB}] bfloat16")
    dev = bins_T.device
    for name, t in (("leaf_T", leaf_T), ("W", W), ("tbl", tbl)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, bins_T on {dev}")
    return Rp, Sp


def _check_packed(packed: PackedLayout, num_bins: int, f_oh: int) -> None:
    """A packed layout the kernels can take: one slab (offset, width) per
    kernel row, each inside [0, fb) and on the logical layout's f_oh/Bp."""
    K = len(packed.feat_order)
    if len(packed.widths) != K or sum(c for _, c in packed.classes) != K:
        raise ValueError(f"packed layout: {len(packed.widths)} slab widths "
                         f"and {sum(c for _, c in packed.classes)} class "
                         f"members for {K} kernel rows")
    if (packed.f_oh, packed.bp) != (f_oh, num_bins):
        raise ValueError(f"packed layout is for f_oh={packed.f_oh}, "
                         f"Bp={packed.bp}; got f_oh={f_oh}, Bp={num_bins}")
    if K > f_oh or packed.fb % 128 or (K and int(
            packed.flat_offsets[-1]) + packed.widths[-1] > packed.fb):
        raise ValueError("packed layout: slabs do not fit its flat width")


def _require_cuda(*tensors):
    for t in tensors:
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous CUDA tensors; "
                             f"got a {t.device} tensor "
                             f"(contiguous={t.is_contiguous()})")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


# ----------------------------------------------------------- plain versions
def _kernel_rows(num_bins, f_oh, packed):
    """(flat offset, slab width or None) of each kernel row: the padded
    layout's f*Bp with no width check, or the packed layout's table (a bin
    at or past its slab's width has no one-hot position there)."""
    if packed is None:
        return [(f * num_bins, None) for f in range(f_oh)]
    return [(int(o), int(w)) for o, w in zip(packed.flat_offsets,
                                             packed.widths)]


def _route_plain(bins_T, leaf_T, W, tbl, num_bins, f_oh, packed=None,
                 fmask=None):
    """(slot per row or -1, goes-left per row, new_leaf [1, Rp])."""
    Rp = bins_T.shape[1]
    leaf = leaf_T[0]
    lof = tbl[:, 0]
    member = leaf[None, :] == lof[:, None]                       # [Sp, Rp]
    hit = member.any(0)
    slot = torch.where(hit, member.to(torch.int8).argmax(0),
                       torch.full_like(leaf, -1, dtype=torch.int64))
    k = slot.clamp(min=0)
    FB = W.shape[1]
    Wf = W.float()
    if fmask is not None:       # a masked slab's one-hot is zero
        Wf = Wf * expand_feature_mask(fmask, f_oh, num_bins, packed)
    Wf = Wf.reshape(-1)
    D = torch.zeros(Rp, dtype=torch.float32, device=bins_T.device)
    for j, (off, width) in enumerate(_kernel_rows(num_bins, f_oh, packed)):
        b = bins_T[j].long()
        if width is None:
            D += Wf[k * FB + off + b]
        else:
            D += torch.where(b < width, Wf[k * FB + off + b.clamp(
                max=width - 1)], 0.0)
    left = D > 0.5
    delta = tbl[:, 1][k]
    new_leaf = torch.where(hit & ~left, leaf + delta, leaf)
    return slot, left, new_leaf[None, :].to(torch.int32)


def _smaller_child(slot, left, tbl):
    """Rows in an active slot's leaf, on the side of its smaller child."""
    small_left = tbl[:, 2] > 0
    return (slot >= 0) & (left == small_left[slot.clamp(min=0)])


def _hist_plain(bins, vals, k, fmask, *, Sp, FB, num_bins, f_oh, nch,
                quant_bits, packed):
    """[FB, nch*Sp] histogram of n rows — their bins [>=K, n] in kernel-row
    order, channels [nch, n], slots k [n] — by ``index_add_`` over the
    flat (slab offset + bin, ch*Sp + k) index: exact int32 sums, or f32
    channels summed in float64 and rounded once to f32 (an f32
    ``index_add_`` drifts from the exact sum where ~10^5 equal values meet
    in one cell)."""
    C = nch * Sp
    acc = torch.int32 if quant_bits else torch.float64
    dev = bins.device
    hist = torch.zeros(FB * C, dtype=acc, device=dev)
    vals = vals.to(acc)
    ch_off = (torch.arange(nch, device=dev) * Sp)[:, None]
    for j, (off, width) in enumerate(_kernel_rows(num_bins, f_oh, packed)):
        b = bins[j].long()
        v = vals
        if width is not None:
            v = vals * (b < width).to(acc)
            b = b.clamp(max=width - 1)
        cell = (off + b) * C + k                                   # [n]
        hist.index_add_(0, (cell[None, :] + ch_off).reshape(-1),
                        v.reshape(-1))
    hist = hist.reshape(FB, C)
    if fmask is not None:
        keep = expand_feature_mask(fmask, f_oh, num_bins, packed)
        hist = torch.where(keep[:, None], hist,
                           torch.zeros((), dtype=acc, device=hist.device))
    return hist if quant_bits else hist.to(torch.float32)


def level_pass_plain(bins_T, leaf_T, gh_T, W, tbl, fmask=None, *,
                     num_bins: int, f_oh: int, nch: int = NCH_PRECISE,
                     quant_bits: int = 0, packed: PackedLayout = None):
    """Plain PyTorch version of :func:`level_pass`: routing by gathering W
    at the row's slot, the smaller-child histogram by ``index_add_`` over
    the flat (slab offset + bin, ch*Sp + k) index — f32 sums of the bf16
    channels, or exact int32 sums of the int8 channels under
    ``quant_bits``; a masked feature's slab adds nothing."""
    slot, left, new_leaf = _route_plain(bins_T, leaf_T, W, tbl, num_bins,
                                        f_oh, packed, fmask)
    rows = torch.nonzero(_smaller_child(slot, left, tbl)).squeeze(1)
    hist = _hist_plain(bins_T[:, rows], gh_T[:nch, rows], slot[rows], fmask,
                       Sp=tbl.shape[0], FB=W.shape[1], num_bins=num_bins,
                       f_oh=f_oh, nch=nch, quant_bits=quant_bits,
                       packed=packed)
    return hist, new_leaf


def level_mark_plain(bins_T, leaf_T, gh_T, W, tbl, fmask=None, *,
                     num_bins: int, f_oh: int, nch: int = NCH_PRECISE,
                     quant_bits: int = 0, packed: PackedLayout = None):
    """Plain PyTorch version of :func:`level_mark` (stage 1 of
    :func:`level_pass`): (new_leaf [1, Rp] int32, row_slot [Rp] int8 — the
    slot of each smaller-child row with a non-zero channel, else -1 —,
    counts, the mark stage's int32 counts buffer: the marked rows of each
    (slot, block of MARK_ROWS rows) slot-major, their exclusive scan and
    the Sp + 1 slot offsets, 2 * Sp * nb + Sp + 1 words; :func:`slot_counts`
    reads the per-slot counts from it)."""
    slot, left, new_leaf = _route_plain(bins_T, leaf_T, W, tbl, num_bins,
                                        f_oh, packed, fmask)
    marked = _smaller_child(slot, left, tbl) & (gh_T[:nch] != 0).any(0)
    row_slot = torch.where(marked, slot, -1).to(torch.int8)
    Sp, nb = tbl.shape[0], -(-leaf_T.shape[1] // MARK_ROWS)
    rows = torch.nonzero(marked).squeeze(1)
    cnt = torch.bincount(slot[rows].long() * nb + rows // MARK_ROWS,
                         minlength=Sp * nb)
    off = torch.cumsum(cnt, 0) - cnt
    counts = torch.cat([cnt, off, off[::nb], cnt.sum()[None]])
    return new_leaf, row_slot, counts.to(torch.int32)


def slot_counts(counts: torch.Tensor, Rp: int) -> torch.Tensor:
    """[Sp] int32 marked rows per slot, the differences of the slot
    offsets in the mark stage's counts buffer (:func:`level_mark_plain`)
    over ``Rp`` rows."""
    nb = -(-Rp // MARK_ROWS)
    Sp = (counts.shape[0] - 1) // (2 * nb + 1)
    return torch.diff(counts[2 * Sp * nb:]).to(torch.int32)


def record_layout(K: int, bin_bytes: int, nch: int,
                  ch_bytes: int) -> Tuple[int, int]:
    """(channel offset, record bytes) of the staging records the partition
    stage writes, one per marked row: its K bins (kernel-row order) from
    byte 0, its nch channels from the next 4-byte boundary, zeros to a
    multiple of 16 bytes (48 B at K=28, int8 bins, nch=5 bf16)."""
    ch_off = -(-K * bin_bytes // 4) * 4
    return ch_off, -(-(ch_off + nch * ch_bytes) // 16) * 16


def _records(bins_T, gh_T, rows, K, nch):
    """[n, record bytes] uint8 staging records of ``rows``."""
    bb, cb = bins_T.element_size(), gh_T.element_size()
    ch_off, nbytes = record_layout(K, bb, nch, cb)
    out = torch.zeros((rows.numel(), nbytes), dtype=torch.uint8,
                      device=bins_T.device)
    out[:, :K * bb] = bins_T[:K, rows].t().contiguous().view(torch.uint8)
    out[:, ch_off:ch_off + nch * cb] = \
        gh_T[:nch, rows].t().contiguous().view(torch.uint8)
    return out


def _kernel_row_count(f_oh, packed):
    return f_oh if packed is None else len(packed.feat_order)


def partition_order_plain(row_slot, counts):
    """[Rp] int32: the marked rows grouped by slot, slot 0's bucket first
    (bucket k starts at slot offset k of the counts buffer), rows
    ascending within a bucket, then -1 — the order of
    :func:`level_partition_plain`'s records."""
    key = torch.where(row_slot >= 0, row_slot.long(), MAX_SLOTS)
    order = torch.argsort(key, stable=True).to(torch.int32)
    order[int(counts[-1]):] = -1
    return order


def level_partition_plain(bins_T, gh_T, row_slot, counts, *,
                          num_bins: int, f_oh: int, nch: int = NCH_PRECISE,
                          quant_bits: int = 0, packed: PackedLayout = None):
    """Plain PyTorch version of :func:`level_partition` (stage 2): stage
    [Rp, record bytes] uint8 — the staging record (:func:`record_layout`)
    of row ``partition_order_plain(row_slot, counts)[q]`` at position q,
    zeros past the last bucket; ``counts`` is :func:`level_mark_plain`'s
    buffer."""
    n = int(counts[-1])
    rows = partition_order_plain(row_slot, counts)[:n].long()
    recs = _records(bins_T, gh_T, rows, _kernel_row_count(f_oh, packed), nch)
    stage = torch.zeros((row_slot.shape[0], recs.shape[1]),
                        dtype=torch.uint8, device=recs.device)
    stage[:n] = recs
    return stage


def level_hist_plain(stage, counts, fmask=None, *, bin_bytes: int,
                     num_bins: int, f_oh: int, nch: int = NCH_PRECISE,
                     quant_bits: int = 0, packed: PackedLayout = None):
    """Plain PyTorch version of :func:`level_hist` (stage 3): the
    [FB, nch*Sp] histogram of each slot's bucket of staging records
    (``counts``: :func:`level_mark_plain`'s buffer)."""
    per_slot = slot_counts(counts, stage.shape[0])
    Sp = per_slot.shape[0]
    n = int(counts[-1])
    K = _kernel_row_count(f_oh, packed)
    ch_dt = torch.int8 if quant_bits else torch.bfloat16
    ch_off, _ = record_layout(K, bin_bytes, nch, ch_dt.itemsize)
    rec = stage[:n]
    bins = rec[:, :K * bin_bytes].contiguous().view(
        torch.int8 if bin_bytes == 1 else torch.int16).t()
    vals = rec[:, ch_off:ch_off + nch * ch_dt.itemsize].contiguous() \
        .view(ch_dt).t()
    k = torch.repeat_interleave(torch.arange(Sp, device=stage.device),
                                per_slot.long())
    FB = packed.fb if packed is not None else f_oh * num_bins
    return _hist_plain(bins, vals, k, fmask, Sp=Sp, FB=FB,
                       num_bins=num_bins, f_oh=f_oh, nch=nch,
                       quant_bits=quant_bits, packed=packed)


def route_pass_plain(bins_T, leaf_T, W, tbl, *, num_bins: int, f_oh: int,
                     packed: PackedLayout = None):
    """Plain PyTorch version of :func:`route_pass`: the full W @ one-hot
    sum over every kernel row, as the TPU kernel takes it."""
    return _route_plain(bins_T, leaf_T, W, tbl, num_bins, f_oh, packed)[2]


def slab_table_plain(W, *, num_bins: int, f_oh: int,
                     packed: PackedLayout = None):
    """Plain PyTorch version of the slab-table kernel that
    :func:`level_pass`, :func:`route_pass` and :func:`epilogue_pass` start
    with: [Sp] int32, for each W row the one kernel row whose slab holds a
    non-zero, ``SLAB_NONE`` when none does, ``SLAB_MANY`` when several do."""
    nz = W != 0
    hit = torch.stack([nz[:, off:off + (num_bins if width is None
                                        else width)].any(1)
                       for off, width in _kernel_rows(num_bins, f_oh,
                                                      packed)], 1)
    n = hit.sum(1)
    first = hit.to(torch.int8).argmax(1)
    return torch.where(n == 1, first, torch.where(
        n == 0, SLAB_NONE, SLAB_MANY)).to(torch.int32)


def route_slabs_plain(bins_T, leaf_T, W, tbl, slab_of, *, num_bins: int,
                      f_oh: int, packed: PackedLayout = None):
    """Plain PyTorch version of the route kernel after the slab table
    (``slab_of`` from :func:`slab_table_plain`): a row of a selected leaf
    whose slot's W row is non-zero on one slab reads that slab's bin and
    one W entry; on several slabs it takes the full sum, on none it goes
    right. Equal to :func:`route_pass_plain` for any 0/1 W."""
    slot, left_full, _ = _route_plain(bins_T, leaf_T, W, tbl, num_bins,
                                      f_oh, packed)
    k = slot.clamp(min=0)
    rows = _kernel_rows(num_bins, f_oh, packed)
    dev = bins_T.device
    off = torch.tensor([o for o, _ in rows], device=dev)
    width = torch.tensor([num_bins if w is None else w for _, w in rows],
                         device=dev)
    js = slab_of.long()[k]
    j = js.clamp(min=0)
    b = bins_T[:len(rows)].long().gather(0, j[None, :])[0]
    inside = b < width[j]
    p = (off[j] + b.clamp(max=width[j] - 1)).clamp(max=W.shape[1] - 1)
    one = inside & (W.float()[k, p] > 0.5)
    left = torch.where(js >= 0, one, (js == SLAB_MANY) & left_full)
    leaf = leaf_T[0]
    new_leaf = torch.where((slot >= 0) & ~left, leaf + tbl[:, 1][k], leaf)
    return new_leaf[None, :].to(torch.int32)


def table_lookup_plain(idx_T, table):
    """Plain PyTorch version of :func:`table_lookup`."""
    L = table.shape[0]
    ok = (idx_T >= 0) & (idx_T < L)
    vals = table[idx_T.clamp(0, L - 1).long()]
    return torch.where(ok, vals, torch.zeros((), dtype=table.dtype,
                                             device=table.device))


def epilogue_rows_plain(new_leaf, leaf_values, score_T, ops_T, bag_T, *,
                        nch: int = NCH_PRECISE, kind: str = "binary",
                        sigmoid: float = 1.0):
    """The element-wise part of :func:`epilogue_pass` after the route:
    (new_score [1, Rp] f32, gh_T [8, Rp] bf16) — the leaf-value lookup,
    the gradients from the updated score times the bag weights, and
    ``pack_gh``."""
    score2 = score_T + table_lookup_plain(new_leaf, leaf_values)
    # the closed forms from the updated score (ref: binary_objective.hpp:
    # 107-136, regression_objective.hpp:127-141); zero operand rows give
    # zero gradients
    op0, op1 = ops_T[0:1], ops_T[1:2]
    if kind == "binary":
        resp = -op0 * sigmoid / (1.0 + torch.exp(op0 * sigmoid * score2))
        ar = torch.abs(resp)
        g, h = resp * op1, ar * (sigmoid - ar) * op1
    else:
        g, h = (score2 - op0) * op1, op1
    g = g * bag_T
    h = h * bag_T
    return score2, pack_gh(g[0], h[0], bag_T[0], nch)


def root_hist_plain(bins_T, gh_T, *, num_bins: int, f_oh: int,
                    nch: int = NCH_PRECISE):
    """The next tree's root histogram [F_oh*Bp, nch*8] f32 (slot 0 of each
    8-column channel block live) by ``index_add_`` of the bf16 channels in
    float64, rounded once to f32: the plain version of the epilogue's
    histogram and reduce kernels, which sum the same values in f32 in
    another order."""
    FB = f_oh * num_bins
    C = nch * 8
    hist = torch.zeros(FB * C, dtype=torch.float64, device=bins_T.device)
    vals = gh_T[:nch].double()                                   # [nch, Rp]
    ch_off = (torch.arange(nch, device=bins_T.device) * 8)[:, None]
    for f in range(f_oh):
        cell = (f * num_bins + bins_T[f].long()) * C              # [Rp]
        hist.index_add_(0, (cell[None, :] + ch_off).reshape(-1),
                        vals.reshape(-1))
    return hist.reshape(FB, C).to(torch.float32)


def epilogue_pass_plain(bins_T, leaf_T, W, tbl, leaf_values, score_T, ops_T,
                        bag_T, *, num_bins: int, f_oh: int,
                        nch: int = NCH_PRECISE, kind: str = "binary",
                        sigmoid: float = 1.0):
    """Plain PyTorch version of :func:`epilogue_pass`: the deferred route
    (:func:`route_pass_plain`), :func:`epilogue_rows_plain` and the root
    histogram by ``index_add_`` (:func:`root_hist_plain`)."""
    new_leaf = route_pass_plain(bins_T, leaf_T, W, tbl, num_bins=num_bins,
                                f_oh=f_oh)
    score2, gh_T = epilogue_rows_plain(new_leaf, leaf_values, score_T, ops_T,
                                       bag_T, nch=nch, kind=kind,
                                       sigmoid=sigmoid)
    hist = root_hist_plain(bins_T, gh_T, num_bins=num_bins, f_oh=f_oh,
                           nch=nch)
    return hist, score2, gh_T


# ---------------------------------------------------------------- wrappers
def _kernel_layout(packed, fmask, f_oh, device):
    """The kernels' per-kernel-row tables: ([2, K] int32 offsets and
    widths or None, [K] uint8 mask or None, K)."""
    if packed is None:
        ktab, K = None, f_oh
        kmask = fmask[:f_oh] if fmask is not None else None
    else:
        lt = layout_tensors(packed, device)
        ktab, K = lt["ktab"], len(packed.feat_order)
        kmask = fmask[lt["order"]] if fmask is not None else None
    if kmask is not None:
        kmask = kmask.to(torch.uint8).contiguous()
    return ktab, kmask, K


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_level_inputs(bins_T, leaf_T, gh_T, W, tbl, fmask, num_bins,
                        f_oh, nch, quant_bits, packed):
    Rp, Sp = _check_route_inputs(bins_T, leaf_T, W, tbl, num_bins, f_oh,
                                 packed)
    _check_channels(gh_T, Rp, nch, quant_bits, bins_T.device)
    if fmask is not None and (tuple(fmask.shape) != (f_oh,)
                              or fmask.dtype != torch.bool
                              or fmask.device != bins_T.device):
        raise ValueError(f"fmask must be [{f_oh}] bool on {bins_T.device}")
    return Rp, Sp


def _check_channels(gh_T, Rp, nch, quant_bits, dev):
    if quant_bits not in (0, 8, 16):
        raise ValueError(f"quant_bits must be 0, 8 or 16; got {quant_bits}")
    allowed = ((quantize.QNCH[quant_bits],) if quant_bits
               else (NCH_PRECISE, NCH_FAST))
    if nch not in allowed:
        raise ValueError(f"nch={nch} does not fit quant_bits={quant_bits}")
    gh_dt = torch.int8 if quant_bits else torch.bfloat16
    if tuple(gh_T.shape) != (8, Rp) or gh_T.dtype != gh_dt:
        raise ValueError(f"gh_T must be [8, Rp] {gh_dt} with "
                         f"quant_bits={quant_bits}; got "
                         f"{tuple(gh_T.shape)} {gh_T.dtype}")
    if gh_T.device != dev:
        raise ValueError("gh_T and bins_T are on different devices")


_limits: Dict[int, Tuple[int, int]] = {}


def _device_limits(device) -> Tuple[int, int]:
    """(SM count, opt-in shared memory bytes per block) of the card, read
    once per device (132 and 227 KB on the H100)."""
    idx = torch.device(device).index or 0
    if idx not in _limits:
        import ctypes
        from .cuda_build import library
        sms, optin = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(idx):
            _raise_on(library().lgbt_device_limits(ctypes.byref(sms),
                                                   ctypes.byref(optin)),
                      "device_limits")
        _limits[idx] = (sms.value, optin.value)
    return _limits[idx]


def _smem_budget(device) -> int:
    """Bytes of shared memory a level_hist block may give its tile: the
    card's opt-in limit per block less the kernel's static arrays."""
    return _device_limits(device)[1] - HIST_STATIC_SMEM


def _count_kernels(names, bits: int, counts=None) -> None:
    """Count in ``counts`` (``cuda_launches``) the kernels a C entry reports
    launched: bit i of ``bits`` for ``names[i]``."""
    counts = cuda_launches if counts is None else counts
    for i, kern in enumerate(names):
        if bits >> i & 1:
            counts[kern] += 1


@functools.lru_cache(maxsize=None)
def level_tile_shape(K: int, width: int, nch: int,
                     budget: int) -> Tuple[int, int, int]:
    """(Cw, Bw, nr) of the level_tiles kernel: Cw kernel rows per tile (the
    K rows cut into ceil(K / 32) even groups; a lane adds for kernel row l
    % Cw and 32 // Cw lanes share a row as replicas), Bw bins per tile (the
    widest slab ``width`` cut into bin groups of Bw: up to 64, wider slabs
    into at most 16 groups where the tiles fit), and nr record lanes (the
    block's nch * nr warps each own one channel's tile of Bw x 32 4-byte
    sums, all within ``budget`` bytes, at most 32 warps). (28, 64, 5) at K
    = 28, Bp = 64, nch = 5 on the H100."""
    gy = -(-K // 32)
    Cw = -(-K // gy)
    tile = 32 * 4                                   # bytes per tile bin
    Bw = min(width, max(64, 1 << max(0, (-(-width // 16) - 1).bit_length())))
    while Bw > 1 and nch * Bw * tile > budget:
        Bw //= 2
    nr = max(1, min(budget // (nch * Bw * tile), 32 // nch))
    return Cw, Bw, nr


def _level_row_blocks(dev, Rp: int, K: int, width: int, nch: int,
                      shape) -> int:
    """Row blocks of the level_tiles kernel: enough to fill the card once
    across the kernel-row and bin groups, at least MIN_TILE_ROWS rows
    each."""
    Cw, Bw, nr = shape
    sms, optin = _device_limits(dev)
    smem = nch * nr * Bw * 32 * 4 + HIST_STATIC_SMEM
    per_sm = max(1, (optin + HIST_STATIC_SMEM) // smem)
    groups = -(-K // Cw) * -(-width // Bw)
    return max(1, min(-(-Rp // MIN_TILE_ROWS), sms * per_sm // groups))


def _counts_buffer(Rp: int, Sp: int, dev) -> torch.Tensor:
    """The level stages' int32 scratch: per-(slot, block) counts and their
    offsets, the slot offsets and the slab table (lgbt_level_pass)."""
    nb = -(-Rp // MARK_ROWS)
    return torch.zeros(2 * Sp * nb + 2 * Sp + 1, dtype=torch.int32,
                       device=dev)


def _level_launch(stages, bins_T, leaf_T, gh_T, W, tbl, fmask, *, hist,
                  new_leaf, row_slot, counts, stage, num_bins, f_oh, nch,
                  quant_bits, packed, FB, Sp, Rp, bin_bytes):
    """Launch the level_pass stages in ``stages`` (LEVEL_STAGES names) on
    the current stream and count in ``cuda_launches`` the kernels the C
    entry reports launched (one bit each, in LEVEL_KERNELS order)."""
    import ctypes
    from .cuda_build import library
    dev = counts.device
    ktab, kmask, K = _kernel_layout(packed, fmask, f_oh, dev)
    width = max(packed.widths) if packed is not None else num_bins
    shape = level_tile_shape(K, width, nch, _smem_budget(dev))
    Cw, Bw, nr = shape
    gx = _level_row_blocks(dev, Rp, K, width, nch, shape)
    part = None
    if "level_hist" in stages:
        # the tiles' part slices: (gx + Sp) of [nch, Bw, Cw] per kernel-row
        # group and bin group
        slices = (gx + Sp) * -(-K // Cw) * -(-width // Bw)
        part = torch.empty(slices * nch * Bw * Cw,
                           dtype=torch.int32 if quant_bits
                           else torch.float32, device=dev)
    ch_off, rec_bytes = record_layout(K, bin_bytes, nch,
                                      1 if quant_bits else 2)
    mask = sum(1 << LEVEL_STAGES.index(st) for st in stages)
    done = ctypes.c_int(0)
    rc = library().lgbt_level_pass(
        _ptr(bins_T), bin_bytes, _ptr(leaf_T), _ptr(gh_T),
        int(bool(quant_bits)), _ptr(W), _ptr(tbl), _ptr(ktab), _ptr(kmask),
        _ptr(hist), _ptr(new_leaf), _ptr(row_slot), counts.data_ptr(),
        _ptr(stage), _ptr(part), Rp, K, num_bins, FB, Sp, nch, Cw, Bw,
        width, nr, gx, ch_off, rec_bytes, mask, _stream(dev),
        ctypes.byref(done))
    _count_kernels(LEVEL_KERNELS, done.value)
    _raise_on(rc, "level_pass")


def _stage_buffer(K, bins_T, nch, quant_bits):
    """[Rp, record bytes] uint8 scratch for the staging records."""
    _, rec_bytes = record_layout(K, bins_T.element_size(), nch,
                                 1 if quant_bits else 2)
    return torch.empty((bins_T.shape[1], rec_bytes), dtype=torch.uint8,
                       device=bins_T.device)


def level_pass(bins_T: torch.Tensor, leaf_T: torch.Tensor,
               gh_T: torch.Tensor, W: torch.Tensor, tbl: torch.Tensor,
               fmask: torch.Tensor = None, *, num_bins: int, f_oh: int,
               nch: int = NCH_PRECISE, quant_bits: int = 0,
               packed: PackedLayout = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused route + smaller-child histogram pass over all rows.

    Returns (hist [FB, nch*Sp], new_leaf [1, Rp] int32); FB is
    ``packed.fb`` or ``f_oh * num_bins``, and hist is float32, or int32
    under ``quant_bits`` (8 or 16; ``gh_T`` then holds the int8 channels
    of :func:`pack_gh_quant` and ``nch`` is ``quantize.QNCH[quant_bits]``).
    ``num_bins`` is the padded Bp. Every row of a selected leaf moves to
    its child; rows in the smaller child (``tbl`` col 2) add their nch
    channels into ``hist[slab_j + bin_j, ch*Sp + k]`` for every kernel row
    j (slab_j = j*Bp, or ``packed.flat_offsets[j]`` with ``bins_T``'s rows
    in ``packed.feat_order``). ``fmask`` [f_oh] bool (gain screening)
    zeroes the slabs of the features it masks in both the routing sum and
    the histogram; the JAX package passes the same mask expanded to
    [FB, 128].

    On the card it launches the three stages (:func:`level_mark`,
    :func:`level_partition`, :func:`level_hist`) back to back with no host
    sync; the per-slot counts never leave the device.
    """
    Rp, Sp = _check_level_inputs(bins_T, leaf_T, gh_T, W, tbl, fmask,
                                 num_bins, f_oh, nch, quant_bits, packed)
    dev = bins_T.device
    if dev.type == "cpu":
        return level_pass_plain(bins_T, leaf_T, gh_T, W, tbl, fmask,
                                num_bins=num_bins, f_oh=f_oh, nch=nch,
                                quant_bits=quant_bits, packed=packed)
    _require_cuda(bins_T, leaf_T, gh_T, W, tbl)
    FB = W.shape[1]
    C = nch * Sp
    hist = torch.zeros((FB, C), device=dev,
                       dtype=torch.int32 if quant_bits else torch.float32)
    new_leaf = torch.empty_like(leaf_T)
    _level_launch(LEVEL_STAGES, bins_T, leaf_T, gh_T, W, tbl, fmask,
                  hist=hist, new_leaf=new_leaf,
                  row_slot=torch.empty(Rp, dtype=torch.int8, device=dev),
                  counts=_counts_buffer(Rp, Sp, dev),
                  stage=_stage_buffer(_kernel_row_count(f_oh, packed),
                                      bins_T, nch, quant_bits),
                  num_bins=num_bins, f_oh=f_oh, nch=nch,
                  quant_bits=quant_bits, packed=packed, FB=FB, Sp=Sp, Rp=Rp,
                  bin_bytes=bins_T.element_size())
    launches["level_pass"] += 1
    variant = variant_name(quant_bits, packed is not None, fmask is not None)
    if variant != "f32":
        variant_launches["level_pass:" + variant] += 1
    return hist, new_leaf


def level_mark(bins_T: torch.Tensor, leaf_T: torch.Tensor,
               gh_T: torch.Tensor, W: torch.Tensor, tbl: torch.Tensor,
               fmask: torch.Tensor = None, *, num_bins: int, f_oh: int,
               nch: int = NCH_PRECISE, quant_bits: int = 0,
               packed: PackedLayout = None):
    """Stage 1 of :func:`level_pass` alone (same operands): (new_leaf
    [1, Rp] int32, row_slot [Rp] int8, counts buffer), as
    :func:`level_mark_plain` describes; on the card the counts buffer is
    the one the kernels wrote, which :func:`level_partition` and
    :func:`level_hist` take as it is."""
    Rp, Sp = _check_level_inputs(bins_T, leaf_T, gh_T, W, tbl, fmask,
                                 num_bins, f_oh, nch, quant_bits, packed)
    dev = bins_T.device
    if dev.type == "cpu":
        return level_mark_plain(bins_T, leaf_T, gh_T, W, tbl, fmask,
                                num_bins=num_bins, f_oh=f_oh, nch=nch,
                                quant_bits=quant_bits, packed=packed)
    _require_cuda(bins_T, leaf_T, gh_T, W, tbl)
    new_leaf = torch.empty_like(leaf_T)
    row_slot = torch.empty(Rp, dtype=torch.int8, device=dev)
    counts = _counts_buffer(Rp, Sp, dev)
    _level_launch(LEVEL_STAGES[:1], bins_T, leaf_T, gh_T, W, tbl, fmask,
                  hist=None, new_leaf=new_leaf, row_slot=row_slot,
                  counts=counts, stage=None, num_bins=num_bins,
                  f_oh=f_oh, nch=nch, quant_bits=quant_bits, packed=packed,
                  FB=W.shape[1], Sp=Sp, Rp=Rp,
                  bin_bytes=bins_T.element_size())
    # the slab table after the slot offsets is the mark stage's own
    return new_leaf, row_slot, counts[:-Sp]


def _check_stage_operands(row_slot, counts, Rp) -> int:
    """Check a later stage's ``row_slot`` and mark-stage counts buffer over
    ``Rp`` rows; returns Sp."""
    if row_slot is not None and (tuple(row_slot.shape) != (Rp,)
                                 or row_slot.dtype != torch.int8):
        raise ValueError(f"row_slot must be [{Rp}] int8")
    nb = -(-Rp // MARK_ROWS)
    Sp, rest = divmod(counts.shape[0] - 1, 2 * nb + 1) \
        if counts.dim() == 1 else (0, 1)
    if counts.dtype != torch.int32 or rest or not 1 <= Sp <= MAX_SLOTS:
        raise ValueError(f"counts must be level_mark's int32 buffer of "
                         f"2 * Sp * {nb} + Sp + 1 words, Sp <= {MAX_SLOTS}")
    return Sp


def level_partition(bins_T: torch.Tensor, gh_T: torch.Tensor,
                    row_slot: torch.Tensor, counts: torch.Tensor, *,
                    num_bins: int, f_oh: int, nch: int = NCH_PRECISE,
                    quant_bits: int = 0, packed: PackedLayout = None
                    ) -> torch.Tensor:
    """Stage 2 of :func:`level_pass` alone: the staging records as
    :func:`level_partition_plain` describes, from :func:`level_mark`'s
    ``row_slot`` and counts buffer; on the card the rows past the last
    bucket are unset."""
    if bins_T.dim() != 2 or bins_T.dtype not in (torch.int8, torch.int16):
        raise ValueError("bins_T must be a 2-D int8 or int16 tensor")
    Rp = bins_T.shape[1]
    Sp = _check_stage_operands(row_slot, counts, Rp)
    _check_channels(gh_T, Rp, nch, quant_bits, bins_T.device)
    kw = dict(num_bins=num_bins, f_oh=f_oh, nch=nch, quant_bits=quant_bits,
              packed=packed)
    if bins_T.device.type == "cpu":
        return level_partition_plain(bins_T, gh_T, row_slot, counts, **kw)
    _require_cuda(bins_T, gh_T, row_slot, counts)
    stage = _stage_buffer(_kernel_row_count(f_oh, packed), bins_T, nch,
                          quant_bits)
    _level_launch(LEVEL_STAGES[1:2], bins_T, None, gh_T, None, None, None,
                  hist=None, new_leaf=None, row_slot=row_slot, counts=counts,
                  stage=stage, FB=0, Sp=Sp, Rp=Rp,
                  bin_bytes=bins_T.element_size(), **kw)
    return stage


def level_hist(stage: torch.Tensor, counts: torch.Tensor,
               fmask: torch.Tensor = None, *, bin_bytes: int, num_bins: int,
               f_oh: int, nch: int = NCH_PRECISE, quant_bits: int = 0,
               packed: PackedLayout = None) -> torch.Tensor:
    """Stage 3 of :func:`level_pass` alone: the [FB, nch*Sp] histogram of
    each slot's bucket of :func:`level_partition`'s staging records, from
    :func:`level_mark`'s counts buffer (``bin_bytes`` 1 or 2: the bins'
    width in the records)."""
    K = _kernel_row_count(f_oh, packed)
    _, rec_bytes = record_layout(K, bin_bytes, nch, 1 if quant_bits else 2)
    if stage.dim() != 2 or stage.shape[1] != rec_bytes \
            or stage.dtype != torch.uint8:
        raise ValueError(f"stage must be [Rp, {rec_bytes}] uint8")
    Sp = _check_stage_operands(None, counts, stage.shape[0])
    if packed is not None:
        _check_packed(packed, num_bins, f_oh)
    kw = dict(num_bins=num_bins, f_oh=f_oh, nch=nch, quant_bits=quant_bits,
              packed=packed)
    if stage.device.type == "cpu":
        return level_hist_plain(stage, counts, fmask, bin_bytes=bin_bytes,
                                **kw)
    _require_cuda(stage, counts)
    FB = packed.fb if packed is not None else f_oh * num_bins
    hist = torch.zeros((FB, nch * Sp), device=stage.device,
                       dtype=torch.int32 if quant_bits else torch.float32)
    _level_launch(LEVEL_STAGES[2:], None, None, None, None, None, fmask,
                  hist=hist, new_leaf=None, row_slot=None, counts=counts,
                  stage=stage, FB=FB, Sp=Sp, Rp=stage.shape[0],
                  bin_bytes=bin_bytes, **kw)
    return hist


def route_pass(bins_T: torch.Tensor, leaf_T: torch.Tensor, W: torch.Tensor,
               tbl: torch.Tensor, *, num_bins: int, f_oh: int,
               packed: PackedLayout = None) -> torch.Tensor:
    """Row -> leaf update only (same W/tbl/packed contract as level_pass;
    routing never masks features). On the card two CUDA kernels
    (``ROUTE_KERNELS``): the slab table of W (:func:`slab_table_plain`),
    then the route through it (:func:`route_slabs_plain`)."""
    Rp, Sp = _check_route_inputs(bins_T, leaf_T, W, tbl, num_bins, f_oh,
                                 packed)
    if bins_T.device.type == "cpu":
        return route_pass_plain(bins_T, leaf_T, W, tbl, num_bins=num_bins,
                                f_oh=f_oh, packed=packed)
    _require_cuda(bins_T, leaf_T, W, tbl)
    import ctypes
    from .cuda_build import library
    dev = bins_T.device
    ktab, _, K = _kernel_layout(packed, None, f_oh, dev)
    new_leaf = torch.empty_like(leaf_T)
    slab_of = torch.empty(Sp, dtype=torch.int32, device=dev)
    done = ctypes.c_int(0)
    rc = library().lgbt_route_pass(
        bins_T.data_ptr(), bins_T.element_size(), leaf_T.data_ptr(),
        W.data_ptr(), tbl.data_ptr(), _ptr(ktab), slab_of.data_ptr(),
        new_leaf.data_ptr(), Rp, K, num_bins, W.shape[1], Sp, _stream(dev),
        ctypes.byref(done))
    _count_kernels(ROUTE_KERNELS, done.value)
    _raise_on(rc, "route_pass")
    launches["route_pass"] += 1
    if packed is not None:
        variant_launches["route_pass:packed"] += 1
    return new_leaf


def table_lookup(idx_T: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """out[0, r] = table[idx_T[0, r]], and 0 where the index is outside
    [0, len(table)). ``idx_T`` [1, R] int32, ``table`` [L] float32."""
    if idx_T.dim() != 2 or idx_T.shape[0] != 1 \
            or idx_T.dtype != torch.int32:
        raise ValueError("idx_T must be [1, R] int32")
    if table.dim() != 1 or table.dtype != torch.float32:
        raise ValueError("table must be 1-D float32")
    if table.device != idx_T.device:
        raise ValueError("idx_T and table are on different devices")
    if idx_T.device.type == "cpu":
        return table_lookup_plain(idx_T, table)
    _require_cuda(idx_T, table)
    from .cuda_build import library
    out = torch.empty(idx_T.shape, dtype=torch.float32, device=idx_T.device)
    rc = library().lgbt_table_lookup(
        idx_T.data_ptr(), table.data_ptr(), out.data_ptr(), idx_T.shape[1],
        table.shape[0], _stream(idx_T.device))
    _raise_on(rc, "table_lookup")
    launches["table_lookup"] += 1
    cuda_launches["table_lookup"] += 1
    return out


def epilogue_pass(bins_T: torch.Tensor, leaf_T: torch.Tensor,
                  W: torch.Tensor, tbl: torch.Tensor,
                  leaf_values: torch.Tensor, score_T: torch.Tensor,
                  ops_T: torch.Tensor, bag_T: torch.Tensor, *,
                  num_bins: int, f_oh: int, nch: int = NCH_PRECISE,
                  kind: str = "binary", sigmoid: float = 1.0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused boosting epilogue, in one pass over the rows: the deferred
    final route (``W``/``tbl``; an all-inactive table routes nothing), the
    score update ``score += leaf_values[leaf]`` (0 outside [0, L)), the
    ``kind`` gradients from the UPDATED score times the next iteration's
    bag weights ``bag_T``, their ``pack_gh`` block, and the next tree's
    root histogram.

    ``leaf_T`` is the assignment before the final route (-1 on padding
    rows); ``leaf_values`` [L] f32 is already shrunk (zeros when the tree
    grew no split); ``ops_T`` [8, Rp] f32 holds the objective's operand rows
    (binary: ±1 label, label weight; l2: label, weight); ``bag_T`` [1, Rp]
    is 0 on padding rows.

    Returns (hist [F_oh*Bp, nch*8] f32 in the root ``level_pass`` layout —
    slot 0 of each 8-column channel block live, slots 1-7 zero —,
    new_score [1, Rp] f32, gh_T [8, Rp] bf16).

    On the card four CUDA kernels (``EPILOGUE_KERNELS``): the slab table of
    W (:func:`slab_table_plain`); the route through it, the score, the
    gradients and the pack (:func:`route_slabs_plain`,
    :func:`epilogue_rows_plain`); each block's partial root histogram; and
    the fixed-order reduce of the partials (:func:`root_hist_plain` sums
    the same values in another order). Any ``num_bins`` runs there: slabs
    wider than 1024 bins (EFB bundle columns) take bin groups.
    """
    Rp, Sp = _check_route_inputs(bins_T, leaf_T, W, tbl, num_bins, f_oh)
    if nch not in (NCH_PRECISE, NCH_FAST):
        raise ValueError(f"nch must be 3 or 5; got {nch}")
    if kind not in EPILOGUE_KINDS:
        raise ValueError(f"kind must be one of {EPILOGUE_KINDS}; got {kind}")
    if leaf_values.dim() != 1 or leaf_values.dtype != torch.float32:
        raise ValueError("leaf_values must be 1-D float32")
    for name, t, rows in (("score_T", score_T, 1), ("ops_T", ops_T, 8),
                          ("bag_T", bag_T, 1)):
        if tuple(t.shape) != (rows, Rp) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be [{rows}, {Rp}] float32")
    dev = bins_T.device
    for name, t in (("leaf_values", leaf_values), ("score_T", score_T),
                    ("ops_T", ops_T), ("bag_T", bag_T)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, bins_T on {dev}")
    if dev.type == "cpu":
        return epilogue_pass_plain(bins_T, leaf_T, W, tbl, leaf_values,
                                   score_T, ops_T, bag_T, num_bins=num_bins,
                                   f_oh=f_oh, nch=nch, kind=kind,
                                   sigmoid=sigmoid)
    _require_cuda(bins_T, leaf_T, W, tbl, leaf_values, score_T, ops_T, bag_T)
    buf = epilogue_buffers(bins_T, Sp, num_bins=num_bins, f_oh=f_oh,
                           nch=nch)
    _epilogue_launch(EPILOGUE_KERNELS, bins_T, leaf_T, W, tbl, leaf_values,
                     score_T, ops_T, bag_T, buf, num_bins=num_bins,
                     f_oh=f_oh, nch=nch, kind=kind, sigmoid=sigmoid)
    launches["epilogue_pass"] += 1
    return buf["hist"], buf["new_score"], buf["gh_T"]


@functools.lru_cache(maxsize=64)
def _epilogue_blocks(dev_index: int, bin_bytes: int, num_bins: int,
                     f_oh: int, nch: int, Rp: int,
                     smem_limit: int) -> Tuple[int, int]:
    """(row blocks, f32 partials) of the epilogue's hist kernel."""
    import ctypes
    from .cuda_build import library
    blocks, floats = ctypes.c_int(0), ctypes.c_longlong(0)
    with torch.cuda.device(dev_index):
        _raise_on(library().lgbt_epilogue_blocks(
            bin_bytes, num_bins, f_oh, nch, Rp, smem_limit,
            ctypes.byref(floats), ctypes.byref(blocks)), "epilogue_pass")
    return blocks.value, floats.value


def epilogue_buffers(bins_T, Sp, *, num_bins: int, f_oh: int,
                     nch: int) -> Dict[str, object]:
    """The outputs and scratch of one :func:`epilogue_pass` launch on the
    card: hist, new_score, gh_T, the hist kernel's per-block f32 partial
    histograms and its row blocks, the [Sp] slab table, and the shared
    memory a block may use (the card's opt-in limit)."""
    dev = bins_T.device
    Rp = bins_T.shape[1]
    smem_limit = _device_limits(dev)[1]
    blocks, floats = _epilogue_blocks(dev.index or 0, bins_T.element_size(),
                                      num_bins, f_oh, nch, Rp, smem_limit)
    FB = f_oh * num_bins
    return {"hist": torch.empty((FB, nch * 8), dtype=torch.float32,
                                device=dev),
            "new_score": torch.empty((1, Rp), dtype=torch.float32,
                                     device=dev),
            "gh_T": torch.empty((8, Rp), dtype=torch.bfloat16, device=dev),
            "part": torch.empty(floats, dtype=torch.float32, device=dev),
            "slab_of": torch.empty(Sp, dtype=torch.int32, device=dev),
            "blocks": blocks, "smem_limit": smem_limit}


def _epilogue_launch(kernels, bins_T, leaf_T, W, tbl, leaf_values, score_T,
                     ops_T, bag_T, buf, *, num_bins, f_oh, nch, kind,
                     sigmoid) -> None:
    """Launch the epilogue's CUDA kernels named in ``kernels`` (of
    EPILOGUE_KERNELS; the pass reads the slab table, the reduce the
    partials, that ``buf`` holds from earlier stages) on the current
    stream, and count those the C entry reports launched."""
    import ctypes
    from .cuda_build import library
    stages = sum(1 << EPILOGUE_KERNELS.index(k) for k in kernels)
    done = ctypes.c_int(0)
    rc = library().lgbt_epilogue_pass(
        bins_T.data_ptr(), bins_T.element_size(), leaf_T.data_ptr(),
        W.data_ptr(), tbl.data_ptr(), leaf_values.data_ptr(),
        leaf_values.shape[0], score_T.data_ptr(), ops_T.data_ptr(),
        bag_T.data_ptr(), buf["hist"].data_ptr(),
        buf["new_score"].data_ptr(), buf["gh_T"].data_ptr(),
        buf["part"].data_ptr(), buf["slab_of"].data_ptr(),
        bins_T.shape[1], f_oh, num_bins, tbl.shape[0], nch,
        EPILOGUE_KINDS.index(kind), float(sigmoid), buf["smem_limit"],
        buf["blocks"], stages, _stream(bins_T.device), ctypes.byref(done))
    _count_kernels(EPILOGUE_KERNELS, done.value)
    _raise_on(rc, "epilogue_pass")
