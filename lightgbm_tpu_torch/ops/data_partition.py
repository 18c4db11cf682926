"""The leaf-wise grower's rows as one index list on the card, grouped by
leaf (the reference LightGBM's ``DataPartition``,
``src/treelearner/data_partition.hpp``; the JAX package has no module of
this name: its grower keeps a per-row leaf vector and rewrites it over all
rows each step).

State, per tree (``models/learner.py`` ``grow_tree_leafwise``):

- ``order`` int32 [R]: row ids grouped by leaf, in row order within a leaf;
- ``leaf_begin``, ``leaf_rows`` int32 [L]: each leaf's segment of
  ``order`` (every row counts, zero weight or not);
- ``scratch`` int32 [R]: the partition's staging list (card only).

Two functions of a leaf-wise step read only a leaf's listed rows, each a
hand-written CUDA kernel (``csrc/data_partition.cu``) behind a wrapper,
with its plain PyTorch version beside it:

- :func:`leaf_partition`: the split leaf's segment rewritten stably, left
  rows first, and the two children's begins and lengths, from a table of
  the split's decision per value of the kernel's bin column (two CUDA
  kernels, ``PARTITION_KERNELS``);
- :func:`leaf_hist`: the unrounded ``[3, Fp, Bk]`` planes of one leaf's
  listed rows, summed in f64 and rounded to f32 once (one CUDA kernel).

The split leaf, the new leaf, the histogram's leaf and the step's do-split
flag are one-element device tensors, so neither wrapper reads the device
on the host. With the flag false the partition writes nothing and the
histogram is all zeros. On a CPU tensor the wrappers run the plain
versions; on a CUDA tensor they launch the kernels or raise. Each counts
its calls in ``launches`` and the CUDA kernels the C entry reports in
``cuda_launches`` (kept here, as ``ops/predict.py`` keeps its own, and
reset by :func:`reset_launch_counts`).
"""
from __future__ import annotations

from typing import Dict

import torch

from .fused_level import _count_kernels, _raise_on, _require_cuda, _stream

# the partition's fixed grid (csrc/data_partition.cu kPartBlocks); its work
# buffer holds one left count per block, then the segment's begin and length
PART_BLOCKS = 256
# leaf_hist: blocks over the list shared by the tiles of 32 features x 16
# bins, and the f64 cells of a tile's partial slice (3 channels x 16 x 32)
HIST_BLOCKS = 256
TILE_LANES, TILE_BINS = 32, 16
TILE_CELLS = 3 * TILE_BINS * TILE_LANES
NUM_CH = 3
PARTITION_KERNELS = ("partition_split", "partition_copy")
LEAF_HIST_KERNELS = ("leaf_hist",)

# wrapper calls and CUDA kernel launches since the last reset
launches: Dict[str, int] = {"leaf_partition": 0, "leaf_hist": 0}
cuda_launches: Dict[str, int] = dict.fromkeys(
    PARTITION_KERNELS + LEAF_HIST_KERNELS, 0)


def reset_launch_counts() -> None:
    for counts in (launches, cuda_launches):
        for k in counts:
            counts[k] = 0


def _check_state(order, leaf_begin, leaf_rows, *leaves):
    if order.dim() != 1 or order.dtype != torch.int32:
        raise ValueError(f"order must be a 1-D int32 tensor; got "
                         f"{tuple(order.shape)} {order.dtype}")
    for name, t in (("leaf_begin", leaf_begin), ("leaf_rows", leaf_rows)):
        if t.dim() != 1 or t.dtype != torch.int32 or t.shape != \
                leaf_begin.shape:
            raise ValueError(f"{name} must be a 1-D int32 tensor of the "
                             f"leaves; got {tuple(t.shape)} {t.dtype}")
    for t in leaves:
        if t.shape != (1,) or t.dtype != torch.int64:
            raise ValueError(f"a leaf must be a [1] int64 tensor; got "
                             f"{tuple(t.shape)} {t.dtype}")


def _check_flag(ds):
    if ds.shape != (1,) or ds.dtype != torch.bool:
        raise ValueError(f"ds must be a [1] bool tensor; got "
                         f"{tuple(ds.shape)} {ds.dtype}")


def _check_bins(bins_i32, R):
    if bins_i32.dim() != 2 or bins_i32.dtype != torch.int32 \
            or bins_i32.shape[0] != R:
        raise ValueError(f"bins_i32 must be [{R}, Fp] int32; got "
                         f"{tuple(bins_i32.shape)} {bins_i32.dtype}")


def _same_device(ref, **tensors):
    for name, t in tensors.items():
        if t is not None and t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, order on "
                             f"{ref.device}")


# ------------------------------------------------------- leaf_partition
def leaf_partition_plain(order: torch.Tensor, leaf_begin: torch.Tensor,
                         leaf_rows: torch.Tensor, leaf: torch.Tensor,
                         new_leaf: torch.Tensor, ds: torch.Tensor,
                         bins_i32: torch.Tensor, col: torch.Tensor,
                         left_table: torch.Tensor) -> None:
    """Plain PyTorch version of :func:`leaf_partition`, in place: a boolean
    mask over the leaf's segment (the table at each row's bin of column
    ``col``, clamped to the table), then ``torch.cat`` of its left and
    right rows."""
    if not bool(ds):
        return
    lf, nw = int(leaf), int(new_leaf)
    b, n = int(leaf_begin[lf]), int(leaf_rows[lf])
    seg = order[b:b + n]
    v = bins_i32[seg.long(), int(col)].long().clamp(0,
                                                     left_table.numel() - 1)
    left = left_table[v]
    order[b:b + n] = torch.cat([seg[left], seg[~left]])
    n_left = int(left.sum())
    leaf_rows[lf] = n_left
    leaf_begin[nw] = b + n_left
    leaf_rows[nw] = n - n_left


def leaf_partition(order: torch.Tensor, scratch: torch.Tensor,
                   leaf_begin: torch.Tensor, leaf_rows: torch.Tensor,
                   leaf: torch.Tensor, new_leaf: torch.Tensor,
                   ds: torch.Tensor, bins_i32: torch.Tensor,
                   col: torch.Tensor, left_table: torch.Tensor) -> None:
    """Split leaf ``leaf``'s segment of ``order`` in place where ``ds``
    holds: its rows whose bin ``bins_i32[row, col]`` has
    ``left_table[bin]`` first, then the others, each in the order they
    had; ``leaf_rows[leaf]``, ``leaf_begin[new_leaf]`` and
    ``leaf_rows[new_leaf]`` set to the two children's. ``leaf``,
    ``new_leaf`` and ``col`` are [1] int64, ``ds`` [1] bool, ``left_table``
    [Bk] bool, ``scratch`` int32 [R] (the card's staging list)."""
    _check_state(order, leaf_begin, leaf_rows, leaf, new_leaf, col)
    _check_flag(ds)
    R = order.shape[0]
    _check_bins(bins_i32, R)
    if left_table.dim() != 1 or left_table.dtype != torch.bool \
            or left_table.numel() < 1:
        raise ValueError("left_table must be a non-empty 1-D bool tensor")
    _same_device(order, scratch=scratch, leaf_begin=leaf_begin,
                 leaf_rows=leaf_rows, leaf=leaf, new_leaf=new_leaf, ds=ds,
                 bins_i32=bins_i32, col=col, left_table=left_table)
    if order.device.type == "cpu":
        leaf_partition_plain(order, leaf_begin, leaf_rows, leaf, new_leaf,
                             ds, bins_i32, col, left_table)
        return
    if scratch.dtype != torch.int32 or scratch.numel() < R:
        raise ValueError(f"scratch must be int32 with at least {R} "
                         f"elements")
    _require_cuda(order, scratch, leaf_begin, leaf_rows, leaf, new_leaf, ds,
                  bins_i32, col, left_table)
    import ctypes
    from .cuda_build import library
    work = torch.empty(PART_BLOCKS + 2, dtype=torch.int32,
                       device=order.device)
    done = ctypes.c_int(0)
    rc = library().lgbt_leaf_partition(
        order.data_ptr(), scratch.data_ptr(), leaf_begin.data_ptr(),
        leaf_rows.data_ptr(), leaf.data_ptr(), new_leaf.data_ptr(),
        ds.data_ptr(), bins_i32.data_ptr(), bins_i32.shape[1], col.data_ptr(),
        left_table.data_ptr(), left_table.numel(), work.data_ptr(),
        _stream(order.device), ctypes.byref(done))
    _count_kernels(PARTITION_KERNELS, done.value, cuda_launches)
    _raise_on(rc, "leaf_partition")
    launches["leaf_partition"] += 1


# ------------------------------------------------------------ leaf_hist
def leaf_hist_plain(bins_i32: torch.Tensor, gh: torch.Tensor,
                    order: torch.Tensor, leaf_begin: torch.Tensor,
                    leaf_rows: torch.Tensor, leaf: torch.Tensor,
                    ds: torch.Tensor, *,
                    num_bins: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`leaf_hist`: one ``index_add_`` of
    the listed rows' (feature, bin) cells in float64, rounded once to f32
    (as ``hist_pass_plain(..., unrounded=True)``)."""
    R, Fp = bins_i32.shape
    Bk = num_bins
    dev = bins_i32.device
    out = torch.zeros((Fp * Bk, NUM_CH), dtype=torch.float64, device=dev)
    if bool(ds):
        lf = int(leaf)
        b, n = int(leaf_begin[lf]), int(leaf_rows[lf])
        rows = order[b:b + n].long()
        bb = bins_i32[rows].long()                                 # [n, Fp]
        cell = torch.arange(Fp, device=dev) * Bk + bb
        ok = (bb >= 0) & (bb < Bk)
        src = gh[rows].to(torch.float64)[:, None, :].expand(-1, Fp, -1)
        out.index_add_(0, cell[ok], src[ok])
    return out.to(torch.float32).t().reshape(NUM_CH, Fp, Bk)


def hist_grid(Fp: int, Bk: int):
    """(blocks over the list, tiles) of :func:`leaf_hist`'s grid: tiles of
    32 features x 16 bins, and HIST_BLOCKS blocks shared among them."""
    tiles = -(-Fp // TILE_LANES) * -(-Bk // TILE_BINS)
    return max(1, HIST_BLOCKS // tiles), tiles


def leaf_hist(bins_i32: torch.Tensor, gh: torch.Tensor, order: torch.Tensor,
              leaf_begin: torch.Tensor, leaf_rows: torch.Tensor,
              leaf: torch.Tensor, ds: torch.Tensor, *,
              num_bins: int) -> torch.Tensor:
    """The (grad, hess, count) planes [3, Fp, num_bins] f32 of the rows in
    leaf ``leaf``'s segment of ``order``: ``out[c, f, bins_i32[r, f]] +=
    gh[r, c]``, the f32 channels as given summed in f64 and rounded once
    (as the plain version), bins outside [0, num_bins) adding nothing; all
    zeros where ``ds`` ([1] bool) is false. ``gh`` is [R, 3] f32, ``leaf``
    [1] int64."""
    _check_state(order, leaf_begin, leaf_rows, leaf)
    _check_flag(ds)
    R = order.shape[0]
    _check_bins(bins_i32, R)
    if tuple(gh.shape) != (R, NUM_CH) or gh.dtype != torch.float32:
        raise ValueError(f"gh must be [{R}, 3] float32; got "
                         f"{tuple(gh.shape)} {gh.dtype}")
    if num_bins < 1:
        raise ValueError(f"num_bins must be positive; got {num_bins}")
    _same_device(order, bins_i32=bins_i32, gh=gh, leaf_begin=leaf_begin,
                 leaf_rows=leaf_rows, leaf=leaf, ds=ds)
    if order.device.type == "cpu":
        return leaf_hist_plain(bins_i32, gh, order, leaf_begin, leaf_rows,
                               leaf, ds, num_bins=num_bins)
    _require_cuda(bins_i32, gh, order, leaf_begin, leaf_rows, leaf, ds)
    import ctypes
    from .cuda_build import library
    dev = order.device
    Fp = bins_i32.shape[1]
    blocks, tiles = hist_grid(Fp, num_bins)
    out = torch.empty((NUM_CH, Fp, num_bins), dtype=torch.float32,
                      device=dev)
    # the blocks' partials and the tiles' arrival counters, this call's own
    # (the C entry zeroes the counters on the stream before the launch)
    part = torch.empty(blocks * tiles * TILE_CELLS, dtype=torch.float64,
                       device=dev)
    counter = torch.empty(tiles, dtype=torch.int32, device=dev)
    rc = library().lgbt_leaf_hist(
        bins_i32.data_ptr(), Fp, num_bins, gh.data_ptr(), order.data_ptr(),
        leaf_begin.data_ptr(), leaf_rows.data_ptr(), leaf.data_ptr(),
        ds.data_ptr(), part.data_ptr(), counter.data_ptr(), out.data_ptr(),
        blocks, _stream(dev))
    _raise_on(rc, "leaf_hist")
    cuda_launches["leaf_hist"] += 1
    launches["leaf_hist"] += 1
    return out
