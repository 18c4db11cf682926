"""Exclusive Feature Bundling — bundling algorithm + encoding.

A copy of ``lightgbm_tpu/ops/efb.py`` (numpy only, so the bundles, the
layout and the encoded matrix equal the JAX package's list for list and
byte for byte). Analog of the reference's EFB (ref: src/io/dataset.cpp
FindGroups / FastFeatureBundling: sparse, mutually-exclusive features share
one stored column so histogram work scales with bundles, not features):
greedy conflict-bounded bundling, the bundle-column encoding, and the
logical-view reconstruction that turns a bundle histogram back into
per-feature histograms (the FixHistogram default-bin trick,
dataset.cpp:1265). The fused grower reads bundle columns through the route
tables of ``ops/fused_level.build_route_table_bundled`` and the plane views
of ``bundle_plane_views``.

Encoding (our own, simpler than the reference's offset scheme):
- bundle bin 0 = the row is default (most-frequent bin) in EVERY bundled
  feature;
- feature j owns the window [offset_j, offset_j + num_bin_j): a row
  non-default in j stores offset_j + bin_j(row);
- conflicts (non-default in several features) keep the first feature's
  encoding — allowed up to ``max_conflict_rate`` like the reference.

Reconstruction: the window copy recovers every non-default bin; the
feature's default bin gets ``total - sum(window)`` so masses are exact
for conflict-free rows.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

if hasattr(np, "bitwise_count"):
    _popcount = np.bitwise_count          # NumPy >= 2.0
else:
    # NumPy 1.x fallback: byte-view + unpackbits popcount
    def _popcount(a: np.ndarray) -> np.ndarray:
        return np.unpackbits(a.view(np.uint8)).reshape(a.shape + (64,)) \
            .sum(axis=-1, dtype=np.int64)


def find_bundles(nondefault_masks: Sequence[np.ndarray], num_rows: int,
                 max_conflict_rate: float = 0.0001,
                 max_bundle_bins: int = 65535,
                 num_bin_per_feat: Sequence[int] = None,
                 max_search_bundles: int = 64) -> List[List[int]]:
    """Greedy conflict-bounded bundling (ref: dataset.cpp:108-176
    FindGroups).

    Args:
      nondefault_masks: per-feature boolean [R] arrays (True where the row
        is NOT in the feature's most-frequent bin).
      max_conflict_rate: allowed fraction of rows in conflict per bundle
        (the reference's single_val_max_conflict_cnt is
        total_sample_cnt/10000 — rate 1e-4, the default here).
      max_search_bundles: candidate bundles tried per feature before a new
        one opens (the reference's FindGroups bounds its search the same
        way, max_find_group cap) — keeps the greedy near-linear on
        many-thousand-feature sparse data.

    A feature joins a bundle only when its conflict count also stays
    under HALF its own non-zero count (ref: dataset.cpp:155
    ``cnt <= cur_non_zero_cnt / 2``) — a feature that collides on most
    of its mass would lose its signal to the first-writer-wins encode.

    Returns a list of bundles (lists of feature indices). Dense features
    end up in singleton bundles. Conflict masks are packed uint64 bitsets
    so each probe is a popcount over R/64 words, not R bools.
    """
    F = len(nondefault_masks)
    counts = [int(m.sum()) for m in nondefault_masks]
    order = sorted(range(F), key=lambda f: counts[f], reverse=True)
    budget = int(max_conflict_rate * num_rows)
    words = (num_rows + 63) // 64

    def pack(m):
        return np.packbits(m, bitorder="little")[: words * 8] \
            .copy().view(np.uint64) if len(m) else np.zeros(0, np.uint64)

    bundle_masks: List[np.ndarray] = []
    bundle_conflicts: List[int] = []
    bundle_bins: List[int] = []
    bundles: List[List[int]] = []
    nb = num_bin_per_feat
    for f in order:
        nnz = counts[f]
        f_bins = int(nb[f]) if nb is not None else 1
        placed = False
        packed = None
        # skip bundling for dense features (no savings, conflicts certain)
        if nnz * 2 < num_rows:
            packed = pack(np.pad(nondefault_masks[f],
                                 (0, words * 64 - num_rows)))
            # most-recent bundles first: they are the least full
            cand = range(len(bundles) - 1,
                         max(-1, len(bundles) - 1 - max_search_bundles), -1)
            for bi in cand:
                if bundle_bins[bi] + f_bins > max_bundle_bins:
                    continue  # keep the encoded bin range in dtype bounds
                conflicts = int(_popcount(
                    bundle_masks[bi] & packed).sum())
                if bundle_conflicts[bi] + conflicts <= budget \
                        and conflicts * 2 <= nnz:
                    bundles[bi].append(f)
                    bundle_masks[bi] |= packed
                    bundle_conflicts[bi] += conflicts
                    bundle_bins[bi] += f_bins
                    placed = True
                    break
        if not placed:
            if packed is None:
                packed = pack(np.pad(nondefault_masks[f],
                                     (0, words * 64 - num_rows)))
            bundles.append([f])
            bundle_masks.append(packed.copy())
            bundle_conflicts.append(0)
            bundle_bins.append(1 + f_bins)
    return bundles


class BundleLayout:
    """Column layout for one bundling of F logical features.

    Attributes:
      bundles: list of feature-index lists.
      col_of_feat / offset_of_feat: [F] arrays mapping each logical
        feature to its physical column and bin offset.
      col_num_bin: bins per physical column (1 shared default bin +
        each member's window).
    """

    def __init__(self, bundles: List[List[int]],
                 num_bin_per_feat: Sequence[int]):
        F = len(num_bin_per_feat)
        self.bundles = bundles
        self.col_of_feat = np.full(F, -1, np.int32)
        self.offset_of_feat = np.zeros(F, np.int32)
        self.col_num_bin: List[int] = []
        for ci, b in enumerate(bundles):
            off = 1  # bin 0 = default-in-all
            for f in b:
                self.col_of_feat[f] = ci
                self.offset_of_feat[f] = off
                off += int(num_bin_per_feat[f])
            self.col_num_bin.append(off)

    @property
    def num_columns(self) -> int:
        return len(self.bundles)


def encode_bundles(bins: np.ndarray, default_bins: Sequence[int],
                   layout: BundleLayout) -> np.ndarray:
    """[R, F] logical bins -> [R, C] bundle-column bins."""
    R = bins.shape[0]
    C = layout.num_columns
    dtype = np.uint16 if max(layout.col_num_bin) > 255 else np.uint8
    out = np.zeros((R, C), dtype)
    for ci, bundle in enumerate(layout.bundles):
        col = np.zeros(R, np.int64)
        taken = np.zeros(R, bool)
        for f in bundle:
            b = bins[:, f].astype(np.int64)
            nd = (b != default_bins[f]) & ~taken
            col[nd] = layout.offset_of_feat[f] + b[nd]
            taken |= nd
        out[:, ci] = col.astype(dtype)
    return out


def logical_histograms(bundle_hist: np.ndarray, totals: np.ndarray,
                       layout: BundleLayout,
                       num_bin_per_feat: Sequence[int],
                       default_bins: Sequence[int],
                       max_bin: int) -> np.ndarray:
    """[S, C, B_col, ch] bundle histograms -> [S, F, max_bin, ch] logical
    views. Each feature's window is copied and its default bin receives
    ``totals - sum(window)`` (FixHistogram, ref: dataset.cpp:1265).

    totals: [S, ch] per-slot leaf sums.
    """
    S = bundle_hist.shape[0]
    ch = bundle_hist.shape[-1]
    F = len(num_bin_per_feat)
    out = np.zeros((S, F, max_bin, ch), bundle_hist.dtype)
    for f in range(F):
        ci = layout.col_of_feat[f]
        off = layout.offset_of_feat[f]
        nb = int(num_bin_per_feat[f])
        win = bundle_hist[:, ci, off:off + nb, :]
        out[:, f, :nb, :] = win
        missing = totals - win.sum(axis=1)
        out[:, f, default_bins[f], :] += missing
    return out
