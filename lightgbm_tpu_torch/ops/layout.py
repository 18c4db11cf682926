"""Histogram-plane layout: how (feature, bin) pairs map onto the kernels'
flat axis (numpy copy of ``lightgbm_tpu/ops/layout.py``).

Two layouts, as in the JAX package, so both packages' histograms and route
tables index the same flat positions:

- **padded** (:func:`feature_layout`): every feature widened to the global
  pow2 bin count ``Bp`` and the feature count rounded so
  ``(F_oh * Bp) % 128 == 0``;
- **packed** (:func:`packed_feature_layout`, ``tpu_adaptive_bins``): each
  feature gets its own pow2 width ``>= its bin count``, features are
  grouped by width class (widest first) and each class region is padded to
  128. ``bins_T``'s rows are permuted into ``feat_order``; kernel row ``j``
  holds logical feature ``feat_order[j]`` and its slab starts at
  ``flat_offsets[j]``. It is a pure re-indexing: each (feature, bin) sum is
  the padded layout's, at another flat position.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np

LANE = 128
MIN_WIDTH = 8   # a feature slab is never narrower


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def feature_layout(num_features: int, max_bin: int) -> Tuple[int, int]:
    """(F_oh, Bp) with Bp = pow2 >= max_bin and (F_oh * Bp) % 128 == 0.

    F_oh is the one-hot feature count (>= num_features); padded features
    carry bin 0 everywhere and are masked out of the split scan.
    """
    Bp = max(MIN_WIDTH, _next_pow2(max_bin))
    quota = max(1, LANE // min(Bp, LANE))
    F_oh = _round_up(max(num_features, 1), quota)
    return F_oh, Bp


@dataclasses.dataclass(frozen=True)
class PackedLayout:
    """Adaptive per-feature bin packing (hashable, so it keys caches).

    ``classes``: ordered (width, count) groups; ``feat_order``: the logical
    feature of each kernel row; ``widths``: each kernel row's slab width;
    ``fb``: the packed flat width (% 128 == 0). ``f_oh``/``bp`` keep the
    logical padded layout that split search, pools and route tables use.
    """
    classes: Tuple[Tuple[int, int], ...]
    feat_order: Tuple[int, ...]
    widths: Tuple[int, ...]
    fb: int
    f_oh: int
    bp: int

    @functools.cached_property
    def flat_offsets(self) -> np.ndarray:
        """[len(feat_order)] flat offset of each kernel row's slab."""
        offs = np.zeros(len(self.feat_order), np.int64)
        o = 0
        j = 0
        for w, cnt in self.classes:
            for _ in range(cnt):
                offs[j] = o
                o += w
                j += 1
            o = _round_up(o, LANE)
        return offs

    @functools.cached_property
    def padded_to_packed(self) -> np.ndarray:
        """[f_oh * bp] -> packed flat index (0 where invalid)."""
        idx = np.zeros(self.f_oh * self.bp, np.int32)
        for j, f in enumerate(self.feat_order):
            w = self.widths[j]
            o = int(self.flat_offsets[j])
            idx[f * self.bp: f * self.bp + w] = o + np.arange(w)
        return idx

    @functools.cached_property
    def padded_valid(self) -> np.ndarray:
        """[f_oh * bp] bool: the position exists in the packed layout."""
        v = np.zeros(self.f_oh * self.bp, bool)
        for j, f in enumerate(self.feat_order):
            v[f * self.bp: f * self.bp + self.widths[j]] = True
        return v

    @functools.cached_property
    def packed_to_padded(self) -> np.ndarray:
        """[fb] -> padded flat index (0 where class padding)."""
        idx = np.zeros(self.fb, np.int32)
        for j, f in enumerate(self.feat_order):
            w = self.widths[j]
            o = int(self.flat_offsets[j])
            idx[o:o + w] = f * self.bp + np.arange(w)
        return idx

    @functools.cached_property
    def packed_valid(self) -> np.ndarray:
        """[fb] bool: the position belongs to a kernel row's slab."""
        v = np.zeros(self.fb, bool)
        for j in range(len(self.feat_order)):
            o = int(self.flat_offsets[j])
            v[o:o + self.widths[j]] = True
        return v

    @functools.cached_property
    def feat_of_packed(self) -> np.ndarray:
        """[fb] logical feature id per packed position (0 where pad)."""
        f = np.zeros(self.fb, np.int32)
        for j, fid in enumerate(self.feat_order):
            o = int(self.flat_offsets[j])
            f[o:o + self.widths[j]] = fid
        return f


def packed_feature_layout(num_bin_per_feat, max_bin: int,
                          f_oh: Optional[int] = None) -> PackedLayout:
    """Adaptive layout from per-feature bin counts: pow2 width classes
    (>= MIN_WIDTH), widest first; padding features (num_bin <= 0) are left
    out of the kernel layout (their decoded planes are zero)."""
    nb = np.asarray(num_bin_per_feat, np.int64)
    F = int(nb.shape[0])
    Fp, Bp = feature_layout(F, max_bin)
    if f_oh is None:
        f_oh = Fp
    widths_all = np.where(nb > 0,
                          np.maximum(MIN_WIDTH,
                                     2 ** np.ceil(np.log2(
                                         np.maximum(nb, 2))).astype(np.int64)),
                          0)
    classes = []
    feat_order = []
    widths = []
    for w in sorted({int(x) for x in widths_all if x > 0}, reverse=True):
        feats = [int(f) for f in np.nonzero(widths_all == w)[0]]
        classes.append((w, len(feats)))
        feat_order.extend(feats)
        widths.extend([w] * len(feats))
    fb = 0
    for w, cnt in classes:
        fb = _round_up(fb + w * cnt, LANE)
    fb = max(fb, LANE)
    return PackedLayout(classes=tuple(classes), feat_order=tuple(feat_order),
                        widths=tuple(widths), fb=int(fb), f_oh=int(f_oh),
                        bp=int(Bp))

