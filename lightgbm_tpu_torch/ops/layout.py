"""Histogram-plane layout: how (feature, bin) pairs map onto the kernels'
flat axis (the padded layout of ``lightgbm_tpu/ops/layout.py``).

Every feature is widened to the global pow2 bin count ``Bp`` and the
feature count rounded so ``(F_oh * Bp) % 128 == 0``, exactly as the JAX
package lays it out, so both packages' histograms and route tables index
the same flat positions.  The adaptive ``PackedLayout`` is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

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
