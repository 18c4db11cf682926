#!/usr/bin/env python3
"""Least time the H100 could take for a TPU kernel that the port has not
run yet, at the shapes the main path would give it (arithmetic only, no
card needed):

    python3 scripts/kernel_bounds.py

Prints one JSON line per kernel with the bytes it must move (each input
read once, each output written once), the operations it must do, and the
larger of the two times over chip_smoke.py's H100 rates. Today: the
frontier-v1 histogram ``_hist_kernel`` (lightgbm_tpu/ops/pallas_histogram.py
:60) at the Higgs-shaped cell as ``tpu_engine="frontier"`` would run it:
R = 1,000,000 rows, Fp = 28 features, Bp = 64 bins, Sp = 64 slots, nch = 3
(g, h, w) f32 channels, int32 row-major bins and slot.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def hist_kernel_bound(R=1_000_000, Fp=28, Bp=64, Sp=64, nch=3):
    per_row = Fp * 4 + nch * 4 + 4          # int32 bins, f32 gh, int32 slot
    out = nch * Sp * Fp * Bp * 4            # [nch*Sp, Fp*Bp] f32
    nbytes = R * per_row + out
    nops = R * Fp * nch                     # one add per channel and feature
    ms, by = cs.bound(nbytes, nops)
    return {"name": "_hist_kernel",
            "replaces": "lightgbm_tpu/ops/pallas_histogram.py:60",
            "shape": {"R": R, "Fp": Fp, "Bp": Bp, "Sp": Sp, "nch": nch},
            "bytes_per_row": per_row, "bytes": nbytes, "ops": nops,
            "bound_ms": ms, "bound_by": by}


if __name__ == "__main__":
    print(json.dumps(hist_kernel_bound()))
