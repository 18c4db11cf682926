#!/usr/bin/env python3
"""Where one boosting iteration of lightgbm_tpu_torch spends its time on
the card.

    python3 scripts/torch_profile.py [--rows 1000000] [--rounds 3]
                                     [--path train update frontier mixed cuts]

Trains chip_smoke.py's configuration (1,000,000 x 28 rows of bench.py's
synthetic data, max_bin=63, num_leaves=255) with ``Booster.update()``,
once per ``--path`` in one process: ``train`` runs the fused engine's
megastep body (what ``train()`` runs), ``update`` its epilogue body (what
a bare ``update()`` loop runs), ``frontier`` the frontier-v1 engine
(``tpu_engine="frontier"``, the same body for both), ``mixed`` the megastep
body on chip_smoke.py's mixed-cardinality rows (columns 14-27 floored to 8
levels) and ``cuts`` the same with the histogram-plane cuts of its run (b)
(quant16, gain screening, adaptive bins). Each warms up two
iterations, then traces ``--rounds`` more with ``torch.profiler`` and
prints one JSON line: the wall time per iteration, the device time summed
over all kernels, the device's busy share (device time over wall time),
the device launches per iteration, each of the port's kernels' device ms
per iteration (``level_pass``, ``route_pass`` and ``epilogue_pass`` as the
sums of their CUDA kernels, each also on its own; the slab-table kernel
they share is split by launches), the port's CUDA kernel launches per
iteration
(``ops.fused_level.cuda_launches``), the kernels ranked by device time,
and the grower's host syncs per tree. Also prints the card's name and
power limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--path", nargs="+",
                    choices=("train", "update", "frontier", "mixed",
                             "cuts"),
                    default=["train", "update", "frontier", "mixed",
                             "cuts"])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.models import frontier2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    X, y = cs._make_data(args.rows, cs.FEATURES, seed=cs.DATA_SEED)
    params = {"objective": "binary", "max_bin": 63, "num_leaves": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 1, "verbose": -1,
              "device_type": "cuda"}
    ds = lgb.Dataset(X, label=y, params=params).construct()
    ds_mixed = None
    for path in args.path:
        p, d = params, ds
        if path == "frontier":
            p = dict(params, tpu_engine="frontier")
        elif path in ("mixed", "cuts"):
            if ds_mixed is None:
                Xm = X.copy()
                Xm[:, cs.NARROW_FROM:] = np.floor(
                    Xm[:, cs.NARROW_FROM:] * 8.0) / 8.0
                ds_mixed = lgb.Dataset(Xm, label=y,
                                       params=params).construct()
            d = ds_mixed
            if path == "cuts":
                p = dict(params, **cs.KNOBS)
        print(json.dumps(dict(path=path, nvidia_smi=smi, **profile_path(
            lgb, frontier2, p, d, path in ("train", "mixed", "cuts"),
            args.rounds))), flush=True)
    return 0


def profile_path(lgb, frontier2, params, ds, megastep: bool, rounds: int):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from lightgbm_tpu_torch.ops import fused_level as fl
    ds.params = {}   # a Booster keeps its params in its Dataset: no leaks
    bst = lgb.Booster(params=params, train_set=ds)
    bst._gbdt.arm_megastep(megastep)
    for _ in range(2):
        bst.update()
    torch.cuda.synchronize()
    frontier2.host_syncs["count"] = 0
    fl.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            bst.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, memsets, copies): the CPU-side op
    # that launched a kernel reports the same time again as its own
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    dev_total_us = sum(r[0] for r in rows)
    def func_ms(name):
        return sum(d for d, key, _ in rows if name in key) / 1e3 / rounds
    # level_pass, route_pass and epilogue_pass each start with the same
    # slab-table kernel (level_slabs_kernel): its time is shared out by
    # launches
    slabs = [k for k in fl.cuda_launches if k.endswith("_slabs")]
    n_slabs = sum(fl.cuda_launches[k] for k in slabs) or 1
    slab_ms = func_ms("level_slabs_kernel")
    kernel_ms = {k: (slab_ms * fl.cuda_launches[k] / n_slabs
                     if k in slabs else func_ms(f"{k}_kernel"))
                 for k in fl.cuda_launches}
    kernel_ms = {"level_pass": sum(kernel_ms[k] for k in fl.LEVEL_KERNELS),
                 "route_pass (all)": sum(kernel_ms[k]
                                         for k in fl.ROUTE_KERNELS),
                 "epilogue_pass (all)": sum(kernel_ms[k]
                                            for k in fl.EPILOGUE_KERNELS),
                 **kernel_ms}
    g = bst._gbdt
    return {
        "rows": ds._inner.num_data, "iterations": rounds,
        "engine": "frontier" if g.use_frontier else "fused",
        "quant_bits": g.quant_bits,
        "adaptive_bins": getattr(g, "fused_packed", None) is not None,
        "gain_screening": g.use_screening,
        "epilogue_body": bool(not megastep and bst._gbdt._use_epilogue()),
        "wall_ms_per_iter": wall * 1e3 / rounds,
        "device_ms_per_iter": dev_total_us / 1e3 / rounds,
        "device_busy_share": dev_total_us / 1e6 / wall,
        "host_syncs_per_tree": frontier2.host_syncs["count"] / rounds,
        "device_launches_per_iter": sum(r[2] for r in rows) / rounds,
        "kernel_ms_per_iter": kernel_ms,
        "cuda_launches_per_iter": {k: v / rounds
                                   for k, v in fl.cuda_launches.items()},
        "top_device_ops": [{"name": k[:80], "calls_per_iter": c / rounds,
                            "ms_per_iter": d / 1e3 / rounds}
                           for d, k, c in rows[:15]]}


if __name__ == "__main__":
    sys.exit(main())
