#!/usr/bin/env python3
"""Where one boosting iteration of lightgbm_tpu_torch spends its time on
the card.

    python3 scripts/torch_profile.py [--rows 1000000] [--rounds 3]
                                     [--path train update frontier mixed cuts
                                             eval class rank cat bundle
                                             mono dart rf linear xla
                                             xla_depthwise]

Trains chip_smoke.py's configuration (1,000,000 x 28 rows of bench.py's
synthetic data, max_bin=63, num_leaves=255) with ``Booster.update()``,
once per ``--path`` in one process: ``train`` runs the fused engine's
megastep body (what ``train()`` runs), ``update`` its epilogue body (what
a bare ``update()`` loop runs), ``frontier`` the frontier-v1 engine
(``tpu_engine="frontier"``, the same body for both), ``mixed`` the megastep
body on chip_smoke.py's mixed-cardinality rows (columns 14-27 floored to 8
levels) and ``cuts`` the same with the histogram-plane cuts of its run (b)
(quant16, gain screening, adaptive bins), and ``eval`` the megastep body
with chip_smoke.py's 250,000-row valid set and ``metric=["binary_logloss",
"auc"]``, each iteration followed by ``eval_valid()`` as ``train()`` does
with callbacks (its phase 7 run a), and ``class`` chip_smoke.py's phase 8
runs but (b), one JSON line each: (a) ``multiclass`` with 5 classes on
the megastep body (5 trees per iteration), (c) GOSS on the synchronous
body (warmed up past iteration 1/learning_rate, so every traced iteration
samples), (d) by-node sampling with interaction constraints and (e)
``regression_l1`` with its leaf renewal, both on the synchronous body,
and (f) ``cross_entropy`` on the megastep body; ``rank`` chip_smoke.py's
phase 9 run (a), ``lambdarank`` on its MS-LTR-shaped queries (1,000,000
documents x 136 features, ``--rows`` documents) on the megastep body with
its 200,000-document valid set and ``metric=["ndcg", "map"]``, each
iteration followed by ``eval_valid()``; ``cat`` its phase 10 run (a), the
megastep body on phase 3's rows with columns 0-3 as category codes
(``categorical_feature=[0, 1, 2, 3]``); ``bundle`` its phase 11 runs, one
JSON line each: (a) the megastep body on the Allstate-shaped CSR draw
(``--rows`` rows, 4,228 columns, bundled at ingestion), (b) the epilogue
body on dense EFB (500,000 rows of 28 dense and 512 exclusive columns)
and (c) the epilogue body on one 4,033-bin bundle column (500,000 rows of
64 exclusive columns); ``mono`` its phase 12 runs, one JSON line each:
phase 3's rows binned with ``chip_smoke.mono_constraints``, (a) the basic
and (b) the intermediate mode on the megastep body, (c)
``monotone_penalty=2.0`` on the epilogue body; ``dart``, ``rf`` and
``linear`` its phase 13 runs (a)-(c), each on the synchronous body:
DART at LightGBM's drop defaults with ``drop_seed=4`` and RF (bagging
0.632 every iteration, feature_fraction 0.8), both with the 250,000-row
valid set and ``metric=["binary_logloss", "auc"]`` evaluated after every
iteration, and ``linear_tree`` regression on the latent score z with the
raw columns on the card; ``xla`` and ``xla_depthwise`` the XLA engine
(``tpu_engine="xla"``, its phase 14 runs (a) and (b) without their CEGB
costs: the leaf-wise and the depth-wise grower on the synchronous body,
the depth-wise levels and the leaf-wise roots through ``hist_pass``'s
unrounded f32 variant, each leaf-wise step through ``leaf_partition`` and
``leaf_hist`` on its listed rows). Each
warms up two iterations (GOSS ten), times
``--rounds`` more untraced, then traces ``--rounds`` more with
``torch.profiler`` and prints one JSON line: the wall time per iteration
untraced and traced, the device time summed over all kernels, the
device's busy share (device time over traced wall time), the device
launches per iteration,
each of the port's kernels' device ms per iteration (``level_pass``,
``route_pass``, ``epilogue_pass`` and ``hist_pass`` as the sums of their
CUDA kernels, each also on its own; the slab-table kernel the first three
share is split by launches; ``leaf_partition`` and ``leaf_hist``), the
port's CUDA kernel launches per iteration (``ops.fused_level.cuda_launches``
and ``ops.data_partition.cuda_launches``), the kernels ranked by
device time, and the host syncs per tree (the grower's, GOSS's copy of
|g·h|, leaf renewal's copies). Also prints the card's name and power
limit. Needs a CUDA device.
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
                             "cuts", "eval", "class", "rank", "cat",
                             "bundle", "mono", "dart", "rf", "linear",
                             "xla", "xla_depthwise"),
                    default=["train", "update", "frontier", "mixed",
                             "cuts", "eval", "class", "rank", "cat",
                             "bundle", "mono", "dart", "rf", "linear"])
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
    X, z, w = cs._class_rows(args.rows, cs.FEATURES, seed=cs.DATA_SEED)
    y = (z > 0).astype(np.float32)     # _make_data's labels
    params = {"objective": "binary", "max_bin": 63, "num_leaves": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 1, "verbose": -1,
              "device_type": "cuda"}
    ds = lgb.Dataset(X, label=y, params=params).construct()
    ds_mixed = None
    for path in args.path:
        if path == "class":
            for run, extra, labels, _, _ in cs.class_runs(z)[1]:
                if run == "b":
                    continue
                ds.set_label(labels)
                print(json.dumps(dict(
                    path=path, run=run, objective=extra["objective"],
                    boosting=extra.get("boosting", "gbdt"), nvidia_smi=smi,
                    **profile_path(lgb, frontier2, dict(params, **extra),
                                   ds, True, args.rounds,
                                   warmup=10 if run == "c" else 2))),
                    flush=True)
            ds.set_label(y)
            continue
        if path == "rank":
            Xr, yr, sr, Xv, yv, sv = cs.rank_data(args.rows,
                                                  cs.RANK_VALID_DOCS)
            p = dict(params, objective="lambdarank", metric=["ndcg", "map"],
                     eval_at=cs.RANK_EVAL_AT)
            d = lgb.Dataset(Xr, label=yr, group=sr, params=p).construct()
            valid = lgb.Dataset(Xv, label=yv, group=sv, reference=d)
            print(json.dumps(dict(path=path, nvidia_smi=smi, **profile_path(
                lgb, frontier2, p, d, True, args.rounds, valid))),
                flush=True)
            continue
        if path == "bundle":
            for run, make, megastep in (
                    ("a", lambda: cs._sparse_rows(args.rows,
                                                  cs.DATA_SEED + 500), True),
                    ("b", lambda: cs._exclusive_rows(
                        cs.EFB_ROWS, 28, cs.EFB_EXCLUSIVE,
                        cs.DATA_SEED + 600), False),
                    ("c", lambda: cs._exclusive_rows(
                        cs.EFB_ROWS, 0, cs.WIDE_MEMBERS,
                        cs.DATA_SEED + 700), False)):
                Xb, yb = make()
                d = lgb.Dataset(Xb, label=yb, params=params).construct()
                print(json.dumps(dict(
                    path=path, run=run, nvidia_smi=smi,
                    **cs._bundle_summary_of(d, params),
                    **profile_path(lgb, frontier2, params, d, megastep,
                                   args.rounds))), flush=True)
                del Xb, d
            continue
        if path == "mono":
            mono = cs.mono_constraints(w).tolist()
            d = lgb.Dataset(X, label=y, params=dict(
                params, monotone_constraints=mono)).construct()
            for run, extra, megastep in (
                    ("a", {}, True),
                    ("b", {"monotone_constraints_method": "intermediate"},
                     True),
                    ("c", {"monotone_penalty": cs.MONO_PENALTY}, False)):
                print(json.dumps(dict(
                    path=path, run=run, nvidia_smi=smi, **extra,
                    **profile_path(lgb, frontier2, dict(params, **extra), d,
                                   megastep, args.rounds))), flush=True)
            del d
            continue
        if path in ("dart", "rf", "linear"):
            metric = ["binary_logloss", "auc"]
            extra = {"dart": {"boosting": "dart",
                              "drop_seed": cs.DART_DROP_SEED,
                              "metric": metric},
                     "rf": {"boosting": "rf", "bagging_fraction": 0.632,
                            "bagging_freq": 1, "feature_fraction": 0.8,
                            "metric": metric},
                     "linear": {"objective": "regression",
                                "linear_tree": True, "linear_lambda": 0.1,
                                "metric": ["l2"]}}[path]
            p, d, valid = dict(params, **extra), ds, None
            if path == "linear":
                d = lgb.Dataset(X, label=z, params=dict(p)).construct()
            else:
                Xv, yv = cs._valid_rows(cs.VALID_ROWS, w,
                                        seed=cs.DATA_SEED + 100)
                valid = lgb.Dataset(Xv, label=yv, reference=ds)
            print(json.dumps(dict(path=path, nvidia_smi=smi, **profile_path(
                lgb, frontier2, p, d, False, args.rounds, valid))),
                flush=True)
            del d
            continue
        if path == "cat":
            cats = list(range(len(cs.CAT_CARDINALITIES)))
            d = lgb.Dataset(cs._cat_codes(X, cs.DATA_SEED + 400), label=y,
                            categorical_feature=cats,
                            params=params).construct()
            print(json.dumps(dict(path=path, nvidia_smi=smi, **profile_path(
                lgb, frontier2, params, d, True, args.rounds))), flush=True)
            continue
        p, d, valid = params, ds, None
        if path == "eval":
            p = dict(params, metric=["binary_logloss", "auc"])
            Xv, yv = cs._valid_rows(cs.VALID_ROWS, w, seed=cs.DATA_SEED + 100)
            valid = lgb.Dataset(Xv, label=yv, reference=ds)
        elif path == "frontier":
            p = dict(params, tpu_engine="frontier")
        elif path in ("xla", "xla_depthwise"):
            p = dict(params, tpu_engine="xla",
                     grow_policy=("depthwise" if path == "xla_depthwise"
                                  else "leafwise"))
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
            lgb, frontier2, p, d, path in ("train", "mixed", "cuts", "eval"),
            args.rounds, valid))), flush=True)
    return 0


def profile_path(lgb, frontier2, params, ds, megastep: bool, rounds: int,
                 valid=None, warmup: int = 2):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from lightgbm_tpu_torch.ops import data_partition as dp
    from lightgbm_tpu_torch.ops import fused_level as fl
    ds.params = {}   # a Booster keeps its params in its Dataset: no leaks
    bst = lgb.Booster(params=params, train_set=ds)
    if valid is not None:
        bst.add_valid(valid, "valid")
    bst._gbdt.arm_megastep(megastep)

    def step():
        bst.update()
        if valid is not None:
            bst.eval_valid()        # one fetch of the metric scalars
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):                 # untraced, as a caller runs it
        step()
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    frontier2.host_syncs["count"] = 0
    fl.reset_launch_counts()
    dp.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            step()
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
                 "hist_pass (all)": sum(kernel_ms[k]
                                        for k in fl.HIST_KERNELS),
                 **kernel_ms,
                 **{k: func_ms(f"{k}_kernel") for k in dp.cuda_launches}}
    kernel_ms["leaf_partition (all)"] = sum(kernel_ms[k]
                                            for k in dp.PARTITION_KERNELS)
    g = bst._gbdt
    k = g.num_tree_per_iteration
    return {
        "rows": ds._inner.num_data, "iterations": rounds,
        "trees_per_iter": k,
        "body": ("sync" if g._fast_path_reason() is not None else
                 "epilogue" if not megastep and g._use_epilogue() else
                 "megastep"),
        "valid_rows": valid._inner.num_data if valid is not None else 0,
        "engine": ("frontier" if g.use_frontier else
                   "fused" if g.use_fused else "xla"),
        "grow_policy": g.grow_policy,
        "quant_bits": g.quant_bits,
        "adaptive_bins": getattr(g, "fused_packed", None) is not None,
        "gain_screening": g.use_screening,
        "epilogue_body": bool(not megastep and bst._gbdt._use_epilogue()),
        "wall_ms_per_iter": wall * 1e3 / rounds,
        "untraced_wall_ms_per_iter": untraced * 1e3 / rounds,
        "device_ms_per_iter": dev_total_us / 1e3 / rounds,
        "device_busy_share": dev_total_us / 1e6 / wall,
        "host_syncs_per_tree": frontier2.host_syncs["count"] / (rounds * k),
        "device_launches_per_iter": sum(r[2] for r in rows) / rounds,
        "kernel_ms_per_iter": kernel_ms,
        "cuda_launches_per_iter": {k: v / rounds
                                   for k, v in {**fl.cuda_launches,
                                                **dp.cuda_launches}.items()},
        "top_device_ops": [{"name": k[:80], "calls_per_iter": c / rounds,
                            "ms_per_iter": d / 1e3 / rounds}
                           for d, k, c in rows[:15]]}


if __name__ == "__main__":
    sys.exit(main())
