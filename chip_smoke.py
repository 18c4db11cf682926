#!/usr/bin/env python3
"""Smoke run of lightgbm_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero (it prints no result line then):

1. environment and build: the card's name and power limit (nvidia-smi),
   torch and CUDA versions; the CUDA kernels built from ``csrc/``;
2. each kernel against its plain PyTorch version on the card, at the
   slice's shapes: Rp = 1,001,472 rows, 28 features, Bp=64 with int8 bins
   and Bp=256 with int16 bins, Sp in {8, max_slot_cap}, nch in {5, 3}, a
   255-entry lookup table; with the error, its tolerance and the times;
3. end to end: ``lightgbm_tpu_torch.train`` on 1,000,000 x 28 rows of
   ``bench.py``'s synthetic binary data (seed 1), the Higgs-shaped configuration
   (max_bin=63, num_leaves=255, learning_rate=0.1, min_data_in_leaf=1),
   10 rounds: sec/iter, training AUC (> 0.75), the kernels' launch counts
   (each > 0), and ``Booster.predict`` against the trainer's scores;
4. the ``kernels`` line: every ported kernel with its launches on the main
   path, error, time, plain time, bound and library time;
5. the last line: ``{"ok": true, "device": {...}}``.

It imports neither JAX nor the JAX package. It exits non-zero when no CUDA
device is present.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
ROWS = 1_000_000
FEATURES = 28
ROUNDS = 10
# bench.py's generator draws the label weights after the rows, so they
# depend on the row count: at 1,000,000 x 28 seed 0 makes 29 positive rows,
# seed 1 makes 34% positive
DATA_SEED = 1
DEVICE = "cuda"   # the card; a rehearsal on the CPU may set "cpu"
REPLACES = {
    "level_pass": "lightgbm_tpu/ops/fused_level.py:402",
    "route_pass": "lightgbm_tpu/ops/fused_level.py:575",
    "table_lookup": "lightgbm_tpu/ops/fused_level.py:811",
}
SOURCES = {
    "level_pass": "lightgbm_tpu_torch/csrc/level_pass.cu",
    "route_pass": "lightgbm_tpu_torch/csrc/route_pass.cu",
    "table_lookup": "lightgbm_tpu_torch/csrc/table_lookup.cu",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _make_data(n_rows: int, n_feat: int, seed: int = 0):
    # the synthetic binary data of bench.py (copied, not imported)
    rng = np.random.RandomState(seed)
    X = rng.rand(n_rows, n_feat).astype(np.float32)
    w = rng.randn(n_feat).astype(np.float32)
    y = (X @ w + 0.5 * rng.randn(n_rows) > 0).astype(np.float32)
    return X, y


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median of per-call CUDA-event times (ms)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _level_inputs(Rp, R, B, Sp, nch, seed):
    """Random level-pass operands at the slice's layout: every real row in
    one of Sp leaves, Sp-1 active slots (the last inactive), missing types
    None/Zero/NaN across features."""
    import torch
    from lightgbm_tpu_torch.ops import fused_level as fl
    dev = torch.device(DEVICE)
    rng = np.random.RandomState(seed)
    F = FEATURES
    nb = np.full(F, B - 1, np.int32)
    mt = rng.randint(0, 3, F).astype(np.int32)
    db = rng.randint(0, B - 2, F).astype(np.int32)
    bins = np.zeros((F, Rp), np.int64)
    bins[:, :R] = rng.randint(0, B - 1, (F, R))
    dt = torch.int8 if B <= 128 else torch.int16
    bins_T = torch.as_tensor(bins, device=dev).to(dt)
    leaf = np.full(Rp, -1, np.int32)
    leaf[:R] = rng.randint(0, Sp, R)
    leaf_T = torch.as_tensor(leaf[None, :], device=dev)
    g = np.zeros(Rp, np.float32)
    h = np.zeros(Rp, np.float32)
    w = np.zeros(Rp, np.float32)
    g[:R] = rng.randn(R)
    h[:R] = rng.rand(R) * 0.25
    w[:R] = 1.0
    gh_T = fl.pack_gh(torch.as_tensor(g, device=dev),
                      torch.as_tensor(h, device=dev),
                      torch.as_tensor(w, device=dev), nch)
    lof = np.arange(Sp, dtype=np.int32)
    lof[-1] = -2
    feat = np.where(lof >= 0, rng.randint(0, F, Sp), -1).astype(np.int32)
    thr = rng.randint(0, B - 2, Sp).astype(np.int32)
    dl = rng.rand(Sp) < 0.5
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    W = fl.build_route_table(t(feat), t(thr), t(dl), t(nb), t(mt), t(db),
                             Sp, F, B)
    tbl = np.zeros((Sp, 128), np.int32)
    tbl[:, 0] = lof
    tbl[:, 1] = np.where(lof >= 0, Sp, 0)
    tbl[:, 2] = rng.randint(0, 2, Sp)
    return bins_T, leaf_T, gh_T, W, t(tbl)


def check_level(Rp, R, B, Sp, nch, seed):
    """level_pass and route_pass against their plain versions."""
    import torch
    from lightgbm_tpu_torch.ops import fused_level as fl
    bins_T, leaf_T, gh_T, W, tbl = _level_inputs(Rp, R, B, Sp, nch, seed)
    F = FEATURES
    kw = dict(num_bins=B, f_oh=F)
    n0 = dict(fl.launches)
    hist_k, leaf_k = fl.level_pass(bins_T, leaf_T, gh_T, W, tbl, nch=nch,
                                   **kw)
    hist_p, leaf_p = fl.level_pass_plain(bins_T, leaf_T, gh_T, W, tbl,
                                         nch=nch, **kw)
    route_k = fl.route_pass(bins_T, leaf_T, W, tbl, **kw)
    route_p = fl.route_pass_plain(bins_T, leaf_T, W, tbl, **kw)
    torch.cuda.synchronize()
    leaf_err = int((leaf_k - leaf_p).abs().max())
    route_err = int((route_k - route_p).abs().max())
    if leaf_err:
        raise AssertionError(f"level_pass new_leaf differs (B={B} Sp={Sp})")
    if route_err:
        raise AssertionError(f"route_pass new_leaf differs (B={B} Sp={Sp})")
    # per channel plane: atomics reorder the f32 sums, so the tolerance is
    # relative to the plane's largest magnitude; the weight channel counts
    # rows and must be exact
    rel = 0.0
    abs_err = 0.0
    for ch in range(nch):
        k = hist_k[:, ch * Sp:(ch + 1) * Sp]
        p = hist_p[:, ch * Sp:(ch + 1) * Sp]
        err = float((k - p).abs().max())
        abs_err = max(abs_err, err)
        if ch == nch - 1:
            if err != 0.0:
                raise AssertionError(f"weight channel differs by {err}")
        else:
            scale = float(p.abs().max()) or 1.0
            rel = max(rel, err / scale)
    if rel > 1e-5:
        raise AssertionError(f"level_pass hist rel err {rel} > 1e-5")

    C = nch * Sp
    FB = F * B
    # bytes each function must move: bins (F per row), leaf in/out, the nch
    # channels, W, tbl, the histogram out; ops: F gather-adds per row plus
    # F*nch adds per smaller-child row (this run's count)
    bb = bins_T.element_size()
    n_small = float(hist_p[:B, C - Sp:].sum())   # rows counted in feature 0
    lvl_bytes = (Rp * (F * bb + 4 + 2 * nch + 4) + W.numel() * 2
                 + tbl.numel() * 4 + FB * C * 4)
    lvl_ops = Rp * F + n_small * F * nch
    rt_bytes = Rp * (F * bb + 8) + W.numel() * 2 + tbl.numel() * 4
    lvl_bound, lvl_by = bound(lvl_bytes, lvl_ops)
    rt_bound, rt_by = bound(rt_bytes, Rp * F)
    lvl_ms = cuda_ms(lambda: fl.level_pass(bins_T, leaf_T, gh_T, W, tbl,
                                           nch=nch, **kw))
    rt_ms = cuda_ms(lambda: fl.route_pass(bins_T, leaf_T, W, tbl, **kw))
    out = {
        "B": B, "bins": str(bins_T.dtype).replace("torch.", ""), "Sp": Sp,
        "nch": nch,
        "launches": {k: fl.launches[k] - n0[k] for k in n0},
        "level_pass": {
            "new_leaf_max_abs_err": leaf_err, "hist_max_abs_err": abs_err,
            "hist_max_rel_err": rel, "tol_rel": 1e-5,
            "weight_channel_exact": True,
            "kernel_ms": lvl_ms,
            "plain_ms": cuda_ms(lambda: fl.level_pass_plain(
                bins_T, leaf_T, gh_T, W, tbl, nch=nch, **kw), reps=3,
                warmup=1),
            "library_ms": None, "bound_ms": lvl_bound, "bound_by": lvl_by},
        "route_pass": {
            "max_abs_err": route_err, "tol": 0, "kernel_ms": rt_ms,
            "plain_ms": cuda_ms(lambda: fl.route_pass_plain(
                bins_T, leaf_T, W, tbl, **kw), reps=3, warmup=1),
            "library_ms": None, "bound_ms": rt_bound, "bound_by": rt_by},
    }
    return out


def check_lookup(Rp, R, L, seed):
    import torch
    from lightgbm_tpu_torch.ops import fused_level as fl
    dev = torch.device(DEVICE)
    rng = np.random.RandomState(seed)
    idx = np.full(Rp, -1, np.int32)
    idx[:R] = rng.randint(0, L, R)
    idx_T = torch.as_tensor(idx[None, :], device=dev)
    table = torch.as_tensor(rng.randn(L).astype(np.float32), device=dev)
    n0 = fl.launches["table_lookup"]
    out_k = fl.table_lookup(idx_T, table)
    out_p = fl.table_lookup_plain(idx_T, table)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    if err != 0.0:
        raise AssertionError(f"table_lookup differs by {err}")
    flat = idx_T[0].clamp(min=0).long()
    b, by = bound(Rp * 8 + L * 4, 0)
    kernel_ms = cuda_ms(lambda: fl.table_lookup(idx_T, table))
    return {
        "Rp": Rp, "L": L, "max_abs_err": err, "tol": 0,
        "launches": fl.launches["table_lookup"] - n0,
        "kernel_ms": kernel_ms,
        "plain_ms": cuda_ms(lambda: fl.table_lookup_plain(idx_T, table)),
        "library_ms": cuda_ms(lambda: torch.take(table, flat)),
        "bound_ms": b, "bound_by": by}


def auc(scores: np.ndarray, y: np.ndarray) -> float:
    order = np.argsort(scores, kind="stable")
    ranks = np.empty(len(scores), np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = y > 0
    n_pos = pos.sum()
    n_neg = len(y) - n_pos
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.models import frontier2
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops import fused_level as fl
    from lightgbm_tpu_torch.ops.layout import feature_layout

    # ---- 1. environment and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    cuda_build.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in str(cuda_build.build_info.get(
        "ptxas", "")).splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "build_s": build_s, "nvcc_build_s": cuda_build.build_info.get(
              "seconds"), "ptxas": ptxas})

    # ---- 2. kernels against their plain versions at the slice's shapes
    Rp = ((ROWS + 2047) // 2048) * 2048
    checks = []
    main_cfg = None
    for B in (64, 256):
        for nch in (fl.NCH_PRECISE, fl.NCH_FAST):
            cap = fl.max_slot_cap(FEATURES * B, nch)
            for Sp in sorted({8, cap}):
                res = check_level(Rp, ROWS, B, Sp, nch, seed=B + Sp + nch)
                emit({"phase": "kernel_check", **res})
                checks.append(res)
                if B == 64 and nch == fl.NCH_PRECISE and Sp == cap:
                    main_cfg = res
    lookup = check_lookup(Rp, ROWS, 255, seed=7)
    emit({"phase": "kernel_check", "table_lookup": lookup})

    # ---- 3. end to end through lightgbm_tpu_torch.train
    X, y = _make_data(ROWS, FEATURES, seed=DATA_SEED)
    params = {"objective": "binary", "max_bin": 63, "num_leaves": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 1,
              "min_sum_hessian_in_leaf": 1e-3, "verbose": -1,
              "device_type": "cuda"}
    t0 = time.perf_counter()
    ds = lgb.Dataset(X, label=y, params=params).construct()
    construct_s = time.perf_counter() - t0
    F_oh, Bp = feature_layout(ds._inner.num_features, ds._inner.max_num_bin)

    def timed_train(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        b = lgb.train(params, ds, num_boost_round=rounds)
        torch.cuda.synchronize()
        return b, time.perf_counter() - t

    timed_train(1)                        # warm-up (allocator, library)
    _, t_one = timed_train(1)
    fl.reset_launch_counts()
    frontier2.host_syncs["count"] = 0
    bst, t_all = timed_train(ROUNDS)      # the main path
    launches = dict(fl.launches)
    syncs = frontier2.host_syncs["count"]
    n_trees = bst.num_trees()
    scores = bst.train_scores().float().cpu().numpy()
    train_auc = auc(scores, y)
    pred = bst.predict(X[:100_000], raw_score=True)
    pred_err = float(np.abs(pred - scores[:100_000]).max())
    ok_pred = bool(np.allclose(pred, scores[:100_000], rtol=1e-5,
                               atol=1e-5))
    e2e = {"phase": "end_to_end", "rows": ROWS, "features": FEATURES,
           "F_oh": F_oh, "Bp": Bp, "rounds": ROUNDS, "trees": n_trees,
           "construct_s": construct_s,
           "sec_per_iter_after_first": (t_all - t_one) / (ROUNDS - 1),
           "train_s": t_all, "train_auc": train_auc,
           "launches": launches, "host_syncs_per_tree": syncs / n_trees,
           "predict_max_abs_err": pred_err, "predict_tol":
           "rtol=1e-5 atol=1e-5", "leaves": [m.num_leaves
                                              for m in bst.models]}
    emit(e2e)
    if n_trees != ROUNDS:
        raise AssertionError(f"trained {n_trees} trees, wanted {ROUNDS}")
    if not train_auc > 0.75:
        raise AssertionError(f"training AUC {train_auc} <= 0.75")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    if not ok_pred:
        raise AssertionError(f"predict differs from the trainer's scores "
                             f"by {pred_err}")

    # ---- 4. the kernels line (level/route at Bp=64 int8, nch=5, Sp=64)
    lv, rt = main_cfg["level_pass"], main_cfg["route_pass"]
    rows = []
    for name, r, err in (("level_pass", lv, lv["hist_max_abs_err"]),
                         ("route_pass", rt, rt["max_abs_err"]),
                         ("table_lookup", lookup, lookup["max_abs_err"])):
        rows.append({"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": REPLACES[name], "launches": launches[name],
                     "max_abs_err": err, "ms": r["kernel_ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    emit({"kernels": rows})

    # ---- 5. the result line
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
