#!/usr/bin/env python3
"""Smoke run of lightgbm_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero (it prints no result line then):

1. environment and build: the card's name and power limit (nvidia-smi),
   torch and CUDA versions; the CUDA kernels built from ``csrc/``, with
   each kernel instance's registers, spills and shared memory (ptxas);
   then the instructions the epilogue's histogram stage compiled to
   (cuobjdump: no matrix instruction, no atomic; PERF.md has the
   tensor-core design it replaced);
2. each kernel against its plain PyTorch version on the card, at the
   slices' shapes: Rp = 1,001,472 rows, 28 features, Bp=64 with int8 bins
   and Bp=256 with int16 bins, Sp in {8, max_slot_cap}, nch in {5, 3}, a
   255-entry lookup table; ``route_pass`` also on a route table with a
   row over two slabs and an all-zero row; ``epilogue_pass`` also for
   kind binary and l2, on such a route table for each Bp and nch, and
   once with an all-inactive deferred table, with ~30% zero bag weights,
   and each of its CUDA kernels timed alone at the main shape;
   ``hist_pass`` at R = 1,000,000 rows, Fp = 28, Bp in {64, 256},
   S in {8, 64}, f32 (nch 3) and quantized to 8 bits (nch 3) and 16 bits
   (nch 5), ~30% of rows at slot -1 with non-zero gh; the histogram-plane
   variants of ``level_pass`` (quantized to 8 and 16 bits, packed,
   masked, and all three at once as run (b) of phase 6 runs them; f32
   padded on the same rows as their yardstick) and the packed
   ``route_pass`` at Rp = 1,001,472, F_oh = 28, Bp = 64, Sp in {8, 64} on
   the mixed-cardinality layout of phase 6 (14 features of 63 bins, 14 of
   8), each quantized plane also against the other layout's after
   unpacking; with the errors, their tolerances, each kernel's device
   time per launch (``cuda_ms``: a CUDA graph of 20 calls replayed),
   each ``level_pass`` stage's time alone and its histogram tile;
3. end to end through ``lightgbm_tpu_torch.train`` on 1,000,000 x 28 rows
   of ``bench.py``'s synthetic binary data (seed 1), the Higgs-shaped
   configuration (max_bin=63, num_leaves=255, learning_rate=0.1,
   min_data_in_leaf=1), 10 rounds (the megastep body): sec/iter, training
   AUC (> 0.75), the kernels' launch counts (level_pass, route_pass and
   table_lookup each > 0), and ``Booster.predict`` against the trainer's
   scores;
4. the loop ``bench.py`` times, ``Booster(params, train_set)`` then
   ``update()`` (the epilogue body), on the same dataset: 2 warm-up and 10
   timed updates, (a) as bench.py has it, twice, in turns with the same
   loop on the megastep body (m) that ``train()`` runs, and (b) with
   bagging_fraction=0.5, bagging_freq=1, feature_fraction=0.8: sec/iter,
   AUC (> 0.75), leaves, predict agreement, host syncs per tree, every
   kernel's launches (epilogue_pass > 0 on the epilogue body);
5. the frontier-v1 engine end to end: ``train()`` with
   ``tpu_engine="frontier"`` on the same dataset and parameters, 10 rounds:
   sec/iter after the first round, AUC (> 0.75), leaves per tree,
   ``hist_pass`` launches (> 0) and no launch of the fused engine's
   kernels, host syncs per tree, and ``Booster.predict`` against the
   trainer's scores;
6. the histogram-plane cuts end to end (``plane_cuts_train``): ``train()``
   on the same rows with columns 14-27 floored to 8 levels (bench.py's
   all-cuts leg), 10 rounds each of (a) f32 with no cuts, (b) quant16 +
   gain screening + adaptive bins (tests/test_hist_plane.py's KNOBS), (c)
   quant8 alone, and (d) quant16, (e) adaptive bins, (f) gain screening,
   each alone: sec/iter, launches per tree by kernel and variant (on the
   card exactly the megastep schedule of a full 255-leaf tree), host
   syncs per tree, AUC (within 0.05 of run a), predict agreement, the
   packed flat width against F_oh * Bp, the features screening keeps;
7. the ``kernels`` line: every ported kernel and variant with its
   wrapper calls and CUDA kernel launches on the main path where it runs
   (every level_pass, route_pass and epilogue_pass call in phases 3-6
   held to one launch of each of its CUDA kernels), error, time per
   launch, plain time, bound and library time, and per-kernel times of
   ``level_pass`` and ``epilogue_pass``;
8. the last line: ``{"ok": true, "device": {...}}``.

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
UPDATES = 10
WARMUP_UPDATES = 2
TRAIN_PATH_KERNELS = ("level_pass", "route_pass", "table_lookup")
FRONTIER_KERNELS = ("hist_pass",)
# bench.py's all-cuts leg: columns 14-27 floored to 8 levels (8 bins each)
NARROW_FROM = 14
PLANE_NUM_BIN = np.array([63] * NARROW_FROM + [8] * (28 - NARROW_FROM),
                         np.int32)
SCREENING = {"tpu_gain_screening": True, "tpu_screening_warmup": 2,
             "tpu_screening_explore_period": 4}
KNOBS = {"tpu_quantized_grad": 16, "tpu_adaptive_bins": True, **SCREENING}
# phase 6: (a) the yardstick, (b) tests/test_hist_plane.py's KNOBS, (c)
# quant8 alone, and each of (b)'s cuts alone: (d) quant16, (e) adaptive
# bins, (f) gain screening
PLANE_RUNS = (("a", {}), ("b", KNOBS), ("c", {"tpu_quantized_grad": 8}),
              ("d", {"tpu_quantized_grad": 16}),
              ("e", {"tpu_adaptive_bins": True}), ("f", SCREENING))
# the level_pass variants checked on the mixed layout, as (quant_bits,
# packed, masked); each row of the kernels line pairs a variant's check
# with the phase-6 run whose every level_pass launch is that variant
PLANE_VARIANTS = ((0, False, False), (8, False, False), (16, False, False),
                  (0, True, False), (0, False, True), (16, True, True))
VARIANT_RUNS = {"quant8": "c", "quant16": "d", "packed": "e", "fmask": "f",
                "quant16+packed+fmask": "b"}
REPLACES = {
    "level_pass": "lightgbm_tpu/ops/fused_level.py:402",
    "route_pass": "lightgbm_tpu/ops/fused_level.py:575",
    "table_lookup": "lightgbm_tpu/ops/fused_level.py:811",
    "epilogue_pass": "lightgbm_tpu/ops/fused_level.py:641",
    "hist_pass": "lightgbm_tpu/ops/pallas_histogram.py:60",
}
SOURCES = {
    "level_pass": "lightgbm_tpu_torch/csrc/level_pass.cu",
    "route_pass": "lightgbm_tpu_torch/csrc/route_pass.cu",
    "table_lookup": "lightgbm_tpu_torch/csrc/table_lookup.cu",
    "epilogue_pass": "lightgbm_tpu_torch/csrc/epilogue_pass.cu",
    "hist_pass": "lightgbm_tpu_torch/csrc/hist_pass.cu",
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


# timings that could not be captured in a CUDA graph (see cuda_ms)
timing_notes = []


def cuda_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time per launch (ms): ``reps`` calls of ``fn`` captured in one
    CUDA graph, replayed ``replays`` times between two CUDA events; the
    median replay over ``reps``. The wrappers launch on the current stream
    and allocate only through torch, so they capture, and their host time
    (argument checks, allocation, the ctypes call) stays out of the window.
    A function that cannot be captured is timed as ``reps`` back-to-back
    calls between two events instead, and ``timing_notes`` says so."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):          # the library, attributes, allocator
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        run = graph.replay
    except RuntimeError as e:
        torch.cuda.synchronize()
        timing_notes.append(f"{getattr(fn, '__name__', fn)}: not capturable "
                            f"({str(e).splitlines()[0][:120]}); timed as "
                            f"{reps} back-to-back calls between two events")

        def run():
            for _ in range(reps):
                fn()
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return float(np.median(times))


def call_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median of per-call CUDA-event times (ms): one event pair around one
    host call, so the window holds the call's host time too. The plain
    versions are timed so (they sync on the host), and table_lookup and
    its yardstick also so, beside their graph times, to show what the
    host's share of one call is."""
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


# the template instances' arguments in ptxas's mangled names (an int
# argument as its value, a bool as true or false)
_MANGLED_TYPES = {"a": "int8", "s": "int16", "13__nv_bfloat16": "bf16",
                  "f": "f32", "i": "int32"}
_MANGLED = r"(a|s|f|i|13__nv_bfloat16|L[ib]\d+E)"


def _demangled_arg(t: str) -> str:
    if t.startswith("Li"):
        return t[2:-1]
    if t.startswith("Lb"):
        return "true" if t[2] == "1" else "false"
    return _MANGLED_TYPES[t]


def ptxas_summary(report: str):
    """Each kernel instance of nvcc's ``-Xptxas -v`` report: registers,
    static shared memory bytes and spill bytes."""
    import re
    out = []
    for block in report.split("Compiling entry function")[1:]:
        m = re.search(r"lgbt\d+(\w+?_kernel)(?:I" + _MANGLED + _MANGLED
                      + "?" + _MANGLED + r"?E)?", block)
        used = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$",
                         block, re.M)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        if not (m and used):
            continue
        args = [_demangled_arg(t) for t in m.groups()[1:] if t]
        out.append({"kernel": m.group(1) + (f"<{','.join(args)}>"
                                            if args else ""),
                    "registers": int(used.group(1)),
                    "smem_bytes": int(used.group(2) or 0),
                    "spill_bytes": int(spill.group(1)) + int(spill.group(2))
                    if spill else 0})
    return out


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_stages(launches, cuda, run) -> None:
    """Every level_pass, route_pass and epilogue_pass call launched each
    CUDA kernel of its stages once (level_pass exactly its four), as the C
    entries report each launch (``cuda_launches``)."""
    from lightgbm_tpu_torch.ops import fused_level as fl
    for wrapper, kernels in (("level_pass", fl.LEVEL_KERNELS),
                             ("route_pass", fl.ROUTE_KERNELS),
                             ("epilogue_pass", fl.EPILOGUE_KERNELS)):
        got = {k: cuda[k] for k in kernels}
        if got != dict.fromkeys(kernels, launches[wrapper]):
            raise AssertionError(f"{run}: {launches[wrapper]} {wrapper} "
                                 f"calls launched the CUDA kernels {got}")


def kernel_cuda_launches(name, cuda):
    """The CUDA kernel launches of one wrapper in a run's counts."""
    from lightgbm_tpu_torch.ops import fused_level as fl
    kernels = {"level_pass": fl.LEVEL_KERNELS,
               "route_pass": fl.ROUTE_KERNELS,
               "epilogue_pass": fl.EPILOGUE_KERNELS}.get(name, (name,))
    return {k: cuda[k] for k in kernels}


def odd_route_table(W, slabs, seed):
    """The route table with slot 0's row spread over a second kernel row's
    slab and slot 2's row all zero (``slabs``: each kernel row's offset
    and width): any 0/1 W must route as the full W @ one-hot sum does,
    though the grower's has one slab per row."""
    W = W.clone()
    K = len(slabs)
    j0 = next(j for j, (o, w) in enumerate(slabs) if bool(W[0, o:o + w].any()))
    o, w = slabs[(j0 + 1 + seed % (K - 1)) % K]
    W[0, o:o + max(1, w // 2)] = 1
    W[2] = 0
    return W


def kernel_slabs(K, B, pk):
    """(offset, width) of each kernel row's slab on the flat axis."""
    if pk is not None:
        return [(int(o), int(w)) for o, w in zip(pk.flat_offsets, pk.widths)]
    return [(j * B, B) for j in range(K)]


def sass_hist_ops(lib_path):
    """How many tensor-core (HMMA), shared-atomic (ATOMS), global-atomic
    (RED, ATOMG) and shared load/store and f32 add instructions each
    epilogue_hist_kernel instance of the built library holds (cuobjdump
    -sass): the root histogram's adds as compiled."""
    import re
    from pathlib import Path
    from lightgbm_tpu_torch.ops import cuda_build
    tool = str(Path(cuda_build.nvcc_path()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in sass.split("Function : ")[1:]:
        m = re.match(r"\S*epilogue_hist_kernelI(a|s)Li(\d)E", block)
        if not m:
            continue
        ops = re.findall(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                         block, re.M)
        out[f"epilogue_hist_kernel<{_MANGLED_TYPES[m.group(1)]},"
            f"{m.group(2)}>"] = {
            op: ops.count(op) for op in ("HMMA", "ATOMS", "RED", "ATOMG",
                                         "LDS", "STS", "FADD", "LDGSTS")}
    return out


def _level_inputs(Rp, R, num_bin, B, Sp, nch, seed, quant_bits=0,
                  packed=False):
    """Random level-pass operands: feature f's bins in [0, num_bin[f]),
    every real row in one of Sp leaves, Sp-1 active slots on random
    features (the last inactive), missing types None/Zero/NaN, ~30% zero
    bag weights; padding rows at leaf -1 with zero channels. ``quant_bits``
    packs the int8 channels (nch from quantize.QNCH); ``packed`` lays the
    rows out on the adaptive layout (bins_T's rows in feat_order, the route
    table re-indexed), and the same seed gives the same rows in both
    layouts. Returns ((bins_T, leaf_T, gh_T, W, tbl), the wrappers'
    keywords)."""
    import torch
    from lightgbm_tpu_torch.ops import fused_level as fl
    from lightgbm_tpu_torch.ops import layout
    from lightgbm_tpu_torch.ops.quantize import QNCH
    dev = torch.device(DEVICE)
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    nb = np.asarray(num_bin, np.int32)
    F = len(nb)
    mt = rng.randint(0, 3, F).astype(np.int32)
    db = (rng.rand(F) * (nb - 1)).astype(np.int32)
    nb_t = torch.as_tensor(nb, device=dev)
    bins = (torch.rand((F, Rp), generator=gen, device=dev)
            * nb_t[:, None]).to(torch.int8 if B <= 128 else torch.int16)
    bins[:, R:] = 0
    leaf = torch.randint(0, Sp, (Rp,), generator=gen, device=dev,
                         dtype=torch.int32)
    leaf[R:] = -1
    w = (torch.rand(Rp, generator=gen, device=dev) >= 0.3).float()
    w[R:] = 0
    g = torch.randn(Rp, generator=gen, device=dev) * w
    h = torch.rand(Rp, generator=gen, device=dev) * 0.25 * w
    if quant_bits:
        nch = QNCH[quant_bits]
        gh_T, _ = fl.pack_gh_quant(g, h, w, quant_bits, seed=seed)
    else:
        gh_T = fl.pack_gh(g, h, w, nch)
    lof = np.arange(Sp, dtype=np.int32)
    lof[-1] = -2
    feat = np.where(lof >= 0, rng.randint(0, F, Sp), -1).astype(np.int32)
    thr = (rng.rand(Sp) * (nb[np.maximum(feat, 0)] - 1)).astype(np.int32)
    dl = rng.rand(Sp) < 0.5
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    W = fl.build_route_table(t(feat), t(thr), t(dl), nb_t, t(mt), t(db),
                             Sp, F, B)
    pk = None
    if packed:
        pk = layout.packed_feature_layout(nb, B - 1, f_oh=F)
        bins = bins[list(pk.feat_order)]
        W = fl.pack_route_table(W, pk)
    tbl = np.zeros((Sp, 128), np.int32)
    tbl[:, 0] = lof
    tbl[:, 1] = np.where(lof >= 0, Sp, 0)
    tbl[:, 2] = rng.randint(0, 2, Sp)
    kw = dict(num_bins=B, f_oh=F, nch=nch, quant_bits=quant_bits, packed=pk)
    return (bins.contiguous(), leaf[None, :], gh_T, W, t(tbl)), kw


def _route_slabs(W, K, B, pk, keep):
    """[Sp] int64: how many kernel rows' slabs of each W row hold a
    non-zero (outside ``keep``, if given, nothing routes)."""
    import torch
    dev = W.device
    owner = torch.full((W.shape[1],), -1, dtype=torch.long, device=dev)
    for j in range(K):
        st, w = (int(pk.flat_offsets[j]), pk.widths[j]) if pk is not None \
            else (j * B, B)
        owner[st:st + w] = j
    nz = W != 0
    if keep is not None:
        nz &= keep[None, :]
    hit = torch.zeros((W.shape[0], K + 1), dtype=torch.bool, device=dev)
    rows, cols = torch.nonzero(nz, as_tuple=True)
    hit[rows, owner[cols] + 1] = True
    return hit[:, 1:].sum(1)


def _n_small(leaf_T, new_leaf, tbl) -> int:
    """Rows this level histograms: in an active slot's leaf and on the
    side of its smaller child."""
    member = leaf_T[0][None, :] == tbl[:, 0][:, None]
    left = (new_leaf[0] == leaf_T[0])[None, :]
    return int((member & (left == (tbl[:, 2] > 0)[:, None])).any(0).sum())


def check_level(Rp, R, num_bin, B, Sp, seed, nch=5, quant_bits=0,
                packed=False, masked=False):
    """level_pass and route_pass against their plain versions on the card,
    padded f32 or one combination of the histogram-plane cuts: new leaves
    equal; f32 planes within 1e-5 of the plane's largest magnitude (atomics
    reorder the sums) with the weight channel exact; int32 planes
    (``quant_bits``) bit-exact, and equal to the other layout's on the same
    rows after unpacking; ``masked``: the grower's screening mask with half
    the features off (logical feature 0 and the first kernel row's feature
    kept on), their slabs exactly zero."""
    import torch
    from lightgbm_tpu_torch.ops import fused_level as fl
    ops, kw = _level_inputs(Rp, R, num_bin, B, Sp, nch, seed, quant_bits,
                            packed)
    bins_T, leaf_T, gh_T, W, tbl = ops
    pk, nch, F = kw["packed"], kw["nch"], len(num_bin)
    dev = bins_T.device
    fm = None
    if masked:
        fm = torch.arange(F, device=dev) % 2 == 0
        fm[0] = True
        fm[pk.feat_order[0] if pk is not None else 0] = True
    rkw = dict(num_bins=B, f_oh=F, packed=pk)
    variant = fl.variant_name(quant_bits, packed, masked)
    n0 = dict(fl.launches)
    v0 = dict(fl.variant_launches)
    c0 = dict(fl.cuda_launches)
    hist_k, leaf_k = fl.level_pass(*ops, fm, **kw)
    route_k = fl.route_pass(bins_T, leaf_T, W, tbl, **rkw)
    launched = {k: fl.launches[k] - n0[k] for k in n0
                if fl.launches[k] != n0[k]}
    launched.update({k: fl.variant_launches[k] - v0[k] for k in v0
                     if fl.variant_launches[k] != v0[k]})
    cuda_launched = {k: fl.cuda_launches[k] - c0[k] for k in c0
                     if fl.cuda_launches[k] != c0[k]}
    hist_p, leaf_p = fl.level_pass_plain(*ops, fm, **kw)
    route_p = fl.route_pass_plain(bins_T, leaf_T, W, tbl, **rkw)
    torch.cuda.synchronize()
    if not torch.equal(leaf_k, leaf_p):
        raise AssertionError(f"level_pass[{variant}] new_leaf differs "
                             f"(B={B} Sp={Sp})")
    if not torch.equal(route_k, route_p):
        raise AssertionError(f"route_pass new_leaf differs (B={B} Sp={Sp} "
                             f"packed={packed})")
    # any 0/1 route table: a row over two slabs, an all-zero row
    K_rows = len(pk.feat_order) if pk is not None else F
    W_odd = odd_route_table(W, kernel_slabs(K_rows, B, pk), seed)
    if not torch.equal(fl.route_pass(bins_T, leaf_T, W_odd, tbl, **rkw),
                       fl.route_pass_plain(bins_T, leaf_T, W_odd, tbl,
                                           **rkw)):
        raise AssertionError(f"route_pass new_leaf differs on a W over "
                             f"several slabs (B={B} Sp={Sp} packed={packed})")
    out = {"variant": variant, "B": B, "Sp": Sp, "nch": nch,
           "bins": str(bins_T.dtype).replace("torch.", ""),
           "num_bin": sorted({int(v) for v in num_bin}), "FB": W.shape[1],
           "launches": launched, "cuda_launches": cuda_launched,
           "route_pass_equal_on": ["grower W", "W with a row over two "
                                   "slabs and an all-zero row"]}
    abs_err = float((hist_k.double() - hist_p.double()).abs().max())
    if quant_bits:
        if not torch.equal(hist_k, hist_p):
            raise AssertionError(f"level_pass[{variant}] int32 planes "
                                 f"differ by {abs_err} (Sp={Sp})")
        # the same rows on the other layout: equal after unpacking
        ops2, kw2 = _level_inputs(Rp, R, num_bin, B, Sp, nch, seed,
                                  quant_bits, not packed)
        hist2, leaf2 = fl.level_pass(*ops2, fm, **kw2)
        pk_ = pk if packed else kw2["packed"]
        hist_pk, hist_pd = (hist_k, hist2) if packed else (hist2, hist_k)
        if not (torch.equal(fl.unpack_packed_flat(hist_pk, pk_), hist_pd)
                and torch.equal(leaf2, leaf_k)):
            raise AssertionError(f"level_pass[{variant}] packed differs "
                                 "from padded after unpack")
        out.update(tol="exact", packed_equals_padded_after_unpack=True)
    else:
        rel = 0.0
        for ch in range(nch):
            k = hist_k[:, ch * Sp:(ch + 1) * Sp]
            p = hist_p[:, ch * Sp:(ch + 1) * Sp]
            err = float((k - p).abs().max())
            if ch == nch - 1:
                if err != 0.0:
                    raise AssertionError(f"level_pass[{variant}] weight "
                                         f"channel differs by {err}")
            else:
                rel = max(rel, err / (float(p.abs().max()) or 1.0))
        if rel > 1e-5:
            raise AssertionError(f"level_pass[{variant}] hist rel err {rel}"
                                 " > 1e-5")
        out.update(hist_max_rel_err=rel, tol="rel 1e-5 of the plane max; "
                   "weight channel exact")
    if fm is not None:
        if hist_k[~fl.expand_feature_mask(fm, F, B, pk)].any():
            raise AssertionError(f"level_pass[{variant}] masked slabs not "
                                 "zero")
        out["masked_slabs_zero"] = True

    # bytes each function must move on this run's rows (each read once):
    # the leaf in and the new leaf out of every row; for each slotted row
    # the bins of the kernel rows its slot's W row routes on (one, the
    # split slab, as the grower builds W; masked slabs route nothing); the
    # nch channels of the smaller-child rows (to find the live ones); the
    # remaining live bins of the marked rows (smaller child, a non-zero
    # channel); W, tbl, the layout tables and the mask; the histogram out.
    # ops: one compare per routing bin, nch adds per live kernel row of
    # each marked row. route_pass: the leaf in and out, the routing bins
    # (unmasked), W, tbl and the layout tables.
    K = bins_T.shape[0]
    bb, chb = bins_T.element_size(), gh_T.element_size()
    k_live = K if fm is None else int(fm[list(pk.feat_order)].sum()
                                      if pk is not None else fm.sum())
    keep = (fl.expand_feature_mask(fm, F, B, pk) if fm is not None
            else torch.ones(W.shape[1], dtype=torch.bool, device=dev))
    route_slabs = _route_slabs(W, K, B, pk, None)          # [Sp]
    mark_slabs = _route_slabs(W, K, B, pk, keep)
    slot = torch.full_like(leaf_T[0], -1)
    for k in range(Sp):
        slot[leaf_T[0] == tbl[k, 0]] = k
    in_slot = int((slot >= 0).sum())
    per_slot = torch.bincount(slot[slot >= 0].long(), minlength=Sp)
    n_small = _n_small(leaf_T, leaf_p, tbl)
    marked = fl.level_mark_plain(*ops, fm, **kw)[2].long()  # per slot
    n_marked = int(marked.sum())
    route_bins = int((per_slot * route_slabs).sum())
    mark_bins = int((per_slot * mark_slabs).sum())
    hist_bins = int((marked * (k_live - mark_slabs)).sum())
    tables = W.numel() * 2 + tbl.numel() * 4 + (K * 8 if pk else 0)
    lvl_bound, lvl_by = bound(
        Rp * 8 + (mark_bins + hist_bins) * bb + n_small * nch * chb + tables
        + (K if fm is not None else 0) + hist_p.numel() * 4,
        mark_bins + n_marked * k_live * nch)
    rt_bound, rt_by = bound(Rp * 8 + route_bins * bb + tables, route_bins)
    out.update(marked_rows=n_marked, routing_bins=mark_bins)
    out.update(slotted_rows=in_slot, smaller_child_rows=n_small,
               live_kernel_rows=k_live)
    # the histogram stage's tile: Kg kernel rows per group, Cw columns,
    # the widest slab's bins down each band; the staging record's bytes
    width = max(pk.widths) if pk is not None else B
    Kg, Cw = fl.hist_groups(K_rows, width, nch, fl._smem_budget(dev))
    out["hist_tile"] = {"Kg": Kg, "Cw": Cw, "width": width,
                        "groups": -(-K_rows // Kg),
                        "bytes": -(-Kg // Cw) * width * Cw * nch * 4,
                        "record_bytes": fl.record_layout(
                            K_rows, bb, nch, chb)[1]}
    out["level_pass"] = {
        "max_abs_err": abs_err,
        "kernel_ms": cuda_ms(lambda: fl.level_pass(*ops, fm, **kw)),
        "plain_ms": call_ms(lambda: fl.level_pass_plain(*ops, fm, **kw),
                            reps=3, warmup=1),
        "library_ms": None, "bound_ms": lvl_bound, "bound_by": lvl_by}
    # each stage alone, through its own wrapper (level_mark's includes the
    # memset of its 3*Sp counts and tables, level_partition's one
    # Sp-element copy of the counts)
    _, row_slot, counts = fl.level_mark(*ops, fm, **kw)
    stage = fl.level_partition(bins_T, gh_T, row_slot, counts, **kw)
    out["level_pass"]["stages_ms"] = {
        "level_mark": cuda_ms(lambda: fl.level_mark(*ops, fm, **kw)),
        "level_partition": cuda_ms(lambda: fl.level_partition(
            bins_T, gh_T, row_slot, counts, **kw)),
        "level_hist": cuda_ms(lambda: fl.level_hist(
            stage, counts, fm, bin_bytes=bins_T.element_size(), **kw))}
    out["route_pass"] = {
        "max_abs_err": 0, "tol": 0,
        "kernel_ms": cuda_ms(lambda: fl.route_pass(bins_T, leaf_T, W, tbl,
                                                   **rkw)),
        "plain_ms": call_ms(lambda: fl.route_pass_plain(
            bins_T, leaf_T, W, tbl, **rkw), reps=3, warmup=1),
        "library_ms": None, "bound_ms": rt_bound, "bound_by": rt_by}
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
    # the library yardstick computes the kernel's function: one
    # torch.take into the table with a zero appended at index L, through
    # an int64 index prepared beforehand with rows outside [0, L) mapped
    # to L (it reads 8 B of index per row, the kernel 4)
    table0 = torch.cat([table, table.new_zeros(1)])
    flat = torch.where((idx_T[0] >= 0) & (idx_T[0] < L), idx_T[0],
                       L).long()
    out_lib = torch.take(table0, flat)
    if not torch.equal(out_lib, out_p[0]):
        raise AssertionError("the torch.take yardstick differs from the "
                             "plain version")
    b, by = bound(Rp * 8 + L * 4, 0)
    return {
        "Rp": Rp, "L": L, "max_abs_err": err, "tol": 0,
        "launches": fl.launches["table_lookup"] - n0,
        "kernel_ms": cuda_ms(lambda: fl.table_lookup(idx_T, table)),
        "kernel_ms_per_call": call_ms(lambda: fl.table_lookup(idx_T,
                                                              table)),
        "plain_ms": call_ms(lambda: fl.table_lookup_plain(idx_T, table)),
        "library_ms": cuda_ms(lambda: torch.take(table0, flat)),
        "library_ms_per_call": call_ms(lambda: torch.take(table0, flat)),
        "library_call": "torch.take(table ++ [0], int64 index with rows "
                        "outside [0, L) mapped to L, prepared beforehand)",
        "bound_ms": b, "bound_by": by}


def check_epilogue(Rp, R, B, Sp, nch, kind, table, seed, L=255,
                   stages=False):
    """epilogue_pass against its plain version: rows in Sp leaves before
    the deferred route — ``table`` "grower" (the grower's W), "odd" (a W
    row over two slabs and an all-zero row) or "inactive" (an all-inactive
    table) —, a 255-entry leaf-value table (routed leaves past it add 0),
    ~30% zero bag weights, padding rows at leaf -1 with zero operands and
    bag. ``stages`` also times each of its CUDA kernels alone."""
    import torch
    from lightgbm_tpu_torch.ops import fused_level as fl
    dev = torch.device(DEVICE)
    (bins_T, leaf_T, _, W, tbl), _ = _level_inputs(
        Rp, R, np.full(FEATURES, B - 1, np.int32), B, Sp, nch, seed)
    if table == "odd":
        W = odd_route_table(W, kernel_slabs(FEATURES, B, None), seed)
    elif table == "inactive":
        W = torch.zeros_like(W)
        tbl = tbl.clone()
        tbl[:, 0] = -2
    rng = np.random.RandomState(seed + 1)
    lv = torch.as_tensor((rng.randn(L) * 0.1).astype(np.float32), device=dev)
    score = np.zeros((1, Rp), np.float32)
    score[0, :R] = rng.randn(R)
    ops = np.zeros((8, Rp), np.float32)
    if kind == "binary":
        ops[0, :R] = np.where(rng.rand(R) < 0.4, 1.0, -1.0)
    else:
        ops[0, :R] = rng.randn(R) * 3.0
    ops[1, :R] = rng.uniform(0.5, 2.0, R)
    bag = np.zeros((1, Rp), np.float32)
    bag[0, :R] = rng.rand(R) >= 0.3
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    args = (bins_T, leaf_T, W, tbl, lv, t(score), t(ops), t(bag))
    kw = dict(num_bins=B, f_oh=FEATURES, nch=nch, kind=kind, sigmoid=1.0)
    n0 = fl.launches["epilogue_pass"]
    c0 = dict(fl.cuda_launches)
    hist_k, score_k, gh_k = fl.epilogue_pass(*args, **kw)
    launched = fl.launches["epilogue_pass"] - n0
    cuda_launched = {k: fl.cuda_launches[k] - c0[k]
                     for k in fl.EPILOGUE_KERNELS}
    hist_p, score_p, gh_p = fl.epilogue_pass_plain(*args, **kw)
    torch.cuda.synchronize()
    if launched != 1 or set(cuda_launched.values()) != {1}:
        raise AssertionError(f"epilogue_pass launched {launched} calls, "
                             f"CUDA kernels {cuda_launched}")

    def rel(a, b):
        return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
    score_err = float((score_k - score_p).abs().max())
    if not torch.allclose(score_k, score_p, rtol=1e-6, atol=0):
        raise AssertionError(f"epilogue new_score differs by {score_err}")
    # decoded channels (hi + lo): if the two exps were an ulp apart, g may
    # round to the other bf16 hi, and hi + lo may then differ by 2^-15 of
    # the value and those ulps
    ch_k, ch_p = gh_k.float(), gh_p.float()
    if nch == fl.NCH_PRECISE:
        dec_k = torch.stack([ch_k[0] + ch_k[1], ch_k[2] + ch_k[3], ch_k[4]])
        dec_p = torch.stack([ch_p[0] + ch_p[1], ch_p[2] + ch_p[3], ch_p[4]])
    else:
        dec_k, dec_p = ch_k[:3], ch_p[:3]
    gh_err = float((dec_k - dec_p).abs().max())
    if not torch.allclose(dec_k, dec_p, rtol=4e-5, atol=1e-7):
        raise AssertionError(f"epilogue gh_T differs by {gh_err}")
    if ch_k[nch:].abs().max() != 0:
        raise AssertionError("epilogue gh_T rows >= nch are not zero")
    # histogram: slots 1-7 exactly zero; the weight channel exact; g/h
    # planes within 1e-5 of the plane's largest |value| sum per cell (the
    # scale of any f32 summation order's rounding error)
    live = torch.zeros(nch * 8, dtype=torch.bool, device=dev)
    live[::8] = True
    if hist_k[:, ~live].abs().max() != 0:
        raise AssertionError("epilogue hist slots 1-7 are not zero")
    FB = FEATURES * B
    abs_hist = torch.zeros(FB * nch, dtype=torch.float64, device=dev)
    vals = gh_p[:nch].double().abs()
    for f in range(FEATURES):
        cell = (f * B + bins_T[f].long()) * nch
        abs_hist.index_add_(0, (cell[None, :] + torch.arange(
            nch, device=dev)[:, None]).reshape(-1), vals.reshape(-1))
    abs_hist = abs_hist.reshape(FB, nch)
    hist_abs_err = 0.0
    hist_rel_sum = 0.0
    hist_rel_max = 0.0
    for c in range(nch):
        k, p = hist_k[:, 8 * c], hist_p[:, 8 * c]
        err = float((k - p).abs().max())
        hist_abs_err = max(hist_abs_err, err)
        if c == nch - 1:
            if err != 0.0:
                raise AssertionError(f"epilogue weight channel differs by "
                                     f"{err}")
            continue
        hist_rel_sum = max(hist_rel_sum, err / float(abs_hist[:, c].max()))
        hist_rel_max = max(hist_rel_max, err / (float(p.abs().max()) or 1.0))
    if hist_rel_sum > 1e-5:
        raise AssertionError(f"epilogue hist rel err {hist_rel_sum} > 1e-5")

    # bytes: bins, leaf, score in/out, the two operand rows, bag, the 8
    # bf16 channels out, W, tbl, leaf values, the [FB, nch*8] histogram;
    # ops: the route's gather-adds for rows in a selected leaf, ~20 flops
    # of gradient and pack per row, F*nch adds per row with a non-zero
    # channel (this run's counts)
    bb = bins_T.element_size()
    in_slot = int((leaf_T[0][:, None] == tbl[:, 0][None, :]).any(1).sum())
    nonzero = int((gh_p[:nch].float() != 0).any(0).sum())
    nbytes = (Rp * (FEATURES * bb + 4 + 8 + 8 + 4 + 16) + W.numel() * 2
              + tbl.numel() * 4 + L * 4 + hist_p.numel() * 4)
    nops = in_slot * FEATURES + Rp * 20 + nonzero * FEATURES * nch
    b_ms, b_by = bound(nbytes, nops)
    out = {}
    if stages:
        # each CUDA kernel alone on the same inputs, into one set of
        # buffers filled by a whole call first (the pass reads the slab
        # table, the reduce the partial histograms)
        buf = fl.epilogue_buffers(bins_T, Sp, num_bins=B, f_oh=FEATURES,
                                  nch=nch)
        fl._epilogue_launch(fl.EPILOGUE_KERNELS, *args, buf, **kw)

        def stage(kernel):
            return lambda: fl._epilogue_launch((kernel,), *args, buf, **kw)
        out["stages_ms"] = {k: cuda_ms(stage(k)) for k in fl.EPILOGUE_KERNELS}
        out["row_blocks"] = buf["blocks"]
    return {
        "B": B, "bins": str(bins_T.dtype).replace("torch.", ""), "Sp": Sp,
        "nch": nch, "kind": kind, "deferred_table": table,
        "launches": launched, "cuda_launches": cuda_launched, **out,
        "new_score_max_abs_err": score_err, "new_score_tol": "rtol=1e-6",
        "gh_max_abs_err": gh_err, "gh_max_rel_err": rel(dec_k, dec_p),
        "gh_tol": "rtol=4e-5 atol=1e-7",
        "hist_max_abs_err": hist_abs_err,
        "hist_rel_err_of_abs_sum": hist_rel_sum, "hist_tol": 1e-5,
        "hist_rel_err_of_plane_max": hist_rel_max,
        "weight_channel_exact": True,
        "kernel_ms": cuda_ms(lambda: fl.epilogue_pass(*args, **kw)),
        "plain_ms": call_ms(lambda: fl.epilogue_pass_plain(*args, **kw),
                            reps=3, warmup=1),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}


def check_hist(R, Fp, B, S, quant_bits, seed):
    """hist_pass against its plain version: int32 bins [R, Fp] in [0, B-1),
    slots in [0, S) with ~30% of rows at -1 (their gh non-zero), gh as f32
    (g, h, w) or the int8 channels of ``quant_bits``."""
    import torch
    from lightgbm_tpu_torch.ops import fused_level as fl
    from lightgbm_tpu_torch.ops import pallas_histogram as ph
    from lightgbm_tpu_torch.ops import quantize as q
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, B - 1, (R, Fp), generator=gen, device=dev,
                         dtype=torch.int32)
    slot = torch.randint(0, S, (R,), generator=gen, device=dev,
                         dtype=torch.int32)
    slot[torch.rand(R, generator=gen, device=dev) < 0.3] = -1
    g = torch.randn(R, generator=gen, device=dev)
    h = torch.rand(R, generator=gen, device=dev) * 0.25
    w = torch.ones(R, device=dev)
    if quant_bits:
        scales = q.quant_scales(g, h, quant_bits)
        gh = torch.stack(q.encode_channels(
            *q.quantize_gh(g, h, scales, quant_bits, seed), w, quant_bits),
            1).contiguous()
    else:
        gh = torch.stack([g, h, w], 1).contiguous()
    nch = gh.shape[1]
    kw = dict(S=S, Bp=B, nch=nch, quant=bool(quant_bits))
    n0 = fl.launches["hist_pass"]
    out_k = ph.hist_pass(bins, gh, slot, **kw)
    launched = fl.launches["hist_pass"] - n0
    out_p = ph.hist_pass_plain(bins, gh, slot, **kw)
    torch.cuda.synchronize()
    abs_err = float((out_k - out_p).abs().max())
    rel_sum = 0.0
    if quant_bits:
        if not torch.equal(out_k, out_p):
            raise AssertionError(f"hist_pass quant{quant_bits} differs by "
                                 f"{abs_err} (B={B} S={S})")
    else:
        # g/h planes within 1e-5 of the largest per-cell sum of |value|
        # (the scale of any f32 summation order's rounding error); the
        # weight channel counts rows exactly
        abs_sum = ph.hist_pass_plain(bins, gh.abs(), slot, **kw)
        for c in range(2):
            err = float((out_k[c] - out_p[c]).abs().max())
            rel_sum = max(rel_sum, err / float(abs_sum[c].max()))
        if not torch.equal(out_k[2], out_p[2]):
            raise AssertionError("hist_pass weight channel differs")
        if rel_sum > 1e-5:
            raise AssertionError(f"hist_pass rel err {rel_sum} > 1e-5")

    # bytes this run's data needs: every slot, the bins and channels of
    # the slotted rows, the histogram out; ops: Fp*nch adds per slotted row
    rows = torch.nonzero(slot >= 0).squeeze(1)
    n_slot = int(rows.numel())
    nbytes = (R * 4 + n_slot * (Fp * 4 + nch * gh.element_size())
              + out_p.numel() * 4)
    b_ms, b_by = bound(nbytes, n_slot * Fp * nch)
    # the library yardstick: one index_add_ over precomputed flat indices
    cell = ((slot[rows].long()[:, None] * Fp
             + torch.arange(Fp, device=dev)) * B + bins[rows].long())
    src = (gh[rows].int() if quant_bits
           else gh[rows].to(torch.bfloat16).float())
    src = src[:, None, :].expand(-1, Fp, -1).reshape(-1, nch)
    cell = cell.reshape(-1)
    flat_len = out_p.numel() // nch
    acc = out_p.dtype

    def library():
        return torch.zeros((flat_len, nch), dtype=acc,
                           device=dev).index_add_(0, cell, src)
    if quant_bits and not torch.equal(library().t().reshape(out_p.shape),
                                      out_p):
        raise AssertionError("the index_add_ yardstick differs from the "
                             "plain version")
    return {
        "R": R, "Fp": Fp, "Bp": B, "S": S, "nch": nch,
        "variant": f"quant{quant_bits}" if quant_bits else "f32",
        "slotted_rows": n_slot, "launches": launched,
        "max_abs_err": abs_err,
        "rel_err_of_abs_sum": rel_sum,
        "tol": "exact" if quant_bits else "1e-5 of abs sum; w exact",
        "kernel_ms": cuda_ms(lambda: ph.hist_pass(bins, gh, slot, **kw)),
        "plain_ms": call_ms(lambda: ph.hist_pass_plain(bins, gh, slot, **kw),
                            reps=3, warmup=1),
        "library_ms": cuda_ms(library, reps=5),
        "bound_ms": b_ms, "bound_by": b_by}


def auc(scores: np.ndarray, y: np.ndarray) -> float:
    order = np.argsort(scores, kind="stable")
    ranks = np.empty(len(scores), np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = y > 0
    n_pos = pos.sum()
    n_neg = len(y) - n_pos
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def run_updates(lgb, params, ds, X, y, megastep=False):
    """bench.py's loop on the card: Booster(params, train_set), warm-up
    updates, then UPDATES timed ones, each ending in a synchronize; on the
    megastep body (what train() runs) when ``megastep``, else on the
    epilogue body. Returns (the phase's JSON, the wrappers' launches and
    the CUDA kernels' launches in the timed run)."""
    import torch
    from lightgbm_tpu_torch.models import frontier2
    from lightgbm_tpu_torch.ops import fused_level as fl
    ds.params = {}      # each run trains on its own parameters alone
    bst = lgb.Booster(params=params, train_set=ds)
    bst._gbdt.arm_megastep(megastep)
    for _ in range(WARMUP_UPDATES):
        bst.update()
    torch.cuda.synchronize()
    fl.reset_launch_counts()
    frontier2.host_syncs["count"] = 0
    times = []
    for _ in range(UPDATES):
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(fl.launches)
    cuda = dict(fl.cuda_launches)
    syncs = frontier2.host_syncs["count"]
    n_trees = bst.num_trees()
    scores = bst.train_scores().float().cpu().numpy()
    train_auc = auc(scores, y)
    pred = bst.predict(X[:100_000], raw_score=True)
    pred_err = float(np.abs(pred - scores[:100_000]).max())
    ok_pred = bool(np.allclose(pred, scores[:100_000], rtol=1e-5,
                               atol=1e-5))
    epilogue = not megastep and bst._gbdt._use_epilogue()
    res = {"body": "epilogue" if epilogue else "megastep",
           "updates": UPDATES, "warmup_updates": WARMUP_UPDATES,
           "trees": n_trees, "sec_per_iter": float(np.mean(times)),
           "sec_per_iter_median": float(np.median(times)),
           "train_auc": train_auc, "launches": launches,
           "cuda_launches": cuda,
           "host_syncs_per_tree": syncs / UPDATES,
           "predict_max_abs_err": pred_err,
           "predict_tol": "rtol=1e-5 atol=1e-5",
           "leaves": [m.num_leaves for m in bst.models]}
    if n_trees != UPDATES + WARMUP_UPDATES:
        raise AssertionError(f"update() grew {n_trees} trees")
    if not train_auc > 0.75:
        raise AssertionError(f"update() training AUC {train_auc} <= 0.75")
    if epilogue and launches["epilogue_pass"] <= 0:
        raise AssertionError("epilogue_pass never launched on the "
                             "update() path")
    if not ok_pred:
        raise AssertionError(f"update() predict differs from the "
                             f"trainer's scores by {pred_err}")
    check_stages(launches, cuda, "update()")
    return res, launches, cuda


def run_frontier(lgb, params, ds, X, y):
    """train() on the frontier-v1 engine, timed as phase 3 times the fused
    engine; returns the wrappers' and the CUDA kernels' launches in the
    ROUNDS-round run."""
    import torch
    from lightgbm_tpu_torch.models import frontier2
    from lightgbm_tpu_torch.ops import fused_level as fl
    p = dict(params, tpu_engine="frontier")

    def timed_train(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ds.params = {}
        b = lgb.train(p, ds, num_boost_round=rounds)
        torch.cuda.synchronize()
        return b, time.perf_counter() - t

    timed_train(1)                        # warm-up
    _, t_one = timed_train(1)
    fl.reset_launch_counts()
    frontier2.host_syncs["count"] = 0
    bst, t_all = timed_train(ROUNDS)
    launches = dict(fl.launches)
    cuda = dict(fl.cuda_launches)
    syncs = frontier2.host_syncs["count"]
    n_trees = bst.num_trees()
    scores = bst.train_scores().float().cpu().numpy()
    train_auc = auc(scores, y)
    pred = bst.predict(X[:100_000], raw_score=True)
    pred_err = float(np.abs(pred - scores[:100_000]).max())
    ok_pred = bool(np.allclose(pred, scores[:100_000], rtol=1e-5,
                               atol=1e-5))
    emit({"phase": "frontier_train", "engine": "frontier",
          "use_frontier": bool(bst._gbdt.use_frontier),
          "bagging": bool(bst._gbdt.is_bagging), "rounds": ROUNDS,
          "trees": n_trees,
          "sec_per_iter_after_first": (t_all - t_one) / (ROUNDS - 1),
          "train_s": t_all, "train_auc": train_auc, "launches": launches,
          "cuda_launches": cuda,
          "hist_pass_per_tree": launches["hist_pass"] / max(n_trees, 1),
          "host_syncs_per_tree": syncs / max(n_trees, 1),
          "predict_max_abs_err": pred_err,
          "predict_tol": "rtol=1e-5 atol=1e-5",
          "leaves": [m.num_leaves for m in bst.models]})
    if not bst._gbdt.use_frontier:
        raise AssertionError("tpu_engine=frontier did not take the "
                             "frontier engine")
    if n_trees != ROUNDS:
        raise AssertionError(f"frontier trained {n_trees} trees")
    if not train_auc > 0.75:
        raise AssertionError(f"frontier training AUC {train_auc} <= 0.75")
    for name, n in launches.items():
        if (n > 0) != (name in FRONTIER_KERNELS):
            raise AssertionError(f"kernel {name} launched {n} times on the "
                                 "frontier train() path")
    if not ok_pred:
        raise AssertionError(f"frontier predict differs from the trainer's "
                             f"scores by {pred_err}")
    check_stages(launches, cuda, "frontier train()")
    return launches, cuda


def run_plane_cuts(lgb, params, X, y):
    """Phase 6: train() on the mixed-cardinality rows, the runs of
    PLANE_RUNS, each timed as phase 3 times the fused engine. Returns
    each run's kernel and variant launches in its ROUNDS-round run, and
    its CUDA kernels' launches under ``cuda:<kernel>``."""
    import torch
    from lightgbm_tpu_torch.models import frontier2
    from lightgbm_tpu_torch.ops import fused_level as fl
    X = X.copy()
    X[:, NARROW_FROM:] = np.floor(X[:, NARROW_FROM:] * 8.0) / 8.0
    t0 = time.perf_counter()
    ds = lgb.Dataset(X, label=y, params=params).construct()
    construct_s = time.perf_counter() - t0
    nb = ds._inner.num_bin_per_feat
    out = {}
    for name, extra in PLANE_RUNS:
        p = dict(params, **extra)

        def timed_train(rounds):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ds.params = {}
            b = lgb.train(p, ds, num_boost_round=rounds)
            torch.cuda.synchronize()
            return b, time.perf_counter() - t

        timed_train(1)                    # warm-up
        _, t_one = timed_train(1)
        fl.reset_launch_counts()
        frontier2.host_syncs["count"] = 0
        bst, t_all = timed_train(ROUNDS)
        launches = dict(fl.launches)
        cuda = dict(fl.cuda_launches)
        variants = {k: v for k, v in fl.variant_launches.items() if v}
        syncs = frontier2.host_syncs["count"]
        g = bst._gbdt
        n_trees = bst.num_trees()
        scores = bst.train_scores().float().cpu().numpy()
        train_auc = auc(scores, y)
        pred = bst.predict(X[:100_000], raw_score=True)
        pred_err = float(np.abs(pred - scores[:100_000]).max())
        ok_pred = bool(np.allclose(pred, scores[:100_000], rtol=1e-5,
                                   atol=1e-5))
        fb = (g.fused_packed.fb if g.fused_packed is not None
              else g.fused_f_oh * g.fused_Bp)
        res = {"phase": "plane_cuts_train", "run": name, "params": extra,
               "rows": ROWS, "features": FEATURES,
               "narrow_features_num_bin": sorted({int(v) for v in
                                                  nb[NARROW_FROM:]}),
               "construct_s": construct_s, "rounds": ROUNDS,
               "trees": n_trees,
               "sec_per_iter_after_first": (t_all - t_one) / (ROUNDS - 1),
               "train_s": t_all, "train_auc": train_auc,
               "quant_bits": g.quant_bits, "nch": g.fused_nch,
               "launches": launches, "variant_launches": variants,
               "cuda_launches": cuda,
               "launches_per_tree": {k: v / max(n_trees, 1)
                                     for k, v in launches.items()},
               "host_syncs_per_tree": syncs / max(n_trees, 1),
               "flat_width": fb,
               "padded_flat_width": g.fused_f_oh * g.fused_Bp,
               "screening_active_features": g.screening_active_features(),
               "predict_max_abs_err": pred_err,
               "predict_tol": "rtol=1e-5 atol=1e-5",
               "leaves": [m.num_leaves for m in bst.models]}
        emit(res)
        out[name] = res
        if n_trees != ROUNDS:
            raise AssertionError(f"run ({name}) trained {n_trees} trees")
        if not ok_pred:
            raise AssertionError(f"run ({name}) predict differs from the "
                                 f"trainer's scores by {pred_err}")
        if launches["epilogue_pass"] or launches["hist_pass"]:
            raise AssertionError(f"run ({name}) left the megastep body")
        check_stages(launches, cuda, f"run ({name})")
    # the megastep schedule: one n_sel read per scheduled level, one
    # lookup per tree; a full tree (num_leaves leaves, as every tree of
    # these rows grows on the card) takes a root pass plus one pass per
    # level until the leaf budget is spent, the last of them route-only.
    # quant8 (nch 3) has a wider slot cap, so one level fewer than (a).
    # A rehearsal on the CPU at a few thousand rows grows smaller trees:
    # there the passes are only bounded by the schedule
    a = out["a"]
    L = params["num_leaves"]
    for name, r in out.items():
        n = r["launches_per_tree"]
        cap = fl.max_slot_cap(r["padded_flat_width"], r["nch"])
        caps = frontier2.level_caps(L, -1, 3, cap)
        full = frontier2.level_caps(L, -1, 0, cap)
        if DEVICE == "cuda":
            left = (n["level_pass"] != len(full) or n["route_pass"] != 1
                    or r["host_syncs_per_tree"] != len(caps)
                    or set(r["leaves"]) != {L})
        else:
            left = (n["route_pass"] > 1
                    or n["level_pass"] + n["route_pass"] > 1 + len(caps)
                    or r["host_syncs_per_tree"] > len(caps))
        if left or n["table_lookup"] != 1:
            raise AssertionError(
                f"run ({name}) left the megastep schedule ({len(full)} "
                f"passes and {len(caps)} syncs per {L}-leaf tree): {n}, "
                f"{r['host_syncs_per_tree']} syncs, leaves {r['leaves']}")
        if r["host_syncs_per_tree"] > a["host_syncs_per_tree"]:
            raise AssertionError(f"run ({name}) makes more host syncs per "
                                 "tree than run (a)")
        if abs(r["train_auc"] - a["train_auc"]) > 0.05:
            raise AssertionError(f"run ({name}) AUC {r['train_auc']} is "
                                 f"not within 0.05 of run (a)'s")
    b = out["b"]
    if not b["flat_width"] < b["padded_flat_width"]:
        raise AssertionError("adaptive bins did not pack the flat axis")
    return {name: dict(r["launches"], **r["variant_launches"],
                       **{"cuda:" + k: v
                          for k, v in r["cuda_launches"].items()})
            for name, r in out.items()}


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
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    cuda_build.library()
    build_s = time.perf_counter() - t0
    ptxas = ptxas_summary(str(cuda_build.build_info.get("ptxas", "")))
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "build_s": build_s, "nvcc_build_s": cuda_build.build_info.get(
              "seconds"), "ptxas": ptxas})
    # what the epilogue's histogram stage compiled to: its adds are plain
    # shared-memory loads, f32 adds and stores (no matrix instruction, no
    # atomic); PERF.md has the tensor-core design it replaced
    sass = sass_hist_ops(cuda_build.build())
    emit({"phase": "sass", "epilogue_hist_kernel": sass})
    if len(sass) != 10 or any(n["ATOMS"] or n["RED"] or n["ATOMG"]
                             or not (n["LDS"] and n["STS"] and n["FADD"])
                             for n in sass.values()):
        raise AssertionError(f"the epilogue's histogram stage compiled to "
                             f"other instructions than expected: {sass}")

    # ---- 2. kernels against their plain versions at the slice's shapes
    Rp = ((ROWS + 2047) // 2048) * 2048
    checks = []
    main_cfg = None
    for B in (64, 256):
        for nch in (fl.NCH_PRECISE, fl.NCH_FAST):
            cap = fl.max_slot_cap(FEATURES * B, nch)
            for Sp in sorted({8, cap}):
                res = check_level(Rp, ROWS, np.full(FEATURES, B - 1,
                                                    np.int32), B, Sp,
                                  seed=B + Sp + nch, nch=nch)
                emit({"phase": "kernel_check", **res})
                checks.append(res)
                if B == 64 and nch == fl.NCH_PRECISE and Sp == cap:
                    main_cfg = res
    lookup = check_lookup(Rp, ROWS, 255, seed=7)
    emit({"phase": "kernel_check", "table_lookup": lookup})
    epi_main = None
    for B in (64, 256):
        for nch in (fl.NCH_PRECISE, fl.NCH_FAST):
            cap = fl.max_slot_cap(FEATURES * B, nch)
            for kind in ("binary", "l2"):
                for Sp in sorted({8, cap}):
                    main = (B, nch, kind, Sp) == (64, fl.NCH_PRECISE,
                                                  "binary", cap)
                    res = check_epilogue(Rp, ROWS, B, Sp, nch, kind,
                                         "grower", stages=main,
                                         seed=B + Sp + nch + len(kind))
                    emit({"phase": "kernel_check", "epilogue_pass": res})
                    if main:
                        epi_main = res
            res = check_epilogue(Rp, ROWS, B, cap, nch,
                                 "binary" if nch == fl.NCH_PRECISE else "l2",
                                 "odd", seed=B + nch + 5)
            emit({"phase": "kernel_check", "epilogue_pass": res})
    res = check_epilogue(Rp, ROWS, 64, 64, fl.NCH_PRECISE, "binary",
                         "inactive", seed=3)
    emit({"phase": "kernel_check", "epilogue_pass": res})
    hist_main = None
    for B in (64, 256):
        for S in (8, 64):
            for bits in (0, 8, 16):
                res = check_hist(ROWS, FEATURES, B, S, bits,
                                 seed=B + S + bits)
                emit({"phase": "kernel_check", "hist_pass": res})
                if (B, S, bits) == (64, 64, 0):
                    hist_main = res
    plane_main = {}
    for Sp in (8, 64):
        for i, (bits, packed, masked) in enumerate(PLANE_VARIANTS):
            res = check_level(Rp, ROWS, PLANE_NUM_BIN, 64, Sp, seed=Sp + i,
                              quant_bits=bits, packed=packed, masked=masked)
            emit({"phase": "kernel_check", "plane": res})
            if Sp == 64:
                plane_main[res["variant"]] = res

    # ---- 3. end to end through lightgbm_tpu_torch.train
    X, y = _make_data(ROWS, FEATURES, seed=DATA_SEED)
    params = {"objective": "binary", "max_bin": 63, "num_leaves": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 1,
              "min_sum_hessian_in_leaf": 1e-3, "verbose": -1,
              "device_type": DEVICE}
    t0 = time.perf_counter()
    ds = lgb.Dataset(X, label=y, params=params).construct()
    construct_s = time.perf_counter() - t0
    F_oh, Bp = feature_layout(ds._inner.num_features, ds._inner.max_num_bin)
    # a Booster merges its parameters into its Dataset's, as LightGBM's
    # does, and a later Booster on that Dataset inherits them: every run
    # below clears the Dataset's parameters first (the dataset stays
    # binned), so bagging or tpu_engine never leak from one run into the
    # next

    def timed_train(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ds.params = {}
        b = lgb.train(params, ds, num_boost_round=rounds)
        torch.cuda.synchronize()
        return b, time.perf_counter() - t

    timed_train(1)                        # warm-up (allocator, library)
    _, t_one = timed_train(1)
    fl.reset_launch_counts()
    frontier2.host_syncs["count"] = 0
    bst, t_all = timed_train(ROUNDS)      # the main path
    launches = dict(fl.launches)
    cuda = dict(fl.cuda_launches)
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
           "launches": launches, "cuda_launches": cuda,
           "host_syncs_per_tree": syncs / n_trees,
           "predict_max_abs_err": pred_err, "predict_tol":
           "rtol=1e-5 atol=1e-5", "leaves": [m.num_leaves
                                              for m in bst.models]}
    emit(e2e)
    if n_trees != ROUNDS:
        raise AssertionError(f"trained {n_trees} trees, wanted {ROUNDS}")
    if not train_auc > 0.75:
        raise AssertionError(f"training AUC {train_auc} <= 0.75")
    for name in TRAIN_PATH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "train() path")
    if not ok_pred:
        raise AssertionError(f"predict differs from the trainer's scores "
                             f"by {pred_err}")
    check_stages(launches, cuda, "train()")

    # ---- 4. the loop bench.py times: Booster(params, train_set).update(),
    # on the epilogue body (a) and, in turns with it, the megastep body
    # train() runs (m); then (b) with bagging and feature_fraction
    bagged = {"bagging_fraction": 0.5, "bagging_freq": 1,
              "feature_fraction": 0.8}
    upd_launches = upd_cuda = None
    for name, extra, megastep in (("m", {}, True), ("a", {}, False),
                                  ("a", {}, False), ("m", {}, True),
                                  ("b", bagged, False)):
        res, n_launch, n_cuda = run_updates(lgb, dict(params, **extra), ds,
                                            X, y, megastep)
        emit({"phase": "update_path", "run": name, "params": extra, **res})
        if name == "a" and upd_launches is None:
            upd_launches, upd_cuda = n_launch, n_cuda

    # ---- 5. the frontier-v1 engine through train()
    fr_launches, fr_cuda = run_frontier(lgb, params, ds, X, y)

    # ---- 6. the histogram-plane cuts through train()
    plane_launches = run_plane_cuts(lgb, params, X, y)

    # ---- 7. the kernels line (level/route at Bp=64 int8, nch=5, Sp=64;
    # the epilogue at Bp=64 int8, nch=5, binary, Sp=64; hist_pass at Bp=64,
    # Sp=64, f32). Launches: the train() run for the three kernels of its
    # path, update() run (a) for the epilogue, the frontier train() run for
    # hist_pass
    lv, rt = main_cfg["level_pass"], main_cfg["route_pass"]
    rows = []
    for name, r, err, n, n_cuda in (
            ("level_pass", lv, lv["max_abs_err"], launches["level_pass"],
             cuda),
            ("route_pass", rt, rt["max_abs_err"], launches["route_pass"],
             cuda),
            ("table_lookup", lookup, lookup["max_abs_err"],
             launches["table_lookup"], cuda),
            ("epilogue_pass", epi_main,
             max(epi_main["hist_max_abs_err"], epi_main["gh_max_abs_err"],
                 epi_main["new_score_max_abs_err"]),
             upd_launches["epilogue_pass"], upd_cuda),
            ("hist_pass", hist_main, hist_main["max_abs_err"],
             fr_launches["hist_pass"], fr_cuda)):
        row = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], "launches": n,
               "cuda_launches": kernel_cuda_launches(name, n_cuda),
               "max_abs_err": err, "ms": r["kernel_ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if name == "table_lookup":
            row.update({k: r[k] for k in ("kernel_ms_per_call",
                                          "library_ms_per_call",
                                          "library_call")})
        if name in ("level_pass", "epilogue_pass"):
            row["stages_ms"] = r["stages_ms"]
        rows.append(row)
    # the variants at Sp=64 on the mixed layout, each with the launches of
    # the phase-6 run that takes it on every level_pass (VARIANT_RUNS); the
    # packed route_pass with run (b)'s
    variant_rows = [("level_pass", v, run, "level_pass:" + v)
                    for v, run in VARIANT_RUNS.items()]
    variant_rows.append(("route_pass", "quant16+packed+fmask", "b",
                         "route_pass:packed"))
    for kernel, check, run, counter in variant_rows:
        r = plane_main[check][kernel]
        n = plane_launches[run].get(counter, 0)
        if n <= 0 or n != plane_launches[run][kernel]:
            raise AssertionError(f"run ({run}) launched {kernel} "
                                 f"{plane_launches[run][kernel]} times, "
                                 f"{n} of them as {counter}")
        name = kernel + "[" + counter.split(":")[1] + "]"
        run_cuda = {k[5:]: v for k, v in plane_launches[run].items()
                    if k.startswith("cuda:")}
        rows.append({"name": name, "route": "cuda",
                     "source": SOURCES[kernel], "replaces": REPLACES[kernel],
                     "launches": n,
                     "cuda_launches": kernel_cuda_launches(kernel, run_cuda),
                     "max_abs_err": r["max_abs_err"],
                     "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    emit({"phase": "timing", "ms": "device time per launch: a CUDA graph "
          "of 20 wrapper calls replayed 5 times between two events, "
          "median", "plain_ms": "median of 20 (3 for the plain level, route, "
          "epilogue and hist passes) one-call event pairs, host included",
          "not_captured": timing_notes})
    emit({"kernels": rows})
    emit({"phase": "done", "smoke_s": time.perf_counter() - t_start})

    # ---- 8. the result line
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
