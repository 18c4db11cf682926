#!/usr/bin/env python3
"""One family of the port's hand-written kernels, of two or more checkouts
of the port, timed on the same card in one run, on the same operands.

    python3 scripts/kernel_ab.py FAMILY ROOT [ROOT ...] [--out FILE]

Each ROOT is a checkout of the repository (for example the parent commit,
unpacked with ``git archive`` into a git-ignored directory, and this one:
``_parent . . _parent``, so that a drift of the card's clock shows as a
difference between the two runs of one checkout). Each ROOT runs in a
process of its own, which imports that checkout's ``lightgbm_tpu_torch``,
builds its kernels and times the family on its shapes (numpy
``RandomState`` operands, seeded per shape). FAMILY is one of:

``predict_pass``
    ``ops.predict.predict_pass`` on the shapes of ``chip_smoke.py`` phase
    15e (28 features; 200 trees of 255 leaves binned at 1,024, 65,536 and
    1,000,000 rows and raw at 1,024 and 65,536; 20 trees of 255 leaves with
    categorical nodes, binned and raw, at 1,024; 60 trees of 63 leaves with
    categorical nodes and k = 3 at 1,024). The stacks are random: trees
    grown by splitting a random leaf, random split features, thresholds,
    default directions and missing types, and rows that hit the missing
    bins, NaN and zero. A checkout whose stack takes the node records
    (``RECORDS``) gets them from its own ``pack_records``.
``list``
    the leaf-wise grower's list kernels (``ops.data_partition``) on the
    shapes of ``chip_smoke.py`` phase 14a (1,000,000 rows, 28 features, 63
    bins): ``leaf_hist`` on a leaf of 1, 512, 3,041 listed rows (14a's step
    100), 30,000, 500,000 (a first split's child) and every row (the
    root), and on a step that does not split (its floor), beside
    ``index_add_`` over the leaf's precomputed cells and the five-kernel
    ``hist_pass`` on ``slot = (row_leaf == leaf)``; ``leaf_partition`` of
    a segment of 6,893 rows (14a's step 100), 100,000 and every row, beside
    one stable ``torch.sort`` of the segment's left flags (each timed call
    starts from the same state: three restoring copies, timed alone and
    taken off).

Time per launch: 20 calls captured in one CUDA graph, replayed 5 times
between two CUDA events, the median replay. Every checkout's output on
each shape must have the same bits as the first's (its SHA-256), and be
finite, else the script exits 1. Prints the card's name and power limit,
one JSON line per ROOT and shape, then one summary line ``{"shapes":
{name: {root: [ms, ...]}}, "same_bits": ...}`` (also written to
``--out``). Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys


def cuda_ms(fn, reps=20, replays=5):
    """Device ms per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, the median of ``replays`` replays between two events."""
    import numpy as np
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def _digest(*arrays):
    """(SHA-256 of the arrays' bytes, whether every value is finite)."""
    import numpy as np
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest(), all(bool(np.isfinite(a).all()) for a in arrays)


# ------------------------------------------------------------ predict_pass
# (name, variant, rows, trees, leaves, k, categorical)
PREDICT_SHAPES = (
    ("binned,R=1024", "binned", 1024, 200, 255, 1, False),
    ("binned,R=65536", "binned", 65_536, 200, 255, 1, False),
    ("binned,R=1000000", "binned", 1_000_000, 200, 255, 1, False),
    ("raw,R=1024", "raw", 1024, 200, 255, 1, False),
    ("raw,R=65536", "raw", 65_536, 200, 255, 1, False),
    ("binned,categorical,R=1024", "binned", 1024, 20, 255, 1, True),
    ("raw,categorical,R=1024", "raw", 1024, 20, 255, 1, True),
    ("binned,categorical,k=3,R=1024", "binned", 1024, 60, 63, 3, True),
)
FEATURES = 28
CATEGORIES = 64             # the raw variant's category values


def _children(rng, L):
    """Children [L - 1] of a tree of L leaves grown by splitting a random
    leaf each step (a child < 0 is ~leaf), and its depth."""
    N = L - 1
    left, right, slot = [], [], {0: None}
    for i in range(N):
        leaf = int(rng.randint(0, i + 1))
        left.append(~leaf)
        right.append(~(i + 1))
        if slot[leaf] is not None:
            node, side = slot[leaf]
            (left if side == 0 else right)[node] = i
        slot[leaf], slot[i + 1] = (i, 0), (i, 1)
    depth, frontier = 0, [0] if N else []
    while frontier:
        depth += 1
        frontier = [c for nd in frontier for c in (left[nd], right[nd])
                    if c >= 0]
    return left, right, depth


def make_stack(variant, R, T, L, k, cat, seed):
    """(enc [R, F], {field: numpy array} in ``FIELDS[variant]`` order,
    tids [T], max_steps) of one random stack."""
    import numpy as np
    rng = np.random.RandomState(seed)
    F, N = FEATURES, L - 1
    lc = np.full((T, N), -1, np.int32)
    rc = np.full((T, N), -1, np.int32)
    depth = 1
    for t in range(T):
        left, right, d = _children(rng, L)
        lc[t], rc[t] = left, right
        depth = max(depth, d)
    sf = rng.randint(0, F, (T, N)).astype(np.int32)
    out = {"sf": sf, "dl": rng.rand(T, N) < 0.5, "lc": lc, "rc": rc,
           "lv": rng.randn(T, L).astype(np.float32),
           "cf": (rng.rand(T, N) < 0.2) if cat else None}
    if variant == "binned":
        num_bin = rng.randint(8, 64, F).astype(np.int32)
        default_bin = (rng.randint(0, 10**6, F) % num_bin).astype(np.int32)
        enc = (rng.randint(0, 10**6, (R, F)) % num_bin).astype(np.int32)
        hit = rng.rand(R, F)
        enc = np.where(hit < 0.1, default_bin, enc)
        enc = np.where(hit > 0.9, num_bin - 1, enc).astype(np.int32)
        out.update(tb=(rng.randint(0, 10**6, (T, N))
                       % num_bin[sf]).astype(np.int32),
                   cm=(rng.rand(T, N, int(num_bin.max())) < 0.5)
                   if cat else None,
                   num_bin=num_bin,
                   missing=np.resize(np.array([0, 1, 2], np.int32), F),
                   default_bin=default_bin)
        names = ("sf", "tb", "dl", "lc", "rc", "lv", "cf", "cm", "num_bin",
                 "missing", "default_bin")
    else:
        enc = (rng.randn(R, F) * 2).astype(np.float32)
        hit = rng.rand(R, F)
        enc[hit < 0.08] = np.nan
        enc[(hit >= 0.08) & (hit < 0.14)] = 0.0
        if cat:
            codes = rng.randint(-1, CATEGORIES + 2, (R, F))
            enc[hit > 0.5] = codes[hit > 0.5]
        out.update(th=(rng.randn(T, N) * 2).astype(np.float32),
                   mt=rng.randint(0, 3, (T, N)).astype(np.int32),
                   cm=(rng.rand(T, N, CATEGORIES) < 0.5) if cat else None)
        names = ("sf", "th", "dl", "mt", "lc", "rc", "lv", "cf", "cm")
    tids = (np.arange(T) % k).astype(np.int32)
    steps = 1 << max(1, depth.bit_length())
    return enc, {n: out[n] for n in names}, tids, steps


def run_predict_pass(dev):
    import torch
    from lightgbm_tpu_torch.ops import predict as tp
    for i, (name, variant, R, T, L, k, cat) in enumerate(PREDICT_SHAPES):
        enc, arrays, tids, steps = make_stack(variant, R, T, L, k, cat,
                                              seed=100 + i)
        ops = tuple(None if arrays[n] is None
                    else torch.as_tensor(arrays[n]).to(dev)
                    for n in tp.FIELDS[variant])
        if hasattr(tp, "RECORDS"):
            ops = ops + tuple(tp.pack_records(ops, variant))
        e = torch.as_tensor(enc).to(dev)
        t = torch.as_tensor(tids).to(dev)

        def call():
            return tp.predict_pass(e, ops, t, k, steps, variant)
        sha, finite = _digest(call().cpu().numpy())
        yield {"shape": name, "rows": R, "trees": T, "leaves": L, "k": k,
               "max_steps": steps, "ms": cuda_ms(call), "sha256": sha,
               "finite": finite}
        del e, ops
        torch.cuda.empty_cache()


# -------------------------------------------------------------------- list
R_LIST, FP, BK = 1_000_000, 28, 63
HIST_ROWS = (1, 512, 3_041, 30_000, 500_000, R_LIST)
PART_ROWS = (6_893, 100_000, R_LIST)


def _state(row_leaf, L, dev):
    """Rows grouped by leaf in row order, each leaf's begin and length."""
    import numpy as np
    import torch
    order = np.argsort(row_leaf, kind="stable").astype(np.int32)
    rows = np.bincount(row_leaf, minlength=L).astype(np.int32)
    begin = np.concatenate([[0], np.cumsum(rows)[:-1]]).astype(np.int32)
    return [torch.as_tensor(a).to(dev) for a in (order, begin, rows)]


def _leaf_rows(rng, n):
    """row_leaf with n rows in leaf 1 (or every row in leaf 0 when n = R)."""
    import numpy as np
    row_leaf = np.zeros(R_LIST, np.int64)
    if n < R_LIST:
        row_leaf[rng.choice(R_LIST, n, replace=False)] = 1
    return row_leaf, (1 if n < R_LIST else 0)


def run_list(dev):
    import numpy as np
    import torch
    from lightgbm_tpu_torch.ops import data_partition as dp
    from lightgbm_tpu_torch.ops import pallas_histogram as ph
    rng = np.random.RandomState(17)
    kbins = torch.as_tensor(rng.randint(0, BK, (R_LIST, FP))
                            .astype(np.int32)).to(dev)
    gh = torch.as_tensor(np.stack([rng.randn(R_LIST),
                                   rng.rand(R_LIST) * 0.25,
                                   np.ones(R_LIST)], 1)
                         .astype(np.float32)).to(dev)
    one = torch.ones(1, dtype=torch.bool, device=dev)

    def leaf_t(v):
        return torch.tensor([v], dtype=torch.int64, device=dev)
    for n in HIST_ROWS:
        row_leaf, leaf = _leaf_rows(np.random.RandomState(n), n)
        order, begin, rows = _state(row_leaf, 2, dev)
        lf = leaf_t(leaf)
        out = dp.leaf_hist(kbins, gh, order, begin, rows, lf, one,
                           num_bins=BK)
        listed = order[int(begin[leaf]):int(begin[leaf]) + n].long()
        cell = (torch.arange(FP, device=dev) * BK
                + kbins[listed].long()).reshape(-1)
        src = gh[listed][:, None, :].expand(-1, FP, -1).reshape(-1, 3)
        slot = torch.as_tensor(np.where(row_leaf == leaf, 0, -1)
                               .astype(np.int32)).to(dev)
        sha, finite = _digest(out.cpu().numpy())
        yield {"shape": f"leaf_hist,n={n}", "rows": n,
               "ms": cuda_ms(lambda: dp.leaf_hist(
                   kbins, gh, order, begin, rows, lf, one, num_bins=BK)),
               "index_add_ms": cuda_ms(lambda: torch.zeros(
                   (FP * BK, 3), device=dev).index_add_(0, cell, src),
                   reps=5),
               "hist_pass_ms": cuda_ms(lambda: ph.hist_pass(
                   kbins, gh, slot, S=1, Bp=BK, nch=3, unrounded=True)),
               "sha256": sha, "finite": finite}
    row_leaf, leaf = _leaf_rows(np.random.RandomState(3), 3_041)
    order, begin, rows = _state(row_leaf, 2, dev)
    off = torch.zeros(1, dtype=torch.bool, device=dev)
    lf = leaf_t(leaf)
    sha, finite = _digest(dp.leaf_hist(kbins, gh, order, begin, rows, lf,
                                       off, num_bins=BK).cpu().numpy())
    yield {"shape": "leaf_hist,no split", "rows": 0,
           "ms": cuda_ms(lambda: dp.leaf_hist(kbins, gh, order, begin, rows,
                                              lf, off, num_bins=BK)),
           # one fill of the planes' size: a launch's floor in a graph
           "fill_ms": cuda_ms(lambda: torch.zeros((3, FP, BK), device=dev)),
           "sha256": sha, "finite": finite}
    for n in PART_ROWS:
        row_leaf, leaf = _leaf_rows(np.random.RandomState(n + 1), n)
        order, begin, rows = _state(row_leaf, 3, dev)
        table = torch.as_tensor(np.random.RandomState(n).rand(BK) < 0.5) \
            .to(dev)
        b = int(begin[leaf])
        args = (leaf_t(leaf), leaf_t(2), one, kbins, leaf_t(3), table)
        scratch = torch.empty(R_LIST, dtype=torch.int32, device=dev)
        o, bg, rw = order.clone(), begin.clone(), rows.clone()

        def restore():
            o[b:b + n].copy_(order[b:b + n])
            bg.copy_(begin)
            rw.copy_(rows)

        def kernel():
            restore()
            dp.leaf_partition(o, scratch, bg, rw, *args)
        kernel()
        sha, finite = _digest(o.cpu().numpy(), bg.cpu().numpy(),
                              rw.cpu().numpy())
        flags = table[kbins[order[b:b + n].long(), 3].long()]
        keys = (~flags).to(torch.uint8)
        restore_ms = cuda_ms(restore)
        yield {"shape": f"leaf_partition,n={n}", "rows": n,
               "ms": cuda_ms(kernel) - restore_ms, "restore_ms": restore_ms,
               "sort_ms": cuda_ms(lambda: torch.sort(keys, stable=True)),
               "sha256": sha, "finite": finite}


FAMILIES = {"predict_pass": run_predict_pass, "list": run_list}


def run_one(family, root):
    """Time ``family`` in this process's checkout (``root`` first on
    sys.path), one JSON line a shape."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device is available")
    for rec in FAMILIES[family](torch.device("cuda")):
        print(json.dumps({"root": root, **rec}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("family", choices=sorted(FAMILIES))
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--out", default=None)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        run_one(args.family, args.roots[0])
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    card = smi[0] if smi else "not read"
    print(card, flush=True)
    recs = []
    for root in args.roots:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            args.family, root, "--one"],
                           capture_output=True, text=True)
        sys.stderr.write(p.stderr[-4000:])
        if p.returncode != 0:
            print(json.dumps({"root": root, "rc": p.returncode}))
            return 1
        for line in p.stdout.splitlines():
            print(line, flush=True)
            recs.append(json.loads(line))
    shapes, same = {}, True
    for rec in recs:
        shapes.setdefault(rec["shape"], {}).setdefault(
            rec["root"], []).append(rec["ms"])
    for name in shapes:
        mine = [r for r in recs if r["shape"] == name]
        same &= len({r["sha256"] for r in mine}) == 1 \
            and all(r["finite"] for r in mine)
    summary = {"card": card, "family": args.family, "shapes": shapes,
               "same_bits": same}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "records": recs, **summary}, fh,
                      indent=1)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
