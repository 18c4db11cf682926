#!/usr/bin/env python3
"""``predict_pass`` of two or more checkouts of the port, timed on the same
card in one run, on the same random tree stacks.

    python3 scripts/predict_pass_ab.py ROOT [ROOT ...] [--out FILE]

Each ROOT is a checkout of the repository (for example the parent commit,
unpacked with ``git archive`` into a git-ignored directory, and this one:
``_parent . . _parent``, so that a drift of the card's clock shows as a
difference between the two runs of one checkout). Each ROOT runs in a
process of its own, which imports that checkout's ``lightgbm_tpu_torch``,
builds its kernels and times its ``ops.predict.predict_pass`` on the
shapes of ``chip_smoke.py`` phase 15e (28 features; 200 trees of 255
leaves binned at 1,024, 65,536 and 1,000,000 rows and raw at 1,024 and
65,536; 20 trees of 255 leaves with categorical nodes, binned and raw, at
1,024; 60 trees of 63 leaves with categorical nodes and k = 3 at 1,024).
The stacks are random (numpy ``RandomState`` seeded per shape): trees grown
by splitting a random leaf, random split features, thresholds, default
directions and missing types, and rows that hit the missing bins, NaN and
zero. A checkout whose stack takes the node records (``RECORDS``) gets them
from its own ``pack_records``.

Time per launch: 20 calls captured in one CUDA graph, replayed 5 times
between two CUDA events, the median replay over 20. Every checkout's
output on each shape must have the same bits as the first's (its SHA-256),
else the script exits 1. Prints one JSON line per ROOT and shape, then one
summary line ``{"shapes": {name: {root: [ms, ...]}}, "same_bits": ...}``
(also written to ``--out``). Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

# (name, variant, rows, trees, leaves, k, categorical)
SHAPES = (
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


def cuda_ms(fn, reps=20, replays=5):
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


def run_one(root):
    """Time this process's checkout (``root`` first on sys.path)."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from lightgbm_tpu_torch.ops import predict as tp
    if not torch.cuda.is_available():
        raise SystemExit("predict_pass_ab: no CUDA device is available")
    dev = torch.device("cuda")
    for i, (name, variant, R, T, L, k, cat) in enumerate(SHAPES):
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
        out = call().cpu().numpy()
        rec = {"root": root, "shape": name, "rows": R, "trees": T,
               "leaves": L, "k": k, "max_steps": steps,
               "ms": cuda_ms(call),
               "sha256": hashlib.sha256(out.tobytes()).hexdigest(),
               "finite": bool(np.isfinite(out).all())}
        print(json.dumps(rec), flush=True)
        del e, ops, out
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--out", default=None)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        run_one(args.roots[0])
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    card = smi[0] if smi else "not read"
    print(card, flush=True)
    recs = []
    for root in args.roots:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", root], capture_output=True, text=True)
        sys.stderr.write(p.stderr[-4000:])
        if p.returncode != 0:
            print(json.dumps({"root": root, "rc": p.returncode}))
            return 1
        for line in p.stdout.splitlines():
            print(line, flush=True)
            recs.append(json.loads(line))
    shapes, same = {}, True
    for name, *_ in SHAPES:
        mine = [r for r in recs if r["shape"] == name]
        same &= len({r["sha256"] for r in mine}) == 1 \
            and all(r["finite"] for r in mine)
        per = shapes.setdefault(name, {})
        for r in mine:
            per.setdefault(r["root"], []).append(r["ms"])
    summary = {"card": card, "shapes": shapes, "same_bits": same}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "records": recs, **summary}, fh,
                      indent=1)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
