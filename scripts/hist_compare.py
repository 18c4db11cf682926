#!/usr/bin/env python3
"""Time ``hist_pass`` of a checkout of lightgbm_tpu_torch on the card, at
the shapes ``chip_smoke.py``'s ``check_hist`` holds it to, plus the root
level's (every row in slot 0).

    python3 scripts/hist_compare.py [--root DIR] [--tag NAME] [--stages]
                                    [--shapes Bp,S,bits,slots ...]
                                    [--frontier]

``--root`` is the checkout whose package is timed (default: this one), so
two commits compare in one call on one card: unpack the other into a
directory ``.gitignore`` lists and run parent, change, change, parent.
Prints the card (nvidia-smi name and power limit), then one JSON line per
shape: device ms per launch (``chip_smoke.cuda_ms``: 20 wrapper calls
captured in one CUDA graph, replayed 5 times, median). Inputs as
``check_hist`` makes them: R = 1,000,000 rows, Fp = 28, int32 bins in
[0, Bp - 1), ~30% of the rows at slot -1 with non-zero gh, f32 (g, h, w)
or the int8 channels of 8 or 16 bits. ``--stages`` also times each CUDA
kernel of a call alone (a checkout that has them); ``--frontier`` also
trains ``chip_smoke.py``'s phase-5 run with the checkout's package
(``train(tpu_engine="frontier")``, 1,000,000 x 28 rows, 10 rounds) and
prints its training AUC, leaves, ``hist_pass`` calls and sec/iter.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROWS = 1_000_000
FEATURES = 28
# (Bp, S, quant bits, slots) as check_hist runs them, then the root level
SHAPES = [(B, S, bits, "random") for B in (64, 256) for S in (8, 64)
          for bits in (0, 8, 16)] + [(64, 8, 0, "root")]


def make_inputs(torch, q, B, S, bits, slots, seed):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, B - 1, (ROWS, FEATURES), generator=gen,
                         device=dev, dtype=torch.int32)
    slot = torch.randint(0, S, (ROWS,), generator=gen, device=dev,
                         dtype=torch.int32)
    slot[torch.rand(ROWS, generator=gen, device=dev) < 0.3] = -1
    if slots == "root":
        slot.zero_()
    g = torch.randn(ROWS, generator=gen, device=dev)
    h = torch.rand(ROWS, generator=gen, device=dev) * 0.25
    w = torch.ones(ROWS, device=dev)
    if bits:
        scales = q.quant_scales(g, h, bits)
        gh = torch.stack(q.encode_channels(
            *q.quantize_gh(g, h, scales, bits, seed), w, bits), 1)
    else:
        gh = torch.stack([g, h, w], 1)
    return bins, gh.contiguous(), slot


def stage_times(ph, cuda_ms, bins, gh, slot, kw):
    """Each CUDA kernel of one hist_pass call timed alone, on buffers a
    whole call filled first (a kernel reads what the earlier ones
    wrote), and the tile kernel's shape."""
    from lightgbm_tpu_torch.ops.fused_level import HIST_KERNELS
    lkw = dict(Bp=kw["Bp"], nch=kw["nch"], quant=kw["quant"])
    buf = ph.hist_buffers(bins, S=kw["S"], **lkw)
    ph._hist_launch(HIST_KERNELS, bins, gh, slot, buf, **lkw)

    def stage(k):
        return lambda: ph._hist_launch((k,), bins, gh, slot, buf, **lkw)
    return {"stages_ms": {k: cuda_ms(stage(k)) for k in HIST_KERNELS},
            "tile_blocks": buf["blocks"],
            "channels_per_block": buf["channels_per_block"],
            "adding_warps": buf["warps"]}


def frontier_train(torch):
    """chip_smoke.py's frontier run with the imported package: AUC after
    10 rounds, leaves, hist_pass calls, sec/iter after the first round."""
    import time
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import fused_level as fl
    from chip_smoke import DATA_SEED, ROUNDS, _make_data, auc
    X, y = _make_data(ROWS, FEATURES, seed=DATA_SEED)
    params = {"objective": "binary", "max_bin": 63, "num_leaves": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 1,
              "min_sum_hessian_in_leaf": 1e-3, "verbose": -1,
              "device_type": "cuda", "tpu_engine": "frontier"}
    ds = lgb.Dataset(X, label=y, params=params).construct()

    def timed(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ds.params = {}
        b = lgb.train(params, ds, num_boost_round=rounds)
        torch.cuda.synchronize()
        return b, time.perf_counter() - t
    timed(1)
    _, t_one = timed(1)
    fl.reset_launch_counts()
    bst, t_all = timed(ROUNDS)
    scores = bst.train_scores().float().cpu().numpy()
    return {"frontier_train_auc": auc(scores, y),
            "leaves": [m.num_leaves for m in bst.models],
            "hist_pass_calls": fl.launches["hist_pass"],
            "sec_per_iter_after_first": (t_all - t_one) / (ROUNDS - 1)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
    ap.add_argument("--stages", action="store_true",
                    help="also time each CUDA kernel of the call alone "
                         "(a checkout with ops/pallas_histogram's "
                         "hist_buffers and _hist_launch)")
    ap.add_argument("--frontier", action="store_true")
    ap.add_argument("--shapes", nargs="*", default=None,
                    help="only these shapes, each Bp,S,bits,slots "
                         "(e.g. 64,64,0,random)")
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    import torch
    if not torch.cuda.is_available():
        print("hist_compare: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from chip_smoke import cuda_ms            # this checkout's timer
    sys.path.insert(0, os.path.abspath(args.root))
    for name in [m for m in sys.modules if m.startswith("lightgbm_tpu_torch")]:
        del sys.modules[name]
    from lightgbm_tpu_torch.ops import pallas_histogram as ph
    from lightgbm_tpu_torch.ops import quantize as q
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"root": os.path.abspath(args.root), "tag": args.tag,
                      "package": ph.__file__, "nvidia_smi": smi}),
          flush=True)
    shapes = SHAPES
    if args.shapes:
        shapes = [(int(b), int(s), int(q), sl) for b, s, q, sl in
                  (x.split(",") for x in args.shapes)]
    for B, S, bits, slots in shapes:
        bins, gh, slot = make_inputs(torch, q, B, S, bits, slots,
                                     seed=B + S + bits)
        kw = dict(S=S, Bp=B, nch=gh.shape[1], quant=bool(bits))
        ms = cuda_ms(lambda: ph.hist_pass(bins, gh, slot, **kw))
        row = {"tag": args.tag, "Bp": B, "S": S,
               "variant": f"quant{bits}" if bits else "f32",
               "slots": slots, "ms": ms}
        if args.stages:
            row.update(stage_times(ph, cuda_ms, bins, gh, slot, kw))
        print(json.dumps(row), flush=True)
    if args.frontier:
        print(json.dumps(dict(frontier_train(torch), tag=args.tag)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
