#!/usr/bin/env python3
"""What monotone constraints do to chip_smoke.py's phase-3 trees.

    python3 scripts/mono_schedule.py [--rows 1000000] [--rounds 10]
                                     [--device cpu] [--count-ops]

Trains chip_smoke.py's phase 3 configuration (its 1,000,000 x 28 draw,
max_bin=63, num_leaves=255, learning_rate=0.1) three times: unconstrained,
and with phase 12's constraints (``chip_smoke.mono_constraints``) in the
basic and the intermediate mode, through the megastep body. Prints one
JSON line per run: the training AUC, each tree's leaves, the seconds, and
with ``--count-ops`` the torch operators dispatched per iteration (a
``TorchDispatchMode`` count over two iterations after two warm-ups: on
the card each is at most one kernel launch). Runs on any device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# the repo root in place of scripts/, whose profile.py would shadow the
# standard module that torch's dispatch-mode import reaches
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--count-ops", action="store_true")
    args = ap.parse_args()
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    import chip_smoke as cs
    import lightgbm_tpu_torch as lgb

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            self.n += 1
            return func(*a, **(kw or {}))
    X, z, w = cs._class_rows(args.rows, cs.FEATURES, seed=cs.DATA_SEED)
    y = (z > 0).astype(np.float32)
    mono = cs.mono_constraints(w).tolist()
    params = {"objective": "binary", "max_bin": 63, "num_leaves": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 1,
              "min_sum_hessian_in_leaf": 1e-3, "verbose": -1,
              "device_type": args.device}
    for name, data_kw, extra in (
            ("unconstrained", {}, {}),
            ("basic", {"monotone_constraints": mono}, {}),
            ("intermediate", {"monotone_constraints": mono},
             {"monotone_constraints_method": "intermediate"})):
        ds = lgb.Dataset(X, label=y, params=dict(params, **data_kw))
        t = time.perf_counter()
        bst = lgb.train(dict(params, **extra), ds, args.rounds)
        res = {"run": name, "rows": args.rows, "rounds": args.rounds,
               "device": args.device,
               "train_s": time.perf_counter() - t,
               "train_auc": cs.auc(bst.train_scores().float().cpu()
                                   .numpy(), y),
               "leaves": [m.num_leaves for m in bst.models]}
        if args.count_ops:
            b = lgb.Booster(dict(params, **extra), ds)
            b._gbdt.arm_megastep(True)
            for _ in range(2):
                b.update()
            c = Count()
            with c:
                for _ in range(2):
                    b.update()
            res["ops_per_iter"] = c.n / 2
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
