"""Run one function on W local ranks, each a process of its own.

    from lightgbm_tpu_torch.parallel.spawn import run_ranks
    results = run_ranks("my_module:rank_main", 2, args=(cfg,),
                        workdir="/tmp/run", device_type="cuda")

Each rank is a fresh ``python -m lightgbm_tpu_torch.parallel.spawn``
process: it joins a group through a ``file://`` store under ``workdir``
(no port to guess, so concurrent runs cannot collide), with the backend
of ``mesh.choose_backend`` unless one is given and a collective timeout,
calls ``fn(rank, world, *args)`` and pickles what it returns. The parent
builds nothing and joins the ranks by ``deadline_s``: a rank that exits
with an error, or a run past the deadline, kills every rank and raises
with the failing rank's last output, so a dead rank fails the run instead
of hanging it.

``target`` is ``"module:function"`` or ``"path/to/file.py:function"``;
the function and its arguments must be importable and picklable without
the parent's state.
"""
from __future__ import annotations

import importlib
import importlib.util
import os
import pickle
import subprocess
import sys
import time
from typing import Any, List, Optional, Sequence


def _load(target: str):
    mod, fn = target.rsplit(":", 1)
    if mod.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            "_rank_target_" + os.path.basename(mod)[:-3], mod)
        m = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(m)
    else:
        m = importlib.import_module(mod)
    return getattr(m, fn)


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, "rb") as fh:
            fh.seek(0, 2)
            fh.seek(max(0, fh.tell() - n))
            return fh.read().decode("utf-8", "replace")
    except OSError:
        return ""


def run_ranks(target: str, world: int, args: Sequence[Any] = (),
              workdir: str = ".", device_type: str = "cpu",
              backend: Optional[str] = None, deadline_s: float = 300.0,
              timeout_s: float = 60.0, threads: int = 2,
              env: Optional[dict] = None) -> List[Any]:
    """Run ``target`` on ``world`` ranks and return their results in rank
    order (see the module docstring)."""
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(os.path.abspath(workdir), "store")
    if os.path.exists(store):
        os.remove(store)
    penv = dict(os.environ)
    penv.setdefault("OMP_NUM_THREADS", str(threads))
    penv["PYTHONPATH"] = os.pathsep.join(
        [p for p in sys.path if p] + [penv.get("PYTHONPATH", "")])
    if env:
        penv.update(env)
    procs = []
    for r in range(world):
        payload = os.path.join(workdir, f"rank{r}.in.pkl")
        with open(payload, "wb") as fh:
            pickle.dump({"target": target, "rank": r, "world": world,
                         "args": tuple(args), "init": "file://" + store,
                         "device_type": device_type, "backend": backend,
                         "timeout": timeout_s, "threads": threads,
                         "out": os.path.join(workdir, f"rank{r}.out.pkl")},
                        fh)
        log = open(os.path.join(workdir, f"rank{r}.log"), "wb")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "lightgbm_tpu_torch.parallel.spawn",
             payload], stdout=log, stderr=subprocess.STDOUT, env=penv),
            log))
    t_end = time.monotonic() + deadline_s
    failed = None
    try:
        while True:
            codes = [p.poll() for p, _ in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = (f"rank {bad[0]} exited with code {codes[bad[0]]}",
                          bad[0])
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > t_end:
                failed = (f"ranks still running after {deadline_s:.0f} s",
                          codes.index(None))
                break
            time.sleep(0.05)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    if failed is not None:
        msg, r = failed
        raise RuntimeError(f"{msg}; its output ends:\n"
                           + _tail(os.path.join(workdir, f"rank{r}.log")))
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.out.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    return out


def _rank_main(payload_path: str) -> None:
    with open(payload_path, "rb") as fh:
        job = pickle.load(fh)
    import torch
    torch.set_num_threads(int(job["threads"]))
    from . import distributed
    distributed.init_distributed(job["init"], job["world"], job["rank"],
                                 device_type=job["device_type"],
                                 backend=job["backend"],
                                 timeout=job["timeout"])
    try:
        res = _load(job["target"])(job["rank"], job["world"], *job["args"])
    finally:
        distributed.free_network()
    with open(job["out"] + ".tmp", "wb") as fh:
        pickle.dump(res, fh)
    os.replace(job["out"] + ".tmp", job["out"])


if __name__ == "__main__":
    _rank_main(sys.argv[1])
