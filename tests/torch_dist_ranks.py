"""Rank programs of the port's distributed tests (not a test module).

Each function runs inside one rank that ``parallel.spawn.run_ranks``
started (a process of its own, already in a gloo group on the CPU); it
imports no JAX and returns plain numpy data. The data comes from a seed,
so every rank and the pytest process make the same rows.
"""
import numpy as np
import torch


def grower_data(R=4096, F=6, B=16, seed=4, cat=False):
    """Binned rows and [g, h, w] of the grower-level tests."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (R, F)).astype(np.uint8)
    g = ((bins[:, 0] > 7) * 1.0 - (bins[:, 1] > 9) * 0.6
         + 0.3 * (bins[:, 2] % 3 == 0) + 0.2 * rng.randn(R))
    if cat:
        g = g + 0.8 * np.isin(bins[:, 3], [2, 5, 11])
    gh = np.stack([g, rng.rand(R) * 0.5 + 0.5, np.ones(R)], 1) \
        .astype(np.float32)
    return bins, gh


def tree_np(tree, row_leaf):
    d = {k: getattr(tree, k).detach().cpu().numpy()
         for k in ("split_feature", "threshold_bin", "default_left",
                   "left_child", "right_child", "leaf_value", "leaf_count",
                   "split_gain", "leaf_depth")}
    d["num_leaves"] = int(tree.num_leaves)
    d["row_leaf"] = row_leaf.detach().cpu().numpy()
    return d


def _meta(F, B, cat_cols=()):
    from lightgbm_tpu_torch.models.learner import FeatureMeta
    nb = torch.full((F,), B, dtype=torch.int32)
    z = torch.zeros(F, dtype=torch.int32)
    is_cat = None
    if cat_cols:
        is_cat = torch.zeros(F, dtype=torch.bool)
        is_cat[list(cat_cols)] = True
    return FeatureMeta(nb, z, z, z, is_cat)


def grower_rank(rank, world, cases):
    """The XLA growers on this rank: every case of ``cases`` (a list of
    dicts: mode data|voting|feature, policy, L, top_k, cat) on the rows of
    ``grower_data``, sharded into contiguous blocks (replicated under
    feature). Returns {case name: tree dict}, and the trace of each."""
    import torch.distributed as dist
    from lightgbm_tpu_torch.ops.collectives import CollectiveTrace
    from lightgbm_tpu_torch.ops.split import SplitParams
    from lightgbm_tpu_torch.parallel import (make_feature_parallel_grow_fn,
                                             make_sharded_grow_fn,
                                             make_voting_parallel_grow_fn)
    from lightgbm_tpu_torch.parallel.mesh import shard_rows
    group = dist.group.WORLD
    out = {}
    for c in cases:
        bins, gh = grower_data(cat=c.get("cat", False))
        R, F = bins.shape
        B = 16
        cat_cols = (3,) if c.get("cat") else ()
        cat_idx = torch.tensor(cat_cols) if cat_cols else None
        params = SplitParams(min_data_in_leaf=10, lambda_l2=1.0)
        meta = _meta(F, B, cat_cols)
        fm = torch.ones(F, dtype=torch.bool)
        if c["mode"] == "feature":
            fn = make_feature_parallel_grow_fn(group, params, c["L"], B,
                                               cat_idx=cat_idx)
            xb, xg = bins, gh
        else:
            if c["mode"] == "voting" and c["policy"] == "depthwise":
                fn = make_voting_parallel_grow_fn(group, params, c["L"], B,
                                                  top_k=c["top_k"],
                                                  cat_idx=cat_idx)
            elif c["mode"] == "voting":
                from lightgbm_tpu_torch.models.learner import \
                    grow_tree_leafwise

                def fn(b, g, m, f, c=c):
                    return grow_tree_leafwise(
                        b, g, m, f, params, c["L"], B, cat_idx=cat_idx,
                        group=group, parallel_mode="voting",
                        top_k=c["top_k"])
            else:
                fn = make_sharded_grow_fn(group, params, c["L"], B,
                                          policy=c["policy"],
                                          cat_idx=cat_idx)
            xb = shard_rows(bins, rank, world)
            xg = shard_rows(gh, rank, world)
        with CollectiveTrace() as rec:
            tree, rl = fn(torch.as_tensor(xb), torch.as_tensor(xg), meta, fm)
        d = tree_np(tree, rl)
        d["trace"] = (rec.count, rec.bytes, dict(rec.by_dtype))
        out[c["name"]] = d
    return out


# ------------------------------------------------------- train() level
N_TRAIN = 8192          # a multiple of 2 x 2048: no rank block is padded


def train_data(kind="binary", n=N_TRAIN, seed=0):
    """(X, y) of the train()-level tests: 6 features on a signal; ``cat``
    makes column 3 categorical (8 values), ``efb`` appends two mutually
    exclusive sparse columns."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    if kind == "cat":
        X[:, 3] = rng.randint(0, 8, n)
    z = X[:, 0] + 0.6 * X[:, 1] - 0.4 * X[:, 2] + 0.3 * rng.randn(n)
    if kind == "cat":
        z = z + 0.8 * np.isin(X[:, 3], [1, 4, 6])
    if kind == "efb":
        a = np.where(rng.rand(n) < 0.05, rng.rand(n) + 1, 0.0)
        b = np.where((a == 0) & (rng.rand(n) < 0.05), rng.rand(n) + 1, 0.0)
        X = np.column_stack([X, a, b])
    if kind == "multiclass":
        y = np.digitize(z, [-0.6, 0.6]).astype(float)
    elif kind == "rank":
        # graded relevance 0-3, for the ranking objectives and metrics
        y = np.digitize(z, [0.0, 0.8, 1.6]).astype(float)
    elif kind == "l2":
        y = z
    else:
        y = (z > 0).astype(float)
    return X, y


def rank_group(n, rank, seed=11):
    """Query sizes of 3-40 documents covering a rank's ``n`` rows (each
    rank holds whole queries; the sizes differ per rank)."""
    rng = np.random.RandomState(seed + rank)
    sizes = []
    while sum(sizes) < n:
        sizes.append(int(rng.randint(3, 41)))
    sizes[-1] -= sum(sizes) - n
    if sizes[-1] == 0:
        sizes.pop()
    return np.asarray(sizes, np.int64)


def global_group(n, world=2):
    """Every rank's query sizes in rank order: the serial run's group."""
    from lightgbm_tpu_torch.parallel.mesh import shard_rows
    return np.concatenate([
        rank_group(len(shard_rows(np.arange(n), r, world)), r)
        for r in range(world)])


def _case_params(c):
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
         "verbose": -1, "device_type": "cpu"}
    p.update(c.get("params", {}))
    return p


DATA = {"tree_learner": "data"}
# the train()-level configurations that two ranks must train as the
# serial model (voting included: at these blocks with 2 of 6 columns
# voted it grows the serial trees, in both packages)
DRIVER_CASES = {c["name"]: c for c in [
    dict(name="binary", params=DATA),
    dict(name="l2", data="l2", params=dict(DATA, objective="regression")),
    dict(name="multiclass", data="multiclass",
         params=dict(DATA, objective="multiclass", num_class=3)),
    dict(name="bagging", params=dict(DATA, bagging_fraction=0.7,
                                     bagging_freq=1)),
    dict(name="quant16", params=dict(DATA, tpu_quantized_grad=16)),
    dict(name="cat_mono", data="cat", cat=True,
         params=dict(DATA, monotone_constraints=[1, 0, 0, 0, 0, 0])),
    dict(name="valid_es", valid=True, early_stop=2, rounds=40,
         params=dict(DATA, learning_rate=0.5, num_leaves=31,
                     min_data_in_leaf=2, metric="binary_logloss")),
    dict(name="voting", params={"tree_learner": "voting", "top_k": 2}),
    dict(name="update", update=True, params=DATA),
    dict(name="xla", params=dict(DATA, tpu_engine="xla")),
]}


def serial_run(lib, case, workdir=None):
    """``case``'s serial model on all of train_data's rows, through
    ``lib``: the port, or the JAX package in the pytest process (on the
    CPU, its fused engine unless the case names another, as the port's
    ``auto`` resolves); a ranking case takes every rank's queries, a
    forced-splits case ``workdir``'s JSON. Returns the booster."""
    X, y = train_data(case.get("data", "binary"), n=case.get("n", N_TRAIN))
    p = _case_params(case)
    for k in ("tree_learner", "top_k"):
        p.pop(k, None)
    if lib.__name__ == "lightgbm_tpu":
        p.pop("device_type")
        p.setdefault("tpu_engine", "fused")
    if case.get("forced"):
        p["forcedsplits_filename"] = f"{workdir}/forced.json"
    kw = {"categorical_feature": [3]} if case.get("cat") else {}
    if case.get("query"):
        kw["group"] = global_group(len(y))
    ds = lib.Dataset(X, label=y, **kw)
    rounds = case.get("rounds", 3)
    if case.get("update"):
        bst = lib.Booster(p, ds)
        for _ in range(rounds):
            bst.update()
    else:
        valid, cbs = [], []
        if case.get("valid"):
            Xv, yv = train_data(n=2048, seed=7)
            valid = [lib.Dataset(Xv, label=yv, reference=ds)]
            cbs = [lib.early_stopping(case["early_stop"], verbose=False)]
        bst = lib.train(p, ds, rounds, valid_sets=valid, callbacks=cbs)
    bst.num_trees()         # drains the JAX package's lazily built trees
    return bst


def assert_same_as_jax(a, bj, case):
    """A rank's result ``a`` of ``case`` against the JAX package's serial
    booster ``bj`` (the pytest process): structure and leaf counts exact
    under ``torch_parity``'s tree rule, leaf values and predictions within
    1e-5, the early-stopping iteration equal."""
    from torch_parity import assert_same_trees
    X, _ = train_data(case.get("data", "binary"))
    assert_same_trees(a["models"], bj.models, X, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a["pred"], bj.predict(X, raw_score=True),
                               rtol=1e-5, atol=1e-5)
    if case.get("early_stop"):
        assert a["best_iteration"] == bj.best_iteration


def rank_rows(a, rank, world):
    from lightgbm_tpu_torch.parallel.mesh import shard_rows
    return shard_rows(a, rank, world)


def train_rank(rank, world, cases, workdir):
    """Every train() case on this rank's rows: {name: result}. A case
    returns its model text, host trees, predictions on every row, the
    bin mappers' digest, and the collective trace of its training; a case
    that raises returns the error's text."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.binning import mappers_digest
    from lightgbm_tpu_torch.ops.collectives import CollectiveTrace
    out = {}
    for c in cases:
        X, y = train_data(c.get("data", "binary"), n=c.get("n", N_TRAIN))
        Xr, yr = rank_rows(X, rank, world), rank_rows(y, rank, world)
        params = _case_params(c)
        if c.get("forced"):
            params["forcedsplits_filename"] = f"{workdir}/forced.json"
        if c.get("drop_rows") and rank == 1:
            Xr, yr = Xr[:0], yr[:0]      # a rank without rows
        try:
            if c.get("sparse"):
                import scipy.sparse as sp
                Xr = sp.csr_matrix(Xr)
            kw = {}
            if c.get("cat"):
                kw["categorical_feature"] = [3]
            if c.get("query"):
                kw["group"] = rank_group(len(yr), rank)
                if c.get("straddle"):
                    # rank 0's last query continues on rank 1
                    kw["group"][-1 if rank == 0 else 0] += \
                        3 if rank == 0 else -3
            ds = lt.Dataset(Xr, label=yr, **kw)
            if c.get("preconstruct"):
                # without tree_learner: binned from this rank's rows alone
                ds.params = {"device_type": params["device_type"]}
                ds.construct()
            valid = []
            if c.get("valid"):
                Xv, yv = train_data(c.get("data", "binary"), n=2048, seed=7)
                if c.get("valid") == "diverge" and rank == 1:
                    Xv = Xv[::-1].copy()
                valid = [lt.Dataset(Xv, label=yv, reference=ds)]
            cbs = ([lt.early_stopping(c["early_stop"], verbose=False)]
                   if c.get("early_stop") else [])
            bags = []
            with CollectiveTrace() as rec:
                if c.get("update"):
                    bst = lt.Booster(params, ds)
                    for _ in range(c.get("rounds", 3)):
                        bst.update()
                        bags.append(bst._gbdt._bag_host.copy())
                else:
                    bst = lt.train(params, ds, c.get("rounds", 3),
                                   valid_sets=valid, callbacks=cbs)
            res = {"text": bst.model_to_string(), "models": bst.models,
                   "pred": bst.predict(X, raw_score=True),
                   "digest": mappers_digest(ds._inner.mappers),
                   "best_iteration": bst.best_iteration,
                   "trace": (rec.count, rec.bytes, dict(rec.by_dtype)),
                   "bags": bags, "use_bundles": bst._gbdt.use_bundles,
                   "evals": (bst.eval_train() if params.get(
                       "is_provide_training_metric") else [])}
            if c.get("query"):
                # the rank's training scores, and its rank block's rows
                # (padded on the fused engine)
                res["scores"] = bst._gbdt.scores.double().cpu().numpy()
                res["block"] = bst._gbdt.mp.block
        except Exception as e:        # the refusal cases
            res = {"error": f"{type(e).__name__}: {e}"}
        out[c["name"]] = res
    return out


def warned_rank(rank, world, case):
    """The log lines of ``case``'s train() on this rank's rows."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.utils import log
    X, y = train_data(case.get("data", "binary"))
    said = []
    log.register_logger(said.append)
    try:
        lt.train(_case_params(case), lt.Dataset(rank_rows(X, rank, world),
                                                label=rank_rows(y, rank,
                                                                world)), 1)
    finally:
        log.register_logger(None)
    return said


def merge_inputs(rank, S=4, B=8):
    """Crafted per-rank best-split records: slot 0 ties (the earlier rank
    wins), slot 1 rank 1 wins, slot 2 rank 0 wins, slot 3 has no valid
    split on either rank."""
    gains = {0: [1.0, 2.0, 3.0, -np.inf], 1: [1.0, 5.0, 2.0, -np.inf]}[rank]
    r = np.random.RandomState(10 + rank)
    return {
        "feature": np.array([0, 1, 2, -1], np.int32) if rank == 0
        else np.array([2, 0, 1, -1], np.int32),
        "threshold": r.randint(0, B, S).astype(np.int32),
        "default_left": r.rand(S) < 0.5,
        "gain": np.asarray(gains, np.float32),
        **{k: r.randn(S).astype(np.float32)
           for k in ("left_output", "right_output", "left_sum_grad",
                     "left_sum_hess", "left_count", "right_sum_grad",
                     "right_sum_hess", "right_count")},
        "cat_flag": r.rand(S) < 0.5,
        "cat_mask": r.rand(S, B) < 0.5}


def merge_rank(rank, world, f_offset_per_rank):
    """``merge_best_over_shards`` on this rank's crafted record."""
    import torch.distributed as dist
    from lightgbm_tpu_torch.models.learner import merge_best_over_shards
    from lightgbm_tpu_torch.ops.split import BestSplit
    bs = BestSplit(**{k: torch.as_tensor(v)
                      for k, v in merge_inputs(rank).items()})
    out = merge_best_over_shards(bs, dist.group.WORLD,
                                 f_offset_per_rank * rank)
    return {k: getattr(out, k).numpy() for k in out._fields}


def fused_data(R=4096, F=6, B=32, seed=0):
    """tests/test_torch_frontier2.py's draw at 4,096 rows: (bins [R, F]
    int8, grad, hess)."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B - 1, size=(R, F)).astype(np.int8)
    y = ((bins[:, 0] > 12).astype(np.float32)
         + 0.5 * (bins[:, 1] > 20) + 0.3 * (bins[:, 2] % 4 == 1)
         + 0.1 * rng.randn(R))
    grad = (y - y.mean()).astype(np.float32) * -1.0
    hess = np.ones(R, np.float32)
    return bins, grad, hess


def fused_inputs(bins, grad, hess, B=32):
    """(F_oh, bins_T [max(F_oh, 8), R] int8, g, h, w, meta dict) of the
    fused grower on these rows (R a multiple of 2048)."""
    from lightgbm_tpu_torch.ops.layout import feature_layout
    R, F = bins.shape
    F_oh, _ = feature_layout(F, B)
    bins_T = np.zeros((max(F_oh, 8), R), np.int8)
    bins_T[:F] = bins.T
    nb = np.zeros(F_oh, np.int32)
    nb[:F] = B
    z = np.zeros(F_oh, np.int32)
    meta = {"num_bin": nb, "missing_type": z, "default_bin": z,
            "monotone": z}
    return F_oh, bins_T, (grad, hess, np.ones(R, np.float32)), meta


def fused_rank(rank, world, cases, L=15, B=32):
    """``grow_tree_fused`` on this rank under each case's mode: data and
    voting on the rank's block of rows, feature on every row with the
    rank's contiguous slice of the F_oh columns."""
    import torch.distributed as dist
    from lightgbm_tpu_torch import convert
    from lightgbm_tpu_torch.models.frontier2 import grow_tree_fused
    from lightgbm_tpu_torch.ops.collectives import CollectiveTrace
    from lightgbm_tpu_torch.ops.fused_level import pack_gh
    from lightgbm_tpu_torch.ops.split import SplitParams
    out = {}
    for c in cases:
        bins, grad, hess = fused_data()
        if c["mode"] != "feature":
            bins, grad, hess = (rank_rows(a, rank, world)
                                for a in (bins, grad, hess))
        F_oh, bins_T, (g, h, w), meta = fused_inputs(bins, grad, hess, B)
        fmask = np.arange(F_oh) < 6
        shard = None
        if c["mode"] == "feature":
            per = F_oh // world
            shard = torch.as_tensor(np.arange(F_oh) // per == rank)
        with CollectiveTrace() as rec:
            tree, rl = grow_tree_fused(
                torch.as_tensor(bins_T),
                pack_gh(*(torch.as_tensor(a) for a in (g, h, w)), 5),
                convert.feature_meta_from_numpy(meta), torch.as_tensor(fmask),
                SplitParams(min_data_in_leaf=5), L, B, F_oh,
                num_rows=bins_T.shape[1], nch=5, extra_levels=1,
                group=dist.group.WORLD, parallel_mode=c["mode"],
                top_k=c.get("top_k", 20), feature_shard_mask=shard)
        d = tree_np(tree, rl)
        d["trace"] = (rec.count, rec.bytes, dict(rec.by_dtype))
        out[c["name"]] = d
    return out


def cuda_collective_rank(rank, world):
    """record_psum / record_pmax on CUDA tensors of this rank's card."""
    import torch.distributed as dist
    from lightgbm_tpu_torch.ops.collectives import (CollectiveTrace,
                                                    record_pmax, record_psum)
    g = dist.group.WORLD
    x = torch.arange(6, dtype=torch.float32, device="cuda") * (rank + 1)
    b = torch.tensor([rank == 0, False, True], device="cuda")
    with CollectiveTrace() as rec:
        s, m, bs = record_psum(x, g), record_pmax(x, g), record_psum(b, g)
    return {"sum": s.cpu().numpy(), "max": m.cpu().numpy(),
            "bool": bs.cpu().numpy(), "cuda": s.is_cuda and m.is_cuda,
            "count": rec.count}


def cuda_train_rank(rank, world, params, rounds):
    """train() on this rank's rows of train_data() on the card."""
    import lightgbm_tpu_torch as lt
    X, y = train_data()
    ds = lt.Dataset(rank_rows(X, rank, world), label=rank_rows(y, rank,
                                                               world))
    bst = lt.train(dict(params, device_type="cuda"), ds, rounds)
    return {"text": bst.model_to_string(), "models": bst.models}


def dead_rank(rank, world, mode):
    """A rank that dies: ``exit`` — rank 1 exits before the all-reduce
    rank 0 waits in; ``late`` — rank 1 never joins it and exits cleanly
    later, so rank 0's group timeout has to end the wait."""
    import os
    import time
    import torch.distributed as dist
    from lightgbm_tpu_torch.ops.collectives import record_psum
    if rank == 1:
        if mode == "exit":
            os._exit(3)
        time.sleep(20)
        return "late"
    return record_psum(torch.ones(4), dist.group.WORLD).numpy()


class Background:
    """``run_ranks`` in a thread, so the pytest process can compute the
    JAX side while the ranks run; ``result()`` joins and re-raises."""

    def __init__(self, *args, **kwargs):
        import threading
        from lightgbm_tpu_torch.parallel.spawn import run_ranks
        self._out = {}

        def go():
            try:
                self._out["value"] = run_ranks(*args, **kwargs)
            except BaseException as e:         # re-raised by result()
                self._out["error"] = e
        self._thread = threading.Thread(target=go, daemon=True)
        self._thread.start()

    def result(self):
        self._thread.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]
