"""Data files under two ranks: slices, the rank-sharded cache, Queue C 7
and 10.

One module fixture spawns two CPU ranks of the port once
(``parallel.spawn``, gloo over a ``file://`` store) and runs
:func:`ingest_rank` there, on files the parent wrote:

- a 301-row CSV: each rank's ``Dataset(path)`` holds its contiguous slice
  (151 and 150 rows) with its labels and weights, both ranks bin from the
  gathered sample into the same mappers, and ``tree_learner=data`` trains
  the model the ranks train from the same slices held in memory, byte for
  byte (as ``pre_partition`` it is the whole file), and the two-round
  streamed build of the same file (its pass-1 sample gathered from both
  ranks) bins and trains the same;
- the same CSV with a ``.query`` sidecar: each slice starts on a query
  boundary and holds whole queries;
- ``save_binary=true`` writes ``<path>.bin.rank<r>of2`` and a second
  construct takes it on both ranks without parsing; ``Dataset(<path>.bin)``
  takes each rank's shard; with one rank's shard gone every rank raises;
- Queue C 7: a one-process cache is refused on both ranks, in the JAX
  package's words;
- Queue C 10: a non-default ``collective_timeout`` or
  ``collective_retries`` (refused until item 10c was ported) sets the
  host-collective policy on both ranks.
"""
import os

import numpy as np
import pytest

from lightgbm_tpu_torch.parallel.spawn import run_ranks

N = 301
PARAMS = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
          "verbose": -1, "device_type": "cpu", "tree_learner": "data",
          "bin_construct_sample_cnt": 1000}


def _rows():
    rng = np.random.RandomState(7)
    X = rng.rand(N, 4).astype(np.float32)
    y = (X[:, 0] + 0.2 * rng.randn(N) > 0.5).astype(np.float32)
    return X, y


def _write_files(wd):
    import lightgbm_tpu_torch as lt
    X, y = _rows()
    paths = {}
    for name in ("plain", "ranked", "cached", "query"):
        p = os.path.join(wd, f"{name}.csv")
        with open(p, "w") as fh:
            for yi, row in zip(y, X):
                fh.write(",".join([f"{yi:g}"] + [f"{v:.9g}" for v in row])
                         + "\n")
        paths[name] = p
    np.savetxt(paths["plain"] + ".weight", np.linspace(0.5, 1.5, N),
               fmt="%.9g")
    sizes = np.array([7, 20, 3, 50, 61, 9, 40, 30, 31, 50])
    assert sizes.sum() == N
    np.savetxt(paths["query"] + ".query", sizes, fmt="%d")
    one = os.path.join(wd, "one.bin")
    lt.Dataset(X, label=y, params={"device_type": "cpu",
                                   "verbose": -1}).save_binary(one)
    paths["one"] = one
    return paths, sizes


def ingest_rank(rank, world, paths):
    """The checks of the module docstring on one rank; returns what the
    parent asserts."""
    import torch.distributed as dist
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.binning import mappers_digest
    from lightgbm_tpu_torch.io.cache import CacheError
    from lightgbm_tpu_torch.native import loader as native
    from lightgbm_tpu_torch.utils.log import LightGBMError
    out = {}
    # contiguous slices, the gathered sample, file against memory
    ds = lt.Dataset(paths["plain"], params=dict(PARAMS)).construct()
    out["rows"] = ds.num_data()
    out["label"] = ds.get_label()
    out["weight"] = ds.get_weight()
    out["mappers"] = mappers_digest(ds._inner.mappers)
    text = lt.train(dict(PARAMS), ds, 2).model_to_string()
    X, y = _rows()
    per = (N + world - 1) // world
    sl = slice(rank * per, min(N, (rank + 1) * per))
    mem = lt.Dataset(X[sl], label=y[sl],
                     weight=np.loadtxt(paths["plain"] + ".weight")[sl],
                     params=dict(PARAMS))
    out["text_equal_memory"] = text == lt.train(dict(PARAMS), mem,
                                                2).model_to_string()
    out["text"] = text
    st = lt.Dataset(paths["plain"], params=dict(
        PARAMS, two_round=True, ingest_chunk_rows=40)).construct()
    out["streamed_same"] = (
        mappers_digest(st._inner.mappers) == out["mappers"]
        and np.array_equal(np.asarray(st._inner.bins),
                           np.asarray(ds._inner.bins))
        and lt.train(dict(PARAMS), st, 2).model_to_string() == text)
    whole = lt.Dataset(paths["plain"], params=dict(
        PARAMS, pre_partition=True)).construct()
    out["pre_partition_rows"] = whole.num_data()
    # query-aligned slices
    q = lt.Dataset(paths["query"], params=dict(PARAMS)).construct()
    out["query_rows"] = q.num_data()
    out["query_sizes"] = q.get_group()
    # the rank-sharded sidecar cache and the cohort's vote
    sp = dict(PARAMS, save_binary=True)
    first = lt.Dataset(paths["ranked"], params=dict(sp)).construct()
    shard = f"{paths['ranked']}.bin.rank{rank}of{world}"
    out["shard_written"] = os.path.exists(shard)
    n0 = native.backend["native"] + native.backend["numpy"]
    again = lt.Dataset(paths["ranked"], params=dict(sp)).construct()
    out["hit_parsed"] = native.backend["native"] + native.backend["numpy"] \
        - n0
    out["hit"] = (again._inner.ingest_stats or {}).get("cache_hit")
    out["hit_bins_equal"] = bool(np.array_equal(np.asarray(again._inner.bins),
                                                np.asarray(first._inner.bins)))
    explicit = lt.Dataset(paths["ranked"] + ".bin",
                          params=dict(PARAMS)).construct()
    out["explicit_rows"] = explicit.num_data()
    dist.barrier()
    if rank == 1:
        os.rename(shard, shard + ".gone")
    dist.barrier()
    try:
        lt.Dataset(paths["ranked"] + ".bin", params=dict(PARAMS)).construct()
        out["partial_shards"] = "loaded"
    except CacheError as e:
        out["partial_shards"] = str(e)
    # Queue C 7: a one-process cache under two ranks
    try:
        lt.Dataset(paths["one"], params=dict(PARAMS)).construct()
        out["world1_cache"] = "loaded"
    except CacheError as e:
        out["world1_cache"] = str(e)
    # Queue C 10: the policy is set on each rank
    from lightgbm_tpu_torch.resilience import comms
    out["c10"] = {}
    for key, value in (("collective_timeout", 30.0),
                       ("collective_retries", 5)):
        try:
            lt.train(dict(PARAMS, **{key: value}), lt.Dataset(
                paths["cached"], params=dict(PARAMS)), 1)
            out["c10"][key] = (comms._TIMEOUT_S, comms._RETRIES)
        except LightGBMError as e:
            out["c10"][key] = str(e)
        finally:
            comms.set_collective_policy(0.0, 2)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("dist_ingest"))
    paths, sizes = _write_files(wd)
    res = run_ranks(os.path.abspath(__file__) + ":ingest_rank", 2,
                    (paths,), workdir=wd + "/ranks", deadline_s=240)
    return res, sizes, np.loadtxt(paths["plain"] + ".weight")


def test_contiguous_slices_train_the_in_memory_model(ranks):
    res, _, weight = ranks
    X, y = _rows()
    assert [r["rows"] for r in res] == [151, 150]
    np.testing.assert_array_equal(np.concatenate([r["label"] for r in res]),
                                  y)
    np.testing.assert_array_equal(
        np.concatenate([r["weight"] for r in res]),
        weight.astype(np.float32))
    assert res[0]["mappers"] == res[1]["mappers"]
    assert res[0]["text"] == res[1]["text"]
    assert all(r["text_equal_memory"] for r in res)
    assert all(r["streamed_same"] for r in res)
    assert [r["pre_partition_rows"] for r in res] == [N, N]


def test_query_aligned_slices(ranks):
    res, sizes, _ = ranks
    ends = set(np.cumsum(sizes).tolist())
    assert sum(r["query_rows"] for r in res) == N
    assert res[0]["query_rows"] in ends
    got = np.concatenate([r["query_sizes"] for r in res])
    np.testing.assert_array_equal(got, sizes)


def test_rank_shards_round_trip_and_the_vote(ranks):
    res, _, _ = ranks
    for r in res:
        assert r["shard_written"] and r["hit"] == 1 and r["hit_parsed"] == 0
        assert r["hit_bins_equal"]
        assert "exist on some ranks only" in r["partial_shards"]
    assert [r["explicit_rows"] for r in res] == [151, 150]


def test_world1_cache_refused_under_two_ranks(ranks):
    """Queue C 7."""
    res, _, _ = ranks
    for r in res:
        assert "written for world=1 but this run has world=2" \
            in r["world1_cache"]


def test_collective_policy_keys_set_under_ranks(ranks):
    """Queue C 10, once refused: each key trains and sets the
    host-collective policy on both ranks."""
    res, _, _ = ranks
    for r in res:
        assert r["c10"] == {"collective_timeout": (30.0, 2),
                            "collective_retries": (0.0, 5)}
