"""The XLA engine's distributed growers: two port ranks against the JAX
package's growers on a two-device mesh, on the CPU.

One module fixture spawns two ranks of the port (``parallel.spawn``, gloo
over a ``file://`` store under the test's temporary directory, no JAX in
the ranks) and runs every grower configuration there: leaf-wise and
depth-wise data-parallel (``make_sharded_grow_fn``), leaf-wise and
depth-wise voting with a restricted ``top_k`` (2 of 6 columns vote, 4 are
exchanged), and depth-wise feature-parallel with the rows replicated
(``make_feature_parallel_grow_fn``), with and without a categorical
column. The JAX side runs in the pytest process on ``make_mesh(2)``
(``shard_map`` over the same contiguous row blocks). Both ranks return the
same tree; against the JAX package's tree the structure, thresholds and
leaf counts are equal and the per-row leaves too, the leaf values within
1e-5. Data- and feature-parallel trees also equal the port's serial
grower's (feature-parallel to the last bit: every rank takes its leaf
totals from global column 0). ``merge_best_over_shards`` is checked on
crafted per-rank records with a tie against the JAX merge and by hand.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from lightgbm_tpu.models import learner as jl
from lightgbm_tpu.ops.split import BestSplit as JBestSplit
from lightgbm_tpu.ops.split import SplitParams as JSplitParams
from lightgbm_tpu.parallel import (make_feature_parallel_grow_fn,
                                   make_mesh, make_sharded_grow_fn)
from lightgbm_tpu.parallel.mesh import shard_map
from lightgbm_tpu_torch.models import learner as tl
from lightgbm_tpu_torch.ops.split import SplitParams

import torch_dist_ranks as tdr

L, B, F = 15, 16, 6
CASES = [
    dict(name="lw_data", mode="data", policy="leafwise", L=L),
    dict(name="dw_data", mode="data", policy="depthwise", L=L),
    dict(name="lw_vote", mode="voting", policy="leafwise", L=L, top_k=2),
    dict(name="dw_vote", mode="voting", policy="depthwise", L=L, top_k=2),
    dict(name="lw_vote_cat", mode="voting", policy="leafwise", L=L,
         top_k=2, cat=True),
    dict(name="dw_feat", mode="feature", policy="depthwise", L=L),
    dict(name="dw_feat_cat", mode="feature", policy="depthwise", L=L,
         cat=True),
]
TREE_KEYS = ("split_feature", "threshold_bin", "left_child", "right_child")


@pytest.fixture(scope="module")
def ranks_bg(tmp_path_factory):
    """The ranks run in the background while the tests build the JAX
    side."""
    wd = str(tmp_path_factory.mktemp("dist_growers"))
    return (tdr.Background(tdr.__file__ + ":grower_rank", 2, (CASES,),
                           workdir=wd + "/g", deadline_s=240),
            tdr.Background(tdr.__file__ + ":merge_rank", 2, (3,),
                           workdir=wd + "/m", deadline_s=120))


def _jax_tree(c):
    bins, gh = tdr.grower_data(cat=c.get("cat", False))
    isc = np.zeros(F, bool)
    if c.get("cat"):
        isc[3] = True
    meta = jl.FeatureMeta(jnp.full(F, B, jnp.int32), jnp.zeros(F, jnp.int32),
                          jnp.zeros(F, jnp.int32), jnp.zeros(F, jnp.int32),
                          jnp.asarray(isc))
    params = JSplitParams(min_data_in_leaf=10, lambda_l2=1.0)
    has_cat = bool(c.get("cat"))
    if c["mode"] == "feature":
        fn = make_feature_parallel_grow_fn(make_mesh(2, axis_name="feature"),
                                           params, L, B, has_cat=has_cat)
    elif c["mode"] == "data":
        fn = make_sharded_grow_fn(make_mesh(2), params, L, B,
                                  policy=c["policy"], has_cat=has_cat)
    else:
        grow = (jl.grow_tree_leafwise if c["policy"] == "leafwise"
                else jl.grow_tree_depthwise)

        def per(b, g, m, f):
            return grow(b, g, m, f, params, L, B, -1, hist_impl="auto",
                        psum_axis="data", parallel_mode="voting",
                        top_k=c["top_k"], has_cat=has_cat)
        fn = jax.jit(shard_map(per, mesh=make_mesh(2),
                               in_specs=(P("data", None), P("data", None),
                                         P(), P()),
                               out_specs=(P(), P("data"))))
    tree, rl = fn(jnp.asarray(bins), jnp.asarray(gh), meta,
                  jnp.ones(F, bool))
    return tree, np.asarray(rl)


def _port_row_leaf(res, c):
    if c["mode"] == "feature":
        return res[0][c["name"]]["row_leaf"]
    return np.concatenate([r[c["name"]]["row_leaf"] for r in res])


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_ranks_grow_the_jax_tree(ranks_bg, case):
    tj, rlj = _jax_tree(case)
    res = ranks_bg[0].result()
    a, b = res[0][case["name"]], res[1][case["name"]]
    for k in a:
        if k not in ("row_leaf", "trace"):
            np.testing.assert_array_equal(a[k], b[k], k)
    nl = int(tj.num_leaves)
    assert a["num_leaves"] == nl
    for k in TREE_KEYS:
        np.testing.assert_array_equal(a[k][:nl - 1],
                                      np.asarray(getattr(tj, k))[:nl - 1], k)
    np.testing.assert_array_equal(a["leaf_count"][:nl],
                                  np.asarray(tj.leaf_count)[:nl])
    np.testing.assert_allclose(a["leaf_value"][:nl],
                               np.asarray(tj.leaf_value)[:nl], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(_port_row_leaf(res, case), rlj)


@pytest.mark.parametrize("case", [c for c in CASES if c["mode"] != "voting"],
                         ids=[c["name"] for c in CASES
                              if c["mode"] != "voting"])
def test_data_and_feature_trees_are_the_serial_tree(ranks_bg, case):
    res = ranks_bg[0].result()
    a = res[0][case["name"]]
    bins, gh = tdr.grower_data(cat=case.get("cat", False))
    cat_cols = (3,) if case.get("cat") else ()
    grow = (tl.grow_tree_leafwise if case["policy"] == "leafwise"
            else tl.grow_tree_depthwise)
    tree, rl = grow(torch.as_tensor(bins), torch.as_tensor(gh),
                    tdr._meta(F, B, cat_cols), torch.ones(F, dtype=torch.bool),
                    SplitParams(min_data_in_leaf=10, lambda_l2=1.0), L, B,
                    cat_idx=torch.tensor(cat_cols) if cat_cols else None)
    s = tdr.tree_np(tree, rl)
    for k in TREE_KEYS + ("leaf_count",):
        np.testing.assert_array_equal(a[k], s[k], k)
    np.testing.assert_array_equal(_port_row_leaf(res, case), s["row_leaf"])
    if case["mode"] == "feature":
        np.testing.assert_array_equal(a["leaf_value"], s["leaf_value"])
    else:
        np.testing.assert_allclose(a["leaf_value"], s["leaf_value"],
                                   rtol=1e-5, atol=1e-5)


def test_voting_exchanges_less_than_data(ranks_bg):
    """The vote caps the histogram payload: 4 of 8 padded columns, plus the
    int32 votes; feature-parallel moves no histogram at all."""
    res = ranks_bg[0].result()
    data = res[0]["dw_data"]["trace"]
    vote = res[0]["dw_vote"]["trace"]
    feat = res[0]["dw_feat"]["trace"]
    assert vote[1] < 0.75 * data[1]
    assert "int32" in vote[2]
    assert feat[1] < 0.2 * data[1]


def test_merge_best_over_shards_matches_jax(ranks_bg):
    mres = ranks_bg[1].result()
    np.testing.assert_equal(mres[0], mres[1])
    got = mres[0]
    # by hand: slot 0 ties (rank 0 wins), slot 1 rank 1, slot 2 rank 0,
    # slot 3 no split (-inf ties: rank 0's record, feature -1)
    r0, r1 = tdr.merge_inputs(0), tdr.merge_inputs(1)
    win = [0, 1, 0, 0]
    np.testing.assert_array_equal(
        got["feature"], [-1 if (r0, r1)[w]["feature"][s] < 0
                         else (r0, r1)[w]["feature"][s] + 3 * w
                         for s, w in enumerate(win)])
    for k in ("threshold", "left_output", "cat_mask", "default_left"):
        np.testing.assert_array_equal(
            got[k], np.stack([(r0, r1)[w][k][s] for s, w in enumerate(win)]))
    # the JAX merge under shard_map on the stacked per-rank records
    mesh = make_mesh(2, axis_name="feature")
    stacked = JBestSplit(**{k: jnp.asarray(np.stack([r0[k], r1[k]]))
                            for k in JBestSplit._fields})

    def per(bs):
        bs = JBestSplit(*[a[0] for a in bs])
        off = jax.lax.axis_index("feature") * 3
        out = jl.merge_best_over_shards(bs, "feature", off)
        return JBestSplit(*[a[None] for a in out])
    fn = jax.jit(shard_map(per, mesh=mesh, in_specs=(P("feature"),),
                           out_specs=P("feature")))
    jout = fn(stacked)
    for k in JBestSplit._fields:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jout, k))[0],
                                      k)
