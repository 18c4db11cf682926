"""The fused grower under a process group: two port ranks against the JAX
package's ``grow_tree_fused`` under ``shard_map`` on two devices, on the
CPU (the JAX kernels in interpret mode; a file of its own, so that
``--dist loadfile`` runs it beside the other distributed files).

One configuration (tests/test_torch_frontier2.py's draw at 4,096 rows, 6
features of 32 bins, 7 leaves) in each mode: data (each rank its block
of 2,048 rows, every level's packed accumulator summed), voting (2 of 6
columns voted, 4 of the 8 padded columns exchanged) and feature (the rows
replicated, each rank scanning its half of the columns). Both ranks grow
the same tree; against the JAX package's the structure, thresholds, leaf
counts and per-row leaves are equal and the leaf values within 1e-5.
Data- and feature-parallel also grow the port's serial tree, feature-
parallel to the last bit (every rank histograms every row).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from lightgbm_tpu.models import frontier2 as jf2
from lightgbm_tpu.models.learner import FeatureMeta as JMeta
from lightgbm_tpu.ops.fused_level import pack_gh as jpack_gh
from lightgbm_tpu.ops.split import SplitParams as JParams
from lightgbm_tpu.parallel import make_mesh
from lightgbm_tpu.parallel.mesh import shard_map
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.models import frontier2 as tf2
from lightgbm_tpu_torch.ops import fused_level as tfl
from lightgbm_tpu_torch.ops.split import SplitParams

import torch_dist_ranks as tdr

L, B = 7, 32
CASES = [dict(name="data", mode="data"),
         dict(name="voting", mode="voting", top_k=2),
         dict(name="feature", mode="feature")]
STRUCT = ("split_feature", "threshold_bin", "default_left", "left_child",
          "right_child", "leaf_count")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks run in the background while the tests build the JAX
    side."""
    wd = str(tmp_path_factory.mktemp("dist_fused"))
    return tdr.Background(tdr.__file__ + ":fused_rank", 2, (CASES, L, B),
                          workdir=wd, deadline_s=240)


def _jax(case):
    bins, grad, hess = tdr.fused_data()
    F_oh, bins_T, (g, h, w), meta = tdr.fused_inputs(bins, grad, hess, B)
    fmask = jnp.asarray(np.arange(F_oh) < 6)
    jmeta = JMeta(**{k: jnp.asarray(v) for k, v in meta.items()})
    feat = case["mode"] == "feature"
    axis = "feature" if feat else "data"
    mesh = make_mesh(2, axis_name=axis)

    def per(bt, gt):
        shard = None
        if feat:
            sid = jax.lax.axis_index(axis)
            shard = jnp.arange(F_oh) // (F_oh // 2) == sid
        return jf2.grow_tree_fused(
            bt, gt, jmeta, fmask, JParams(min_data_in_leaf=5), L, B, F_oh,
            num_rows=0, nch=5, extra_levels=1, interpret=True,
            psum_axis=axis, parallel_mode=case["mode"],
            top_k=case.get("top_k", 20), feature_shard_mask=shard)
    spec = P() if feat else P(None, "data")
    fn = jax.jit(shard_map(per, mesh=mesh, in_specs=(spec, spec),
                           out_specs=(P(), P() if feat else P("data"))))
    gh_T = jpack_gh(jnp.asarray(g), jnp.asarray(h), jnp.asarray(w), 5)
    tree, rl = fn(jnp.asarray(bins_T), gh_T)
    return jax.device_get(tree), np.asarray(rl)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_fused_ranks_grow_the_jax_tree(ranks, case):
    jt, jrl = _jax(case)
    res = ranks.result()
    a, b = res[0][case["name"]], res[1][case["name"]]
    for k in a:
        if k not in ("row_leaf", "trace"):
            np.testing.assert_array_equal(a[k], b[k], k)
    rl = (a["row_leaf"] if case["mode"] == "feature"
          else np.concatenate([a["row_leaf"], b["row_leaf"]]))
    assert a["num_leaves"] == int(jt.num_leaves) > 4
    for k in STRUCT:
        np.testing.assert_array_equal(a[k], np.asarray(getattr(jt, k)), k)
    np.testing.assert_allclose(a["leaf_value"], np.asarray(jt.leaf_value),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(rl, jrl)
    if case["mode"] == "voting":
        return
    bins, grad, hess = tdr.fused_data()
    F_oh, bins_T, (g, h, w), meta = tdr.fused_inputs(bins, grad, hess, B)
    st, srl = tf2.grow_tree_fused(
        torch.as_tensor(bins_T),
        tfl.pack_gh(*(torch.as_tensor(x) for x in (g, h, w)), 5),
        convert.feature_meta_from_numpy(meta),
        torch.as_tensor(np.arange(F_oh) < 6), SplitParams(min_data_in_leaf=5),
        L, B, F_oh, num_rows=bins_T.shape[1], nch=5, extra_levels=1)
    for k in STRUCT:
        np.testing.assert_array_equal(a[k], getattr(st, k).numpy(), k)
    np.testing.assert_array_equal(rl, srl.numpy())
    if case["mode"] == "feature":
        np.testing.assert_array_equal(a["leaf_value"], st.leaf_value.numpy())
        assert a["trace"][2].get("float32", (0, 0))[1] < 4096


def test_fused_voting_exchanges_less_than_data(ranks):
    res = ranks.result()
    assert res[0]["voting"]["trace"][1] < res[0]["data"]["trace"][1]
