"""lightgbm_tpu_torch grow_tree_fused vs the JAX package's fused grower.

Same binned matrix and gradients (tests/test_frontier2.py's fixture) through
``lightgbm_tpu.models.frontier2.grow_tree_fused(interpret=True)`` and the
port's ``grow_tree_fused`` on CPU tensors. The tree structure, the leaf
counts and the row -> leaf map must be equal; leaf values agree to
rtol=1e-5 (the histograms sum the same f32 values in another order).
Splits on pure-noise features deep in a tree have near-equal gains whose
order that rounding can flip, so the fixture's trees stay shallow enough
to split on signal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.models import frontier2 as jf2
from lightgbm_tpu.models.learner import FeatureMeta as JMeta
from lightgbm_tpu.ops.fused_level import feature_layout, pack_gh
from lightgbm_tpu.ops.split import SplitParams as JParams
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.models import frontier2 as tf2
from lightgbm_tpu_torch.ops import fused_level as tfl
from lightgbm_tpu_torch.ops.split import SplitParams as TParams

# small shapes: intra-op threads would only contend with the other test
# workers' processes
torch.set_num_threads(1)

STRUCT = ("split_feature", "threshold_bin", "default_left", "left_child",
          "right_child", "leaf_count")


def _data(R=2048, F=6, B=32, seed=0):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B - 1, size=(R, F)).astype(np.int8)
    y = ((bins[:, 0] > 12).astype(np.float32)
         + 0.5 * (bins[:, 1] > 20) + 0.1 * rng.randn(R))
    grad = (y - y.mean()).astype(np.float32) * -1.0
    hess = np.ones(R, np.float32)
    return bins, grad, hess


def _inputs(R, F, B, grad, hess, bins, mt):
    F_oh, Bp = feature_layout(F, B)
    Rp = ((R + 1023) // 1024) * 1024
    bins_T = np.zeros((max(F_oh, 8), Rp), np.int8)
    bins_T[:F, :R] = bins.T
    g = np.zeros(Rp, np.float32)
    h = np.zeros(Rp, np.float32)
    w = np.zeros(Rp, np.float32)
    g[:R], h[:R], w[:R] = grad, hess, 1.0
    # a NaN-missing feature's last bin holds its NaN rows (a mapper only
    # gets missing type NaN from data that has NaNs); the data's bins are
    # 0..B-2, so those features carry B-1 bins and the last one is filled
    nb = np.zeros(F_oh, np.int32)
    nb[:F] = np.where(mt == 2, B - 1, B)
    meta = {"num_bin": nb, "missing_type": np.pad(mt, (0, F_oh - F)),
            "default_bin": np.zeros(F_oh, np.int32),
            "monotone": np.zeros(F_oh, np.int32)}
    return F_oh, bins_T, (g, h, w), meta


@pytest.mark.parametrize("num_leaves,max_depth,missing", [
    (15, -1, False),
    (31, 3, False),
    (15, -1, True),      # NaN-missing (type 2) and zero-missing (type 1)
])
def test_grow_tree_fused_matches_jax(num_leaves, max_depth, missing):
    R, F, B = 2048, 6, 32
    bins, grad, hess = _data(R, F, B)
    mt = (np.array([2, 1, 0, 2, 0, 1], np.int32) if missing
          else np.zeros(F, np.int32))
    F_oh, bins_T, (g, h, w), meta = _inputs(R, F, B, grad, hess, bins, mt)
    fmask = np.arange(F_oh) < F

    jtree, jleaf = jf2.grow_tree_fused(
        jnp.asarray(bins_T), pack_gh(jnp.asarray(g), jnp.asarray(h),
                                     jnp.asarray(w), 5),
        JMeta(**{k: jnp.asarray(v) for k, v in meta.items()}),
        jnp.asarray(fmask), JParams(min_data_in_leaf=5), num_leaves, B,
        F_oh, num_rows=R, nch=5, max_depth=max_depth, extra_levels=2,
        interpret=True)
    jtree = jax.device_get(jtree)

    tfl.reset_launch_counts()
    ttree, tleaf = tf2.grow_tree_fused(
        torch.as_tensor(bins_T), tfl.pack_gh(torch.as_tensor(g),
                                             torch.as_tensor(h),
                                             torch.as_tensor(w), 5),
        convert.feature_meta_from_numpy(meta), torch.as_tensor(fmask),
        TParams(min_data_in_leaf=5), num_leaves, B, F_oh, num_rows=R,
        nch=5, max_depth=max_depth, extra_levels=2)
    assert sum(tfl.launches.values()) == 0       # CPU: plain versions

    nl = int(jtree.num_leaves)
    assert ttree.num_leaves == nl > 4
    for k in STRUCT:
        np.testing.assert_array_equal(getattr(ttree, k).numpy(),
                                      np.asarray(getattr(jtree, k)), k)
    np.testing.assert_allclose(ttree.leaf_value.numpy(),
                               np.asarray(jtree.leaf_value), rtol=1e-5)
    np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))


def test_level_caps_match_jax():
    for args in [(255, -1, 3, 64), (255, -1, 3, 128), (31, 4, 3, 128),
                 (2, -1, 0, 128), (15, -1, 3, 64)]:
        assert tf2.level_caps(*args) == jf2.level_caps(*args)
    from lightgbm_tpu.ops.fused_level import max_slot_cap
    for fb, nch in [(1792, 5), (1792, 3), (7168, 5), (128, 5)]:
        assert tfl.max_slot_cap(fb, nch) == max_slot_cap(fb, nch)


def test_tree_arrays_from_numpy_round_trip():
    R, F, B = 2048, 6, 32
    bins, grad, hess = _data(R, F, B, seed=1)
    F_oh, bins_T, (g, h, w), meta = _inputs(R, F, B, grad, hess, bins,
                                            np.zeros(F, np.int32))
    jtree, _ = jf2.grow_tree_fused(
        jnp.asarray(bins_T), pack_gh(jnp.asarray(g), jnp.asarray(h),
                                     jnp.asarray(w), 5),
        JMeta(**{k: jnp.asarray(v) for k, v in meta.items()}),
        jnp.asarray(np.arange(F_oh) < F), JParams(min_data_in_leaf=5), 7, B,
        F_oh, nch=5, extra_levels=1, interpret=True)
    d = {k: np.array(v) for k, v in jax.device_get(jtree)._asdict().items()}
    t = convert.tree_arrays_from_numpy(d)
    assert t.num_leaves == int(d["num_leaves"])
    for k in STRUCT + ("leaf_value", "split_gain", "internal_value",
                       "leaf_depth"):
        np.testing.assert_array_equal(getattr(t, k).numpy(), d[k], k)
    m = convert.feature_meta_from_numpy(meta)
    np.testing.assert_array_equal(m.num_bin.numpy(), meta["num_bin"])
    assert m.is_cat is None
