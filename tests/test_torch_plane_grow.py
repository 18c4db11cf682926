"""The fused engine's grower under each histogram-plane cut against the
JAX package's (split from ``tests/test_torch_plane_train.py`` so that
``--dist loadfile`` runs the two side by side).

``tpu_quantized_grad`` 16, the packed layout of ``tpu_adaptive_bins`` and
the one-hot mask of ``tpu_gain_screening`` through the port's
``grow_tree_fused`` (the kernels' plain versions) against
``lightgbm_tpu.models.frontier2``'s in interpret mode: structure and row ->
leaf map equal, leaf values within rtol 1e-5 (quantized: equal int32 sums,
decoded through scales an ulp apart at most). The JAX package's packed
programs fail to compile on XLA's CPU backend, so the packed JAX run is
taken under ``jax.disable_jit()``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.models import frontier2 as jf2
from lightgbm_tpu.models.learner import FeatureMeta as JMeta
from lightgbm_tpu.ops import fused_level as jfl
from lightgbm_tpu.ops import layout as jlayout
from lightgbm_tpu.ops.split import SplitParams as JParams
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.models import frontier2 as tf2
from lightgbm_tpu_torch.ops import fused_level as tfl
from lightgbm_tpu_torch.ops import layout as tlayout
from lightgbm_tpu_torch.ops.split import SplitParams as TParams

# small shapes: intra-op threads would only contend with the other test
# workers' processes
torch.set_num_threads(1)


# ------------------------------------------------------------- the grower
STRUCT = ("split_feature", "threshold_bin", "default_left", "left_child",
          "right_child", "leaf_count")


@pytest.mark.parametrize("cut", ["quant16", "packed", "screening"])
def test_grow_tree_fused_cut_matches_jax(cut):
    rng = np.random.RandomState(12)
    F, R = 8, 2048
    num_bin = np.array([9, 9, 9, 9, 63, 63, 63, 63], np.int32)
    bins = np.stack([rng.randint(0, nb, R) for nb in num_bin])
    y = (bins[4] > 30) + 0.5 * (bins[1] > 4) + 0.1 * rng.randn(R)
    g = (y.mean() - y).astype(np.float32)
    h = np.ones(R, np.float32)
    w = np.ones(R, np.float32)
    F_oh, Bp = jlayout.feature_layout(F, 63)
    packed = cut == "packed"
    pk_j = jlayout.packed_feature_layout(num_bin, 63, f_oh=F_oh) \
        if packed else None
    pk_t = tlayout.packed_feature_layout(num_bin, 63, f_oh=F_oh) \
        if packed else None
    order = np.asarray(pk_t.feat_order) if packed else np.arange(F)
    bins_T = np.zeros((max(F_oh, 8), R), np.int8)
    bins_T[:F] = bins[order]
    quant = 16 if cut == "quant16" else 0
    fmask = np.ones(F_oh, bool)
    if cut == "screening":
        fmask[[0, 3, 6]] = False    # screened out (0: its slab stays live)
    meta = {"num_bin": num_bin, "missing_type": np.zeros(F, np.int32),
            "default_bin": np.zeros(F, np.int32),
            "monotone": np.zeros(F, np.int32)}
    kw = dict(num_rows=R, nch=5, max_depth=-1, extra_levels=1,
              quant_bits=quant, mask_onehot=cut == "screening")
    if quant:
        gh_j, sc_j = jfl.pack_gh_quant(jnp.asarray(g), jnp.asarray(h),
                                       jnp.asarray(w), 16, np.uint32(3))
    else:
        gh_j, sc_j = jfl.pack_gh(jnp.asarray(g), jnp.asarray(h),
                                 jnp.asarray(w), 5), None
    with jax.disable_jit(packed):
        jtree, jleaf = jf2.grow_tree_fused(
            jnp.asarray(bins_T), gh_j,
            JMeta(**{k: jnp.asarray(v) for k, v in meta.items()}),
            jnp.asarray(fmask), JParams(min_data_in_leaf=5), 7, Bp, F_oh,
            interpret=True, packed=pk_j, gh_scales=sc_j, **kw)
        jtree = jax.device_get(jtree)
    t = torch.as_tensor
    if quant:
        gh_t, sc_t = tfl.pack_gh_quant(t(g), t(h), t(w), 16, seed=3)
    else:
        gh_t, sc_t = tfl.pack_gh(t(g), t(h), t(w), 5), None
    ttree, tleaf = tf2.grow_tree_fused(
        t(bins_T), gh_t, convert.feature_meta_from_numpy(meta), t(fmask),
        TParams(min_data_in_leaf=5), 7, Bp, F_oh, packed=pk_t,
        gh_scales=sc_t, **kw)
    nl = int(jtree.num_leaves)
    assert ttree.num_leaves == nl == 7
    for k in STRUCT:
        np.testing.assert_array_equal(getattr(ttree, k).numpy(),
                                      np.asarray(getattr(jtree, k)), k)
    np.testing.assert_allclose(ttree.leaf_value.numpy(),
                               np.asarray(jtree.leaf_value), rtol=1e-5)
    np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))
    if cut == "screening":
        used = set(ttree.split_feature[:nl - 1].tolist())
        assert not used & {0, 3, 6}
