"""The port's Threefry-2x32 (``lightgbm_tpu_torch/utils/random.py``) and
per-node feature masks (``models/learner.py``) against ``jax.random`` and
the JAX package's ``node_feature_mask``.

feature_fraction_bynode samples each node's features from
``jax.random.uniform(fold_in(fold_in(PRNGKey(seed), iteration), node),
(F,))``; the port must draw the same bits, or the trees differ. Bits are
compared exactly over 1,200 node keys (5 seeds x 4 iterations x 60 node
ids) at widths 1 to 40, under the default partitionable layout. No
training.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightgbm_tpu.models import learner as jl
from lightgbm_tpu_torch.models import learner as tl
from lightgbm_tpu_torch.utils import random as tr

SEEDS = [0, 1, 2, 12347, 2 ** 31 - 1, 2 ** 31 + 3, 2 ** 32 + 5, -1]


def test_partitionable_layout_is_the_default():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(
        tr.prng_key(seed).numpy(),
        np.asarray(jax.random.PRNGKey(seed)).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS[:4] + [2 ** 32 + 5])
def test_fold_in_and_uniform_bits_match_jax(seed):
    rng = np.random.RandomState(seed & 0xFFFF)
    kj, kt = jax.random.PRNGKey(seed), tr.prng_key(seed)
    for it in (0, 1, 9, 2 ** 31 + 1):
        kj2 = jax.random.fold_in(kj, it)
        kt2 = tr.fold_in(kt, it)
        np.testing.assert_array_equal(
            kt2.numpy(), np.asarray(kj2).astype(np.int64))
        ids = np.concatenate([np.arange(8), rng.randint(0, 2 ** 20, 52)])
        kjs = jax.vmap(lambda i: jax.random.fold_in(kj2, i))(
            jnp.asarray(ids, jnp.int32))
        kts = tr.fold_in(kt2, torch.as_tensor(ids))
        np.testing.assert_array_equal(
            kts.numpy(), np.asarray(kjs).astype(np.int64))
        for F in (1, 7, 8, 28, 40):
            uj = jax.vmap(lambda k: jax.random.uniform(k, (F,)))(kjs)
            ut = tr.uniform(kts, F)
            assert ut.dtype == torch.float32
            np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
            bj = jax.vmap(lambda k: jax.random.bits(k, (F,)))(kjs)
            np.testing.assert_array_equal(
                tr.random_bits(kts, F).numpy(),
                np.asarray(bj).astype(np.int64))


def test_threefry_hash_matches_jax_on_random_words():
    from jax._src import prng
    rng = np.random.RandomState(7)
    w = rng.randint(0, 2 ** 32, size=(4, 1000), dtype=np.uint64)
    k0, k1, x0, x1 = (jnp.asarray(a.astype(np.uint32)) for a in w)
    yj = prng.threefry2x32_p.bind(k0, k1, x0, x1)
    yt = tr.threefry2x32(*(torch.as_tensor(a.astype(np.int64)) for a in w))
    for a, b in zip(yt, yj):
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(b).astype(np.int64))


@pytest.mark.parametrize("groups,frac", [
    ([], 0.5), ([[0, 1, 2], [3, 4, 5, 6]], 1.0),
    ([[0, 1, 2], [2, 3, 4, 5, 6, 7]], 0.4), ([[0, 9]], 0.3)],
    ids=["bynode", "constraints", "both", "one-group"])
def test_node_feature_mask_matches_jax(groups, frac):
    F, L = 10, 24
    rng = np.random.RandomState(len(groups))
    cj = jl.make_node_mask_cfg(F, groups, frac, 2 + 12345)
    ct = tl.make_node_mask_cfg(F, groups, frac, 2 + 12345)
    assert ct.bynode_k == int(cj.bynode_k)
    np.testing.assert_array_equal(ct.group_feat.numpy(),
                                  np.asarray(cj.group_feat))
    np.testing.assert_array_equal(ct.groups_with_f.numpy(),
                                  np.asarray(cj.groups_with_f))
    for it in (0, 3):
        cj_it = cj._replace(key=jax.random.fold_in(cj.key, it))
        ct_it = ct._replace(key=tr.fold_in(ct.key, it))
        G = ct.group_feat.shape[0]
        lg = rng.randint(-1, 2 ** G, L).astype(np.int32)
        ids = rng.randint(0, 60, L).astype(np.int32)
        mj = jl.node_feature_mask(cj_it, jnp.asarray(lg), jnp.asarray(ids))
        mt = tl.node_feature_mask(ct_it, torch.as_tensor(lg),
                                  torch.as_tensor(ids))
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        # the children's group bitmasks after a level of splits
        sf = rng.randint(-1, F, L).astype(np.int32)
        sel = rng.rand(L) < 0.5
        new = np.where(sel, np.cumsum(sel) + L // 2 - 1, -1).astype(np.int32)
        new = np.clip(new, -1, L - 1)
        gj = jl.update_leaf_groups(cj_it, jnp.asarray(lg), jnp.asarray(sf),
                                   jnp.asarray(sel),
                                   jnp.arange(L, dtype=jnp.int32),
                                   jnp.asarray(new))
        gt = tl.update_leaf_groups(ct_it, torch.as_tensor(lg),
                                   torch.as_tensor(sf), torch.as_tensor(sel),
                                   torch.arange(L, dtype=torch.int32),
                                   torch.as_tensor(new))
        np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
