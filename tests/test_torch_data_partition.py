"""The leaf-wise grower's row lists (``lightgbm_tpu_torch/ops/
data_partition.py``, the reference's ``DataPartition``) against the JAX
package, on the CPU.

- ``leaf_partition`` (its plain version here) against numpy's stable
  partition of a leaf's segment, exactly: random segments and left tables,
  an empty segment, an all-left one, and no change when the step does not
  split.
- ``leaf_hist`` (plain) against the JAX package's ``build_histograms`` at
  one slot over ``where(row_leaf == target, 0, -1)``: the f32 planes
  within 1e-5 of the per-cell sum of |value|, the weight channel exact.
- The split's left table (``learner._left_table``) against the JAX
  grower's per-row routing (``_route_left`` with the bundle window and the
  category lookup), exactly, on every row.
- The list-based ``grow_tree_leafwise`` against the JAX grower on the same
  bins and gradients: equal split features, thresholds, children and
  leaf counts, leaf values within rtol 1e-5, equal ``row_leaf``; with
  zero-weight rows, a categorical column, bundle columns, a forced split
  whose child is empty, and a depth limit that stops the tree early.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lightgbm_tpu.models import learner as jl
from lightgbm_tpu.ops import histogram as jh
from lightgbm_tpu.ops import split as js
from lightgbm_tpu_torch.ops import data_partition as dp
from lightgbm_tpu_torch.ops import efb as tefb
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.models import learner as tl
from lightgbm_tpu_torch.ops import split as ts

torch.set_num_threads(1)

L_TEST = 15


def _state(row_leaf, L):
    """The list state of a per-row leaf vector: rows grouped by leaf in row
    order (a stable sort), each leaf's begin and length."""
    order = np.argsort(row_leaf, kind="stable").astype(np.int32)
    rows = np.bincount(row_leaf, minlength=L).astype(np.int32)
    begin = np.concatenate([[0], np.cumsum(rows)[:-1]]).astype(np.int32)
    t = torch.as_tensor
    return t(order), t(begin), t(rows)


def _one(v):
    return torch.tensor([v], dtype=torch.int64)


# ------------------------------------------------------- leaf_partition
@pytest.mark.parametrize("case", ["random", "random_wide", "empty",
                                  "all_left", "all_right", "no_split"])
def test_leaf_partition_is_a_stable_partition(case):
    rng = np.random.RandomState(len(case))
    R, Fp, Bk, L = 3000, 8, 64 if case == "random_wide" else 16, 8
    bins = rng.randint(0, Bk, (R, Fp)).astype(np.int32)
    row_leaf = rng.randint(0, 4, R).astype(np.int64)
    leaf, new = 2, 4
    if case == "empty":
        row_leaf[row_leaf == leaf] = 1
    order, begin, rows = _state(row_leaf, L)
    table = rng.rand(Bk) < 0.4
    if case == "all_left":
        table[:] = True
    if case == "all_right":
        table[:] = False
    col = 3
    before = (order.clone(), begin.clone(), rows.clone())
    ds = torch.tensor([case != "no_split"])
    dp.leaf_partition(order, torch.empty(R, dtype=torch.int32), begin, rows,
                      _one(leaf), _one(new), ds, torch.as_tensor(bins),
                      _one(col), torch.as_tensor(table))
    if case == "no_split":
        for a, b in zip((order, begin, rows), before):
            assert torch.equal(a, b)
        return
    b0, n0 = int(before[1][leaf]), int(before[2][leaf])
    seg = before[0][b0:b0 + n0].numpy()
    left = table[bins[seg, col]]
    want = np.concatenate([seg[left], seg[~left]])       # numpy, stable
    np.testing.assert_array_equal(order[b0:b0 + n0].numpy(), want)
    # the other leaves' segments are untouched
    outside = np.ones(R, bool)
    outside[b0:b0 + n0] = False
    np.testing.assert_array_equal(order.numpy()[outside],
                                  before[0].numpy()[outside])
    n_left = int(left.sum())
    assert (int(rows[leaf]), int(begin[new]), int(rows[new])) \
        == (n_left, b0 + n_left, n0 - n_left)
    assert int(begin[leaf]) == b0
    if case == "empty":
        assert n0 == 0 and int(rows[new]) == 0
    if case == "all_left":
        assert int(rows[new]) == 0 and n0 > 0


# ------------------------------------------------------------ leaf_hist
@pytest.mark.parametrize("case", ["small", "zero_weight", "root", "empty"])
def test_leaf_hist_matches_jax_build_histograms(case):
    rng = np.random.RandomState(11 + len(case))
    R, F, B, L = 4000, 6, 16, 8
    bins = rng.randint(0, B, (R, F)).astype(np.uint8)
    gh = np.stack([rng.randn(R), rng.rand(R) + 0.1, np.ones(R)],
                  1).astype(np.float32)
    if case == "zero_weight":
        gh[rng.rand(R) < 0.3] = 0.0
    row_leaf = rng.choice(L, R, p=[0.02, 0.5, 0.1, 0.1, 0.1, 0.1, 0.08,
                                   0.0]).astype(np.int64)
    target = {"root": 0, "empty": 7}.get(case, 0)
    if case == "root":
        row_leaf[:] = 0
    order, begin, rows = _state(row_leaf, L)
    kbins = th.hist_bins(torch.as_tensor(bins), B)
    got = dp.leaf_hist(kbins, torch.as_tensor(gh), order, begin, rows,
                       _one(target), torch.tensor([True]),
                       num_bins=B)[:, :F].numpy()
    slot = jnp.asarray(np.where(row_leaf == target, 0, -1).astype(np.int32))
    want = np.moveaxis(np.asarray(jh.build_histograms(
        jnp.asarray(bins), jnp.asarray(gh), slot, num_slots=1,
        num_bins=B))[0], -1, 0)                             # [3, F, B]
    abs_sum = np.moveaxis(np.asarray(jh.build_histograms(
        jnp.asarray(bins), jnp.asarray(np.abs(gh)), slot, num_slots=1,
        num_bins=B))[0], -1, 0)
    for c in range(2):
        assert np.abs(got[c] - want[c]).max() <= 1e-5 * max(
            abs_sum[c].max(), 1e-30)
    np.testing.assert_array_equal(got[2], want[2])
    if case == "empty":
        assert not got.any()
    # a step that does not split: zeros
    off = dp.leaf_hist(kbins, torch.as_tensor(gh), order, begin, rows,
                       _one(target), torch.tensor([False]), num_bins=B)
    assert not off.any()


# ------------------------------------------------------ the left table
def _bundle_fixture(rng, R):
    """Five logical features over three bundle columns: feature 0 alone
    (NaN missing), 1 and 2 exclusive (1 zero-missing), 3 and 4 exclusive
    (4 categorical); each member's default bin its most frequent."""
    nb = np.array([16, 8, 8, 6, 6], np.int32)
    mt = np.array([2, 1, 0, 0, 0], np.int32)
    db = np.array([0, 3, 0, 0, 0], np.int32)
    mfb = np.array([5, 3, 0, 0, 1], np.int32)
    layout = tefb.BundleLayout([[0], [1, 2], [3, 4]], nb)
    logical = np.stack([np.where(rng.rand(R) < 0.5, mfb[f],
                                 rng.randint(0, nb[f], R))
                        for f in range(5)], 1)
    pick = rng.rand(R) < 0.5        # which member of a pair may differ
    logical[pick, 2] = mfb[2]
    logical[~pick, 1] = mfb[1]
    logical[pick, 4] = mfb[4]
    logical[~pick, 3] = mfb[3]
    enc = tefb.encode_bundles(logical, mfb, layout)
    Bc = max(layout.col_num_bin)
    B = 16
    flat_idx = np.zeros((5, B), np.int32)
    valid = np.zeros((5, B), bool)
    for f in range(5):
        base = layout.col_of_feat[f] * Bc + layout.offset_of_feat[f]
        flat_idx[f, :nb[f]] = base + np.arange(nb[f])
        valid[f, :nb[f]] = True
    cfg = (flat_idx, valid, mfb, layout.col_of_feat, layout.offset_of_feat)
    return logical, enc, nb, mt, db, mfb, cfg, Bc


@pytest.mark.parametrize("layout", ["dense", "bundled"])
def test_left_table_routes_every_row_as_jax(layout):
    """table[kernel bin] equals the JAX grower's routing of each row
    (lightgbm_tpu/models/learner.py:719-736): numerical splits under each
    missing type and default direction, and categorical ones, on logical
    bins and on bundle columns (rows outside a member's window take its
    most-frequent bin)."""
    rng = np.random.RandomState(21)
    R = 2000
    logical, enc, nb, mt, db, mfb, cfg, Bc = _bundle_fixture(rng, R)
    B = 16
    if layout == "dense":
        kb, Bk, bundle_t = logical.astype(np.int32), B, None
    else:
        kb, Bk = enc.astype(np.int32), Bc
        bundle_t = tl.BundleCfg(*[torch.as_tensor(a) for a in cfg])
    meta = tl.FeatureMeta(*[torch.as_tensor(a) for a in
                            (nb, mt, db, np.zeros(5, np.int32))])
    kvals = torch.arange(Bk, dtype=torch.int32)
    for f in range(5):
        for thr in (0, 2, int(nb[f]) - 2):
            for dl in (False, True):
                for cat in (False, True):
                    cm = rng.rand(1, B) < 0.5
                    fs = _one(f)
                    table = tl._left_table(
                        kvals, fs, torch.tensor([thr], dtype=torch.int32),
                        torch.tensor([dl]), torch.tensor([cat]),
                        torch.as_tensor(cm), meta, bundle_t, B)
                    col = f if bundle_t is None else cfg[3][f]
                    got = table.numpy()[kb[:, col]]
                    # the JAX grower's per-row decision
                    if bundle_t is None:
                        bcol = jnp.asarray(kb[:, f])
                    else:
                        raw = jnp.asarray(kb[:, cfg[3][f]])
                        off = cfg[4][f]
                        in_win = (raw >= off) & (raw < off + nb[f])
                        bcol = jnp.where(in_win, raw - off, mfb[f])
                    want = jl._route_left(bcol, thr, dl, nb[f], mt[f],
                                          db[f])
                    if cat:
                        want = jnp.take(jnp.asarray(cm[0]),
                                        bcol.astype(jnp.int32), mode="clip")
                    np.testing.assert_array_equal(got, np.asarray(want))


# ------------------------------------------------ the grower, end to end
def _grow_both(bins_t, bins_j, gh, meta_args, L, B, *, max_depth=-1,
               is_cat=None, bundle=None, Bc=0, forced=None, params=None):
    kw = params or dict(min_data_in_leaf=10, lambda_l2=1.0)
    F = len(meta_args[0])
    fm = np.ones(F, bool)
    jmeta = jl.FeatureMeta(*[jnp.asarray(a) for a in meta_args],
                           is_cat=None if is_cat is None
                           else jnp.asarray(is_cat))
    tmeta = tl.FeatureMeta(*[torch.as_tensor(a) for a in meta_args],
                           is_cat=None if is_cat is None
                           else torch.as_tensor(is_cat))
    jkw, tkw = {}, {}
    if is_cat is not None:
        jkw["has_cat"] = True
        tkw["cat_idx"] = torch.as_tensor(np.nonzero(is_cat)[0])
    if bundle is not None:
        jkw.update(use_bundles=True, bundle_col_bins=Bc,
                   bundle_cfg=jl.BundleCfg(*[jnp.asarray(a)
                                             for a in bundle]))
        tkw.update(bundle_col_bins=Bc, bundle_cfg=tl.BundleCfg(
            *[torch.as_tensor(a) for a in bundle]))
    if forced is not None:
        fl, ff, ft = (np.asarray(a) for a in forced)
        jkw.update(n_forced=len(fl), forced_leaf=jnp.asarray(fl),
                   forced_feat=jnp.asarray(ff), forced_thr=jnp.asarray(ft))
        tkw.update(forced_leaf=torch.as_tensor(fl, dtype=torch.int64),
                   forced_feat=torch.as_tensor(ff, dtype=torch.int64),
                   forced_thr=torch.as_tensor(ft, dtype=torch.int64))
    tj, rlj = jl.grow_tree_leafwise(
        jnp.asarray(bins_j), jnp.asarray(gh), jmeta, jnp.asarray(fm),
        js.SplitParams(**kw), L, B, max_depth, **jkw)
    tt, rlt = tl.grow_tree_leafwise(
        torch.as_tensor(bins_t), torch.as_tensor(gh), tmeta,
        torch.as_tensor(fm), ts.SplitParams(**kw), L, B, max_depth, **tkw)
    return tt, rlt, tj, rlj


def _assert_same_tree(tt, rlt, tj, rlj):
    assert tt.num_leaves == int(tj.num_leaves)
    for k in ("split_feature", "threshold_bin", "default_left",
              "left_child", "right_child", "leaf_depth", "leaf_count"):
        np.testing.assert_array_equal(getattr(tt, k).numpy(),
                                      np.asarray(getattr(tj, k)), k)
    np.testing.assert_array_equal(rlt.numpy(), np.asarray(rlj))
    for k in ("leaf_value", "leaf_weight", "internal_value"):
        np.testing.assert_allclose(getattr(tt, k).numpy(),
                                   np.asarray(getattr(tj, k)), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", ["zero_weight", "categorical", "bundled",
                                  "forced_empty_child", "max_depth"])
def test_list_grower_matches_jax(case):
    rng = np.random.RandomState(31)
    R, F, B = 4000, 5, 16
    if case == "bundled":
        logical, enc, nb, mt, db, mfb, cfg, Bc = _bundle_fixture(rng, R)
        g = (logical[:, 0] > 8) * 1.0 - (logical[:, 1] > 4) * 0.8 \
            + (logical[:, 3] == 2) * 0.6 + 0.2 * rng.randn(R)
        gh = np.stack([g, rng.rand(R) * 0.5 + 0.5, np.ones(R)],
                      1).astype(np.float32)
        meta = (nb, mt, db, np.zeros(F, np.int32))
        tt, rlt, tj, rlj = _grow_both(enc.astype(np.int16),
                                      enc.astype(np.uint8), gh, meta,
                                      L_TEST, B, bundle=cfg, Bc=Bc)
        assert int(tt.num_leaves) == L_TEST
        used = set(tt.split_feature[:L_TEST - 1].tolist())
        assert {1, 2, 3, 4} & used          # splits on bundled members
        _assert_same_tree(tt, rlt, tj, rlj)
        return
    bins = rng.randint(0, B, (R, F)).astype(np.uint8)
    g = (bins[:, 0] > 7) * 1.0 - (bins[:, 1] > 9) * 0.6 \
        + 0.2 * rng.randn(R)
    nb = np.full(F, B, np.int32)
    z = np.zeros(F, np.int32)
    kw = {}
    is_cat = None
    if case == "categorical":
        bins[:, 3] = rng.randint(0, 6, R)
        nb[3] = 6
        g = g + np.isin(bins[:, 3], [1, 4]) * 1.5
        is_cat = np.zeros(F, bool)
        is_cat[3] = True
        kw["params"] = dict(min_data_in_leaf=10, lambda_l2=1.0,
                            min_data_per_group=20, cat_smooth=1.0)
    gh = np.stack([g, rng.rand(R) * 0.5 + 0.5, np.ones(R)],
                  1).astype(np.float32)
    if case == "zero_weight":
        gh[rng.rand(R) < 0.3] = 0.0          # out of the bag: (g w, h w, w)
    if case == "forced_empty_child":
        # feature 1 at bin 7, then its left child on feature 2 at the last
        # bin: nothing goes right, so that split is skipped
        kw["forced"] = ([0, 0], [1, 2], [7, B - 1])
    if case == "max_depth":
        kw["max_depth"] = 2
    tt, rlt, tj, rlj = _grow_both(bins, bins, gh, (nb, z, z, z), L_TEST, B,
                                  is_cat=is_cat, **kw)
    if case == "categorical":
        assert bool(tt.cat_flag[:tt.num_leaves - 1].any())
    if case == "forced_empty_child":
        assert int(tt.split_feature[0]) == 1 and int(tt.threshold_bin[0]) \
            == 7
        assert int(tt.split_feature[1]) != 2 or int(tt.threshold_bin[1]) \
            != B - 1
    if case == "max_depth":
        assert tt.num_leaves == 4 and int(tt.leaf_depth.max()) <= 2
    else:
        assert tt.num_leaves == L_TEST
    _assert_same_tree(tt, rlt, tj, rlj)
