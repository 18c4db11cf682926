"""Helpers shared by the port's parity tests (not a test module): the
tree comparison, and the Booster.update slice against the JAX package.

Where the two packages' f32 sums round a near-tie differently, only
choices that split the training rows identically may differ: a threshold
anywhere in an empty gap between the same rows, and default_left at a
node no missing row reaches (there the forward and reverse scans see the
same partition).
"""
import numpy as np


def node_rows(tree, X):
    """Per internal node: the indices of X's rows that reach it (the host
    walk of the reference, tree.h NumericalDecision)."""
    out = [None] * tree.num_internal
    stack = [(0, np.arange(X.shape[0]))]
    while stack:
        node, rows = stack.pop()
        if node < 0:
            continue
        out[node] = rows
        left = goes_left(tree, node, X[rows])
        stack.append((tree.left_child[node], rows[left]))
        stack.append((tree.right_child[node], rows[~left]))
    return out


def missing(tree, node, X):
    """Which rows of X miss the value of ``node``'s split feature."""
    v = X[:, tree.split_feature[node]]
    mt = (tree.decision_type[node] >> 2) & 3
    if mt == 2:
        return np.isnan(v)
    if mt == 1:
        return np.isnan(v) | (np.abs(v) <= 1e-35)
    return np.zeros(v.shape, bool)


def goes_left(tree, node, X):
    v = X[:, tree.split_feature[node]]
    miss = missing(tree, node, X)
    v = np.where(np.isnan(v) & ~miss, 0.0, v)    # NaN rides as 0.0
    dl = bool(tree.decision_type[node] & 2)
    return np.where(miss, dl, v <= tree.threshold[node])


def assert_same_trees(port_models, jax_models, X, rtol=1e-5, atol=1e-6):
    """Equal structure under the near-tie rule above; leaf values within
    rtol/atol (f32 sums taken in another order)."""
    assert len(port_models) == len(jax_models)

    def tbin(t, node):      # a tree read from model text keeps no bins
        return t.threshold_bin[node] if node < len(t.threshold_bin) else "-"
    for a, b in zip(port_models, jax_models):
        assert a.num_leaves == b.num_leaves
        for k in ("split_feature", "left_child", "right_child",
                  "leaf_count"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
        np.testing.assert_array_equal(a.decision_type & ~2,
                                      b.decision_type & ~2)
        for node, rows in enumerate(node_rows(b, X)):
            np.testing.assert_array_equal(
                goes_left(a, node, X[rows]), goes_left(b, node, X[rows]),
                f"node {node}: bins {tbin(a, node)}/{tbin(b, node)}")
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=rtol,
                                   atol=atol)


# ------------------------------------------- the Booster.update slice
# tests/test_epilogue.py's data and base parameters, shared by
# tests/test_torch_epilogue.py and tests/test_torch_update.py
BASE = {"objective": "binary", "num_leaves": 15, "verbose": -1,
        "tpu_engine": "fused", "min_data_in_leaf": 5}
UPDATES = 6


def make_data():
    """3,000 x 10 rows, 4% NaN; a binary label of two features and a noisy
    regression label of one."""
    rng = np.random.RandomState(3)
    n = 3000
    X = rng.randn(n, 10)
    X[rng.rand(n, 10) < 0.04] = np.nan
    y = (np.nan_to_num(X[:, 0]) + 0.4 * np.nan_to_num(X[:, 1])
         > 0).astype(np.float32)
    yr = (np.nan_to_num(X[:, 0]) * 2.0
          + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y, yr


def update(pkg, X, label, params, n=UPDATES):
    """``pkg.Booster(params, Dataset)`` then ``n`` bare ``update()``s."""
    bst = pkg.Booster(params=params, train_set=pkg.Dataset(X, label=label))
    for _ in range(n):
        bst.update()
    return bst


def assert_update_matches_jax(data, params, trees=UPDATES):
    """Port ``update()`` x UPDATES against the JAX package's epilogue path:
    ``trees`` trees (fewer = training stopped and the port dropped its
    carry), equal under the near-tie rule, predictions and training scores
    at rtol 1e-5, atol 1e-6."""
    import lightgbm_tpu as lj
    import lightgbm_tpu_torch as lt
    X, y, yr = data
    p = dict(BASE, **params)
    label = yr if p["objective"] == "regression" else y
    bj = update(lj, X, label, p)
    bt = update(lt, X, label, dict(p, device_type="cpu"))
    assert bj._gbdt._use_epilogue() and bt._gbdt._use_epilogue()
    bj.num_trees()                     # settles the pipelined trees
    assert bt.num_trees() == trees
    assert (bt._gbdt._epi_carry is None) == (trees < UPDATES)
    assert_same_trees(bt.models, bj.models, X)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(bt.train_scores().numpy(),
                               np.asarray(bj._gbdt.scores)[0], rtol=1e-5,
                               atol=1e-6)


def kernel_slabs(kw):
    """(flat offset, width) of each kernel row's slab, from the level
    wrappers' keywords (``num_bins``, ``f_oh``, ``packed``)."""
    pk = kw["packed"]
    if pk is not None:
        return [(int(o), int(w)) for o, w in zip(pk.flat_offsets, pk.widths)]
    B = kw["num_bins"]
    return [(j * B, B) for j in range(kw["f_oh"])]


def odd_route_table(W, slabs, seed=0):
    """The grower's route table (one slab per W row) with slot 0's row
    spread over a second kernel row's slab and slot 2's row all zero: any
    0/1 W must route as the full W @ one-hot sum does."""
    W = W.clone()
    K = len(slabs)
    j0 = next(j for j, (o, w) in enumerate(slabs) if bool(W[0, o:o + w].any()))
    o, w = slabs[(j0 + 1 + seed % (K - 1)) % K]
    W[0, o:o + max(1, w // 2)] = 1
    W[2] = 0
    return W


def cat_route_table(W, slabs, tbl, seed=0):
    """The grower's route table with every active slot's row replaced by a
    categorical left set on its own slab: random bins with holes inside
    the slab, bin 0 (NaN/other) always out (slabs of >= 4 bins)."""
    import torch
    W = W.clone()
    gen = torch.Generator(device=W.device).manual_seed(seed)
    for k in range(W.shape[0]):
        if int(tbl[k, 0]) < 0:
            continue
        o, w = next((o, w) for o, w in slabs if bool(W[k, o:o + w].any()))
        keep = torch.rand(w, generator=gen, device=W.device) < 0.4
        keep[:4] = torch.tensor([False, True, False, True])
        W[k, o:o + w] = keep.to(W.dtype)
    return W


def level_operands(R, Rp, num_bin, Bp, Sp, *, nch=5, quant_bits=0,
                   packed=False, masked=False, seed=0, device="cpu"):
    """Operands of one ``level_pass`` from a numpy seed, on ``device``.

    Feature f's bins lie in [0, num_bin[f]); rows R..Rp-1 are padding (leaf
    -1, bins 0, channels 0); ~30% of the real rows have zero channels (out
    of the bag). With Sp >= 3 the slots are leaves 0..Sp-2 on random
    splits with missing types None/Zero/NaN, slot 1's leaf holds no row
    (an empty slot) and slot Sp-1 is inactive (-2). Sp = 1 is the root
    pass: every real row in leaf 0, sent left over the first kernel row's
    slab into the smaller child. ``quant_bits`` packs the int8 channels
    (nch from QNCH), ``packed`` lays the rows out on the adaptive layout,
    ``masked`` turns every odd feature off but logical feature 0 and the
    first kernel row's feature (the grower's rule).

    Returns ((bins_T, leaf_T, gh_T, W, tbl), fmask or None, the level
    wrappers' keywords).
    """
    import torch
    from lightgbm_tpu_torch.ops import fused_level as tfl
    from lightgbm_tpu_torch.ops import layout as tlayout
    from lightgbm_tpu_torch.ops.quantize import QNCH
    rng = np.random.RandomState(seed)
    t = torch.as_tensor
    nb = np.asarray(num_bin, np.int32)
    F = len(nb)
    F_oh, _ = tlayout.feature_layout(F, Bp)
    pk = (tlayout.packed_feature_layout(nb, Bp - 1, f_oh=F_oh)
          if packed else None)
    order = np.asarray(pk.feat_order) if packed else np.arange(F)
    bins = np.zeros((max(F_oh, 8), Rp), np.int64)
    bins[:F, :R] = np.stack([rng.randint(0, n, R) for n in nb])[order]
    w = (rng.rand(Rp) >= 0.3).astype(np.float32)
    w[R:] = 0
    g = t(rng.randn(Rp).astype(np.float32) * w)
    h = t(rng.rand(Rp).astype(np.float32) * 0.25 * w)
    if quant_bits:
        nch = QNCH[quant_bits]
        gh, _ = tfl.pack_gh_quant(g, h, t(w), quant_bits, seed=seed)
    else:
        gh = tfl.pack_gh(g, h, t(w), nch)
    tbl = np.zeros((Sp, 128), np.int32)
    if Sp == 1:
        leaf = np.zeros(Rp, np.int32)
        W = torch.zeros((1, pk.fb if packed else F_oh * Bp),
                        dtype=torch.bfloat16)
        W[0, :pk.widths[0] if packed else Bp] = 1
        tbl[0, 2] = 1
    else:
        lof = np.arange(Sp, dtype=np.int32)
        lof[-1] = -2
        live = [k for k in range(Sp - 1) if k != 1] or [0]
        leaf = rng.choice(live, Rp).astype(np.int32)
        feat = np.where(lof >= 0, rng.randint(0, F, Sp), -1).astype(np.int32)
        thr = (rng.rand(Sp) * (nb[np.maximum(feat, 0)] - 1)).astype(np.int32)
        W = tfl.build_route_table(
            t(feat), t(thr), t(rng.rand(Sp) < 0.5), t(nb),
            t(rng.randint(0, 3, F).astype(np.int32)),
            t((rng.rand(F) * (nb - 1)).astype(np.int32)), Sp, F_oh, Bp)
        if packed:
            W = tfl.pack_route_table(W, pk)
        tbl[:, 0] = lof
        tbl[:, 1] = np.where(lof >= 0, Sp, 0)
        tbl[:, 2] = rng.randint(0, 2, Sp)
    leaf[R:] = -1
    fm = None
    if masked:
        fm = torch.arange(F_oh) % 2 == 0
        fm[int(order[0])] = True
    dev = torch.device(device)
    ops = (t(bins).to(torch.int8 if Bp <= 128 else torch.int16),
           t(leaf)[None, :], gh, W, t(tbl))
    ops = tuple(a.to(dev).contiguous() for a in ops)
    kw = dict(num_bins=Bp, f_oh=F_oh, nch=nch, quant_bits=quant_bits,
              packed=pk)
    return ops, None if fm is None else fm.to(dev), kw


def random_tree_children(rng, n_leaves):
    """(left_child, right_child) of a random tree in LightGBM's layout,
    grown by splitting a random leaf n_leaves - 1 times (internal node i
    splits a leaf into itself and leaf i + 1; a child < 0 is ~leaf)."""
    left, right, slot = [], [], {0: None}
    for i in range(n_leaves - 1):
        leaf = int(rng.randint(0, i + 1))
        left.append(~leaf)
        right.append(~(i + 1))
        if slot[leaf] is not None:
            node, side = slot[leaf]
            (left if side == 0 else right)[node] = i
        slot[leaf], slot[i + 1] = (i, 0), (i, 1)
    return left, right


def _depth(left, right):
    depth, frontier = 0, [0] if left else []
    while frontier:
        depth += 1
        frontier = [c for nd in frontier for c in (left[nd], right[nd])
                    if c >= 0]
    return depth


def random_stack(variant, R=512, T=12, F=6, L=9, k=1, cat=False,
                 seed=0):
    """A random packed stack for ``ops.predict.predict_pass``: (encoded
    rows [R, F], {name: numpy array} in ``FIELDS[variant]``, tids [T],
    max_steps). Trees of 1-L leaves (one single-leaf tree), missing types
    and default-left at random; binned rows hit the missing bins, raw rows
    hold NaN, zeros, values in the zero band, negatives and categories
    past the masks; with ``cat`` about a quarter of the nodes are
    categorical."""
    rng = np.random.RandomState(seed)
    N = L - 1
    sf = np.zeros((T, N), np.int32)
    dl = np.zeros((T, N), bool)
    lc = np.full((T, N), -1, np.int32)
    rc = np.full((T, N), -1, np.int32)
    lv = np.zeros((T, L), np.float32)
    cf = np.zeros((T, N), bool)
    depth = 1
    for t in range(T):
        nl = 1 if t == 1 else int(rng.randint(2, L + 1))
        left, right = random_tree_children(rng, nl)
        ni = nl - 1
        lc[t, :ni], rc[t, :ni] = left, right
        sf[t, :ni] = rng.randint(0, F, ni)
        dl[t, :ni] = rng.rand(ni) < 0.5
        cf[t, :ni] = cat & (rng.rand(ni) < 0.25)
        lv[t, :nl] = rng.randn(nl).astype(np.float32)
        depth = max(depth, _depth(left, right))
    out = {"sf": sf, "dl": dl, "lc": lc, "rc": rc, "lv": lv,
           "cf": cf if cat else None}
    if variant == "binned":
        num_bin = rng.randint(3, 40, F).astype(np.int32)
        missing = np.resize(np.array([0, 1, 2], np.int32), F)
        default_bin = (rng.randint(0, 1000, F) % num_bin).astype(np.int32)
        enc = (rng.randint(0, 1000, (R, F)) % num_bin).astype(np.int32)
        hit = rng.rand(R, F)
        enc = np.where(hit < 0.1, default_bin, enc)
        enc = np.where(hit > 0.9, num_bin - 1, enc).astype(np.int32)
        B = int(num_bin.max())
        out.update(tb=(rng.randint(0, 1000, (T, N))
                       % num_bin[sf]).astype(np.int32),
                   num_bin=num_bin, missing=missing,
                   default_bin=default_bin,
                   cm=(rng.rand(T, N, B) < 0.5) if cat else None)
    else:
        C = 37
        enc = rng.randn(R, F).astype(np.float32) * 3
        hit = rng.rand(R, F)
        enc[hit < 0.08] = np.nan
        enc[(hit >= 0.08) & (hit < 0.14)] = 0.0
        enc[(hit >= 0.14) & (hit < 0.17)] = 1e-36
        cats = rng.randint(-2, C + 4, (R, F)).astype(np.float32)
        enc[hit > 0.6] = cats[hit > 0.6]
        out.update(th=rng.randn(T, N).astype(np.float32) * 2,
                   mt=rng.randint(0, 3, (T, N)).astype(np.int32),
                   cm=(rng.rand(T, N, C) < 0.5) if cat else None)
    tids = (np.arange(T) % k).astype(np.int32)
    steps = 1 << max(1, depth.bit_length())
    return enc, out, tids, steps
