"""TreeSHAP feature contributions (``Booster.predict(pred_contrib=True)``).

PyTorch counterpart of ``lightgbm_tpu/io/shap.py`` (ref:
include/LightGBM/tree.h:437 PredictContrib, the TreeSHAP recursion of
Lundberg et al.). The output is ``[n, k * (F + 1)]`` float64: per class
block, one column per feature and the model's expected value in column F.
Models are explained as the JAX package explains them: a linear tree by
its constant ``leaf_value``, an averaged-output (RF) model by the sum of
its trees, not their mean; neither is additive to ``predict`` then.

:func:`predict_contrib` is the device form, the path decomposition of
TreeSHAP (the GPUTreeShap formulation): each leaf's root path is reduced,
once per tree on the host, to its unique features in first-occurrence
order, each with its zero fraction (the product of child/parent cover
ratios over the path's splits on it, counts floored at 1) and the
directions the path takes at those splits. Then per row chunk on the
device: every row's decision at every internal node in one pass (the
rules of ``_decision`` below, which the predictor's routing also follows
except for a categorical NaN, which SHAP reads as category 0), and per
(row, leaf) the pattern of its path elements' one fractions (1 iff the row
follows the path at all of that feature's splits), packed into int64
words. A leaf's terms depend on the row only through that pattern, so
the chunk's distinct (leaf, pattern) keys (a 1-D ``torch.unique``; a
pattern longer than one word renumbers the keys densely before each
further word) are weighed once each: the extend recursion of the path weights and every element's
unwound sum, vectorised over ``[pairs, E + 1]``. A leaf with fewer than
the tree's E elements is padded with (1, 1) elements: those never change
the value of a feature subset, so they leave every other element's
Shapley weight as it is. The terms ``w * (one - zero) * leaf_value`` are
gathered back to the rows and summed into the features by a matmul with
the elements' one-hot feature matrix: a fixed order, so that a second
call gives the same bits (atomic adds would not).

:func:`predict_contrib_plain` is the host copy of the JAX package's
per-row recursion (extend, unwind, unwound sum), run for every row at once
with numpy arrays in place of the per-row scalars; it visits the left
child before the right where the JAX package visits the row's hot child
first, so the two sum each leaf's terms in another order.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..ops.predict import cat_value_masks

K_ZERO_THRESHOLD = 1e-35
# device bytes of the per-chunk path-weight arrays
_CHUNK_BYTES = 1 << 31


def expected_value(tree) -> float:
    """The tree's mean output over the training rows (its leaf values
    weighted by their counts floored at 1; ``shap.py:130-139``)."""
    if tree.num_leaves <= 1:
        return float(tree.leaf_value[0])
    total = max(float(tree.internal_count[0]), 1.0)
    ev = 0.0
    for leaf in range(tree.num_leaves):
        ev += float(tree.leaf_value[leaf]) \
            * max(float(tree.leaf_count[leaf]), 1.0) / total
    return ev


def _node_count(tree, node: int) -> float:
    if node < 0:
        return max(float(tree.leaf_count[~node]), 1.0)
    return max(float(tree.internal_count[node]), 1.0)


# ------------------------------------------------------------ plain form
def _decision(tree, node: int, X: np.ndarray) -> np.ndarray:
    """[n] bool: rows of ``X`` that go left at ``node`` (``shap.py:16-38``:
    NaN follows default_left under missing type NaN and reads as 0.0
    otherwise; a categorical value goes left iff its truncated integer is
    in the node's bitset; missing type Zero sends |v| <= 1e-35 the default
    way)."""
    v = X[:, int(tree.split_feature[node])]
    d = int(tree.decision_type[node])
    dl = bool(d & 2)
    mt = (d >> 2) & 3
    nan = np.isnan(v)
    v = np.where(nan, 0.0, v)
    if d & 1:
        words = tree.cat_bitset(node)
        iv = np.where(v >= 0, np.minimum(v, 32.0 * len(words)), -1.0)
        iv = iv.astype(np.int64)
        ok = (iv >= 0) & (iv < 32 * len(words))
        w = np.asarray(words, np.int64)[np.clip(iv // 32, 0,
                                                len(words) - 1)]
        res = ok & (((w >> (iv % 32)) & 1) == 1)
    else:
        res = v <= float(tree.threshold[node])
        if mt == 1:
            res = np.where(np.abs(v) <= K_ZERO_THRESHOLD, dl, res)
    if mt == 2:
        res = np.where(nan, dl, res)
    return res


def _extend(path, zero_fraction, one_fraction, feature_index, n_rows):
    path = [[r[0], r[1], r[2], r[3].copy()] for r in path] + [
        [feature_index, zero_fraction, one_fraction,
         np.full(n_rows, 1.0 if len(path) == 0 else 0.0)]]
    n = len(path) - 1
    for i in range(n - 1, -1, -1):
        path[i + 1][3] = path[i + 1][3] \
            + one_fraction * path[i][3] * (i + 1) / (n + 1)
        path[i][3] = zero_fraction * path[i][3] * (n - i) / (n + 1)
    return path


def _unwind(path, i):
    n = len(path) - 1
    one_fraction = path[i][2]
    zero_fraction = path[i][1]
    nz = one_fraction != 0
    one_safe = np.where(nz, one_fraction, 1.0)
    next_one_portion = path[n][3]
    out = [[r[0], r[1], r[2], r[3].copy()] for r in path]
    for j in range(n - 1, -1, -1):
        tmp = out[j][3]
        hot = next_one_portion * (n + 1) / ((j + 1) * one_safe)
        cold = out[j][3] * (n + 1) / (zero_fraction * (n - j))
        out[j][3] = np.where(nz, hot, cold)
        next_one_portion = np.where(
            nz, tmp - hot * zero_fraction * (n - j) / (n + 1),
            next_one_portion)
    for j in range(i, n):
        out[j][0] = out[j + 1][0]
        out[j][1] = out[j + 1][1]
        out[j][2] = out[j + 1][2]
    return out[:n]


def _unwound_sum(path, i):
    n = len(path) - 1
    one_fraction = path[i][2]
    zero_fraction = path[i][1]
    nz = one_fraction != 0
    one_safe = np.where(nz, one_fraction, 1.0)
    next_one_portion = path[n][3]
    total = 0.0
    for j in range(n - 1, -1, -1):
        tmp = next_one_portion * (n + 1) / ((j + 1) * one_safe)
        total = total + np.where(
            nz, tmp, path[j][3] / (zero_fraction * (n - j) / (n + 1)))
        next_one_portion = np.where(
            nz, path[j][3] - tmp * zero_fraction * (n - j) / (n + 1),
            next_one_portion)
    return total


def tree_shap_plain(tree, X: np.ndarray, phi: np.ndarray) -> None:
    """Add one tree's contributions for every row of ``X`` [n, F] float64
    to ``phi`` [n, F + 1] (``shap.py:13-127``, rows at once)."""
    if tree.num_leaves <= 1:
        return
    n_rows = X.shape[0]
    dec = {}

    def recurse(node, path, zero_fraction, one_fraction, feature_index):
        path = _extend(path, zero_fraction, one_fraction, feature_index,
                       n_rows)
        if node < 0:
            lv = float(tree.leaf_value[~node])
            for i in range(1, len(path)):
                w = _unwound_sum(path, i)
                phi[:, path[i][0]] += w * (path[i][2] - path[i][1]) * lv
            return
        f = int(tree.split_feature[node])
        if node not in dec:
            dec[node] = _decision(tree, node, X)
        go_left = dec[node]
        w = _node_count(tree, node)
        incoming_zero, incoming_one = 1.0, np.ones(n_rows)
        # undo an earlier split on the same feature
        for i in range(1, len(path)):
            if path[i][0] == f:
                incoming_zero = path[i][1]
                incoming_one = path[i][2]
                path = _unwind(path, i)
                break
        for child, side in ((int(tree.left_child[node]), go_left),
                            (int(tree.right_child[node]), ~go_left)):
            recurse(child, path,
                    _node_count(tree, child) / w * incoming_zero,
                    np.where(side, incoming_one, 0.0), f)

    recurse(0, [], 1.0, np.ones(n_rows), -1)


def predict_contrib_plain(models: List, X: np.ndarray, k: int,
                          num_features: int) -> np.ndarray:
    """Plain version of :func:`predict_contrib` on host arrays."""
    F = num_features
    out = np.zeros((X.shape[0], (F + 1) * k))
    for i, tree in enumerate(models):
        base = (i % k) * (F + 1)
        out[:, base + F] += expected_value(tree)
        phi = np.zeros((X.shape[0], F + 1))
        tree_shap_plain(tree, X, phi)
        out[:, base:base + F] += phi[:, :F]
    return out


# ----------------------------------------------------------- device form
def _tree_paths(tree, num_features: int):
    """Per tree on the host: (elem_feat [L, E] int64, elem_zero [L, E]
    float64, step_node [L, S], step_left [L, S] bool, step_elem [L, S]
    int64) of every leaf's root path: its unique features in
    first-occurrence order (padding: feature ``num_features + 1``, zero
    fraction 1) and, per split on the path, the node, the side the path
    takes and the element of its feature (padding: element E, which no
    element reads)."""
    L = tree.num_leaves
    leaves = [None] * L
    stack = [(0, [])]
    while stack:
        node, steps = stack.pop()
        for child, left in ((int(tree.left_child[node]), True),
                            (int(tree.right_child[node]), False)):
            s = steps + [(node, left, child)]
            if child < 0:
                leaves[~child] = s
            else:
                stack.append((child, s))
    E = 1
    per_leaf = []
    for steps in leaves:
        feats, zero, elem = [], [], []
        for node, _, child in steps:
            f = int(tree.split_feature[node])
            ratio = _node_count(tree, child) / _node_count(tree, node)
            if f in feats:
                e = feats.index(f)
                zero[e] = ratio * zero[e]
            else:
                e = len(feats)
                feats.append(f)
                zero.append(ratio)
            elem.append(e)
        per_leaf.append((feats, zero, elem))
        E = max(E, len(feats))
    S = max(len(s) for s in leaves)
    elem_feat = np.full((L, E), num_features + 1, np.int64)
    elem_zero = np.ones((L, E), np.float64)
    step_node = np.zeros((L, S), np.int64)
    step_left = np.zeros((L, S), bool)
    step_elem = np.full((L, S), E, np.int64)
    for leaf, (feats, zero, elem) in enumerate(per_leaf):
        elem_feat[leaf, :len(feats)] = feats
        elem_zero[leaf, :len(zero)] = zero
        for s, (node, left, _) in enumerate(leaves[leaf]):
            step_node[leaf, s] = node
            step_left[leaf, s] = left
            step_elem[leaf, s] = elem[s]
    return elem_feat, elem_zero, step_node, step_left, step_elem


def _decisions(tree, X: torch.Tensor) -> torch.Tensor:
    """[n, ni] bool: every row's side at every internal node, by the rules
    of :func:`_decision`."""
    dev = X.device
    ni = tree.num_internal
    t = lambda a, dt=None: torch.as_tensor(  # noqa: E731
        np.asarray(a)[:ni], dtype=dt, device=dev)
    d = np.asarray(tree.decision_type)[:ni]
    v = X[:, t(tree.split_feature, torch.int64)]
    dl = t((d & 2) != 0)[None, :]
    mt = t((d >> 2) & 3)[None, :]
    nan = torch.isnan(v)
    v = torch.where(nan, torch.zeros((), dtype=v.dtype, device=dev), v)
    res = v <= t(tree.threshold, torch.float64)[None, :]
    res = torch.where((mt == 1) & (v.abs() <= K_ZERO_THRESHOLD), dl, res)
    cat = cat_value_masks(tree)
    if cat is not None:
        flag, mask = (torch.as_tensor(a, device=dev) for a in cat)
        C = mask.shape[1]
        iv = torch.where(v >= 0, v.clamp(max=float(C)),
                         torch.full_like(v, -1.0)).to(torch.int64)
        node = torch.arange(ni, device=dev)[None, :]
        cat_left = mask[node, iv.clamp(0, C - 1)] & (iv >= 0) & (iv < C)
        res = torch.where(flag[None, :], cat_left, res)
    return torch.where(nan & (mt == 2), dl, res)


def _unwound_sums(one: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    """[M, E] unwound sum of every element of M paths of E elements
    (``one`` [M, E] in {0, 1}, ``zero`` [M, E]): the path weights extended
    by element 0 (no feature) and then elements 1..E, vectorised over the
    positions, then every element's unwound sum at once (n = E)."""
    M, E = one.shape
    idx = torch.arange(E + 1, dtype=torch.float64, device=one.device)
    pw = torch.zeros((M, E + 1), dtype=torch.float64, device=one.device)
    pw[:, 0] = 1.0
    for e in range(1, E + 1):
        shifted = torch.nn.functional.pad(pw[:, :-1], (1, 0))
        pw = (zero[:, e - 1:e] * pw * (e - idx) / (e + 1)
              + one[:, e - 1:e] * shifted * idx / (e + 1))
    nz = one != 0
    one_safe = torch.where(nz, one, torch.ones_like(one))
    nop = pw[:, E:E + 1].expand(M, E)
    total = torch.zeros_like(one)
    for j in range(E - 1, -1, -1):
        pj = pw[:, j:j + 1]
        tmp = nop * (E + 1) / ((j + 1) * one_safe)
        total = total + torch.where(nz, tmp,
                                    pj / (zero * (E - j) / (E + 1)))
        nop = torch.where(nz, pj - tmp * zero * (E - j) / (E + 1), nop)
    return total


# path elements per word of a row's pattern: a dense key (< 2^32) shifted
# by a word stays below 2^62
_BITS = 30


def tree_shap(tree, X: torch.Tensor, num_features: int) -> torch.Tensor:
    """[n, F + 1] float64 contributions of one tree (column F unused) for
    every row of ``X`` [n, F] float64, on X's device, in row chunks. A
    leaf's terms depend on a row only through its pattern, the one
    fraction of each of the leaf's path elements: each chunk's distinct
    (leaf, pattern) pairs are weighed once (``_unwound_sums``) and their
    terms gathered back to the rows."""
    dev = X.device
    n = X.shape[0]
    F = num_features
    phi = torch.zeros((n, F + 2), dtype=torch.float64, device=dev)
    if tree.num_leaves <= 1:
        return phi[:, :F + 1]
    L = tree.num_leaves
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    elem_feat, elem_zero, step_node, step_left, step_elem = (
        t(a) for a in _tree_paths(tree, F))
    E, S = elem_feat.shape[1], step_node.shape[1]
    W = (E + _BITS - 1) // _BITS
    step_ok = step_elem < E
    word, bit = step_elem // _BITS, step_elem % _BITS
    leaf_id = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    # [L * E, F + 2]: element (leaf, e) adds to its feature's column
    to_feat = torch.nn.functional.one_hot(elem_feat.reshape(-1),
                                          F + 2).double()
    lv = t(np.asarray(tree.leaf_value, np.float64)[:L])
    chunk = max(1, _CHUNK_BYTES // (L * E * 8 * 3))
    for r0 in range(0, n, chunk):
        Xc = X[r0:r0 + chunk]
        R = Xc.shape[0]
        dec = _decisions(tree, Xc)                           # [R, ni]
        # the bits of the elements where the row leaves the path
        off = torch.zeros((W, R, L), dtype=torch.int64, device=dev)
        for s in range(S):
            miss = (dec[:, step_node[:, s]] != step_left[None, :, s]) \
                & step_ok[None, :, s]
            for w in range(W):
                off[w] |= (miss & (word[None, :, s] == w)).long() \
                    << bit[None, :, s]
        # one int64 key per (row, leaf): the leaf, then each word's bits
        # (1: the row follows the path at all of the element's splits);
        # before every word past the first, the keys so far are numbered
        # densely (< R * L), so that the next word's bits fit
        leaves = leaf_id.expand(R, L).reshape(-1)
        key = leaves
        for w in range(W):
            if w:
                key = torch.unique(key, return_inverse=True)[1]
            b = min(_BITS, E - w * _BITS)
            key = (key << b) | (~off[w].reshape(-1) & ((1 << b) - 1))
        uniq, inv = torch.unique(key, return_inverse=True)
        # each distinct key's leaf and words (a key's (row, leaf) pairs
        # all write the same values)
        leaf_m = torch.empty(uniq.numel(), dtype=torch.int64, device=dev)
        leaf_m[inv] = leaves
        words = torch.empty((uniq.numel(), W), dtype=torch.int64,
                            device=dev)
        words[inv] = (~off).reshape(W, -1).T
        e_idx = torch.arange(E, device=dev)
        one = ((words[:, e_idx // _BITS] >> (e_idx % _BITS)) & 1).double()
        zero = elem_zero[leaf_m]                             # [M, E]
        terms = _unwound_sums(one, zero) * (one - zero) \
            * lv[leaf_m][:, None]
        phi[r0:r0 + R] = terms[inv.reshape(R, L)].reshape(R, -1) @ to_feat
    return phi[:, :F + 1]


def predict_contrib(models: List, X: torch.Tensor, k: int,
                    num_features: int) -> torch.Tensor:
    """[n, k * (F + 1)] float64 TreeSHAP contributions of ``models``
    (HostTrees; tree i explains class i % k) for ``X`` [n, F] float64, on
    X's device; column F of each class block holds the summed expected
    values (``shap.py:142-159``)."""
    F = num_features
    out = torch.zeros((X.shape[0], (F + 1) * k), dtype=torch.float64,
                      device=X.device)
    for i, tree in enumerate(models):
        base = (i % k) * (F + 1)
        out[:, base + F] += expected_value(tree)
        if tree.num_leaves > 1:
            out[:, base:base + F] += tree_shap(tree, X, F)[:, :F]
    return out
