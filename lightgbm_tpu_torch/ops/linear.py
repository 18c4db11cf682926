"""Linear-tree leaves: the per-leaf ridge fit and the per-row outputs.

PyTorch counterpart of the JAX package's ``_fit_linear_leaves``
(``lightgbm_tpu/boosting/gbdt.py:3018-3074``; ref:
linear_tree_learner.cpp CalculateLinear, Eq 3 of arXiv:1802.05640) and of
``HostTree._linear_outputs`` (``lightgbm_tpu/models/tree.py:205-228``).
Neither is a TPU kernel: the JAX package runs both on the host in numpy.

Each leaf of a tree past the first iteration fits, on the raw values of
the numerical columns its root path splits on (sorted real column ids),
``coef = -(X^T H X + lambda I)^-1 X^T g`` in float64, with an intercept
column last and lambda on every diagonal entry, the intercept's included.
Only in-bag rows take part, and of those only the rows with no NaN in the
leaf's columns. A leaf keeps its constant when it has no such column,
fewer than ``len(columns) + 2`` rows, a singular system, or a non-finite
solution.

:func:`fit_linear_leaves` is the device form, with every sum in a fixed
order, so that one run's fits are the next run's to the bit (atomic adds
would reorder them, and the fits feed the training scores). The rows are
sorted by leaf (a stable sort) and cut into blocks of up to ``_BLOCK``
rows of one leaf; each row gathers its leaf's columns into a padded
``[P+1]`` float64 vector (P the widest path); a batched matmul sums each
block's ``X^T H X`` and ``X^T g``, and a matmul with the blocks' one-hot
leaf matrix sums the blocks of each leaf. The padded dimensions become
identity rows with a zero right-hand side, and one batched
``torch.linalg.solve_ex`` solves every leaf (its ``info`` stands where
the JAX code catches ``LinAlgError``). :func:`fit_linear_leaves_plain` is
the host numpy copy of the JAX loop; sums in another order make the two
differ by ~1e-12 relative.

The JAX package takes the path's columns from ``branch_features()`` as
inner feature indices, though ``split_feature`` there already holds real
ones; on a dataset with a dropped trivial column that indexes the wrong
columns or fails. Here the caller passes the real columns, and whether a
column is categorical comes from that column's own bin mapper.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

# rows per block of one leaf, and bytes of a chunk of blocks' gathered
# columns ([blocks, _BLOCK, P+1] float64)
_BLOCK = 512
_CHUNK_BYTES = 1 << 28

Fit = List[Optional[Tuple[List[int], List[float], float]]]


def _leaf_table(paths: List[List[int]], device):
    """(feats [L, P] int64, mask [L, P] bool, nf [L] int64) of the
    leaves' column lists, padded with column 0."""
    L = len(paths)
    P = max((len(p) for p in paths), default=0)
    feats = np.zeros((L, max(P, 1)), np.int64)
    mask = np.zeros((L, max(P, 1)), bool)
    for leaf, p in enumerate(paths):
        feats[leaf, :len(p)] = p
        mask[leaf, :len(p)] = True
    nf = np.asarray([len(p) for p in paths], np.int64)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return t(feats), t(mask), t(nf), P


def fit_linear_leaves(raw: torch.Tensor, row_leaf: torch.Tensor,
                      grad: torch.Tensor, hess: torch.Tensor,
                      in_bag: torch.Tensor, paths: List[List[int]],
                      lam: float) -> Fit:
    """Per leaf, (columns, coefficients, intercept) of its ridge fit, or
    None where it keeps its constant. ``raw`` [n, F] float32 (the
    dataset's raw columns), ``row_leaf`` [n] leaf of every row, ``grad``
    and ``hess`` [n] f32, ``in_bag`` [n] bool, ``paths`` the leaves'
    sorted numerical path columns; all on one device. One host read."""
    L = len(paths)
    dev = raw.device
    feats, mask, nf, P = _leaf_table(paths, dev)
    if P == 0:
        return [None] * L
    D = P + 1
    n = raw.shape[0]
    rl = row_leaf.long()
    # the rows sorted by leaf, the k-th row of a leaf in slot k % _BLOCK
    # of the leaf's block k // _BLOCK; no host read (nb bounds the blocks)
    order = torch.argsort(rl, stable=True)
    counts = torch.bincount(rl, minlength=L)
    per_leaf = (counts + _BLOCK - 1) // _BLOCK
    leaf_s = rl[order]
    within = (torch.arange(n, device=dev)
              - (torch.cumsum(counts, 0) - counts)[leaf_s])
    blk = (torch.cumsum(per_leaf, 0) - per_leaf)[leaf_s] + within // _BLOCK
    nb = (n + _BLOCK - 1) // _BLOCK + L
    slot = torch.full((nb, _BLOCK), n, dtype=torch.int64, device=dev)
    slot[blk, within % _BLOCK] = order
    block_leaf = torch.full((nb,), L, dtype=torch.int64, device=dev)
    block_leaf[blk] = leaf_s
    Ab = torch.empty((nb, D, D), dtype=torch.float64, device=dev)
    bb = torch.empty((nb, D), dtype=torch.float64, device=dev)
    cb = torch.empty(nb, dtype=torch.float64, device=dev)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    chunk = max(1, _CHUNK_BYTES // (_BLOCK * D * 8))
    for b0 in range(0, nb, chunk):
        s = slot[b0:b0 + chunk]                                 # [c, B]
        valid = s < n
        r = s.clamp(max=n - 1)
        lf = block_leaf[b0:b0 + chunk].clamp(max=L - 1)
        m = mask[lf][:, None, :]                                # [c, 1, P]
        x = raw[r[..., None], feats[lf][:, None, :]].double()   # [c, B, P]
        nan = torch.isnan(x)
        ok = valid & in_bag[r] & ~(nan & m).any(2)
        # dropped rows and padded columns hold 0 (a NaN times a zero
        # weight would still poison the sums)
        x = torch.where(m & ~nan, x, zero)
        xa = torch.cat([x, torch.ones_like(x[..., :1])], 2)    # [c, B, D]
        h = torch.where(ok, hess[r].double(), zero)
        g = torch.where(ok, grad[r].double(), zero)
        xt = xa.transpose(1, 2)
        Ab[b0:b0 + chunk] = torch.bmm(xt, xa * h[..., None])
        bb[b0:b0 + chunk] = torch.bmm(xt, g[..., None])[..., 0]
        cb[b0:b0 + chunk] = ok.sum(1).double()
    onehot = (block_leaf[None, :] == torch.arange(L, device=dev)[:, None]
              ).double()                                        # [L, nb]
    A = (onehot @ Ab.reshape(nb, D * D)).reshape(L, D, D)
    b = onehot @ bb
    cnt = onehot @ cb
    # lambda on the real dimensions and the intercept; the padded ones an
    # identity row with a zero right-hand side
    real = torch.cat([mask, torch.ones_like(mask[:, :1])], 1)   # [L, D]
    diag = torch.where(real, torch.full_like(b, float(lam)),
                       torch.ones_like(b))
    A = A + torch.diag_embed(diag)
    coef, info = torch.linalg.solve_ex(A, -b)
    fit_ok = ((info == 0) & torch.isfinite(coef).all(1) & (nf > 0)
              & (cnt >= nf + 2))
    host = torch.cat([coef, fit_ok[:, None].double()], 1).cpu().numpy()
    coef_h, ok_h = host[:, :D], host[:, D] > 0
    out: Fit = []
    for leaf, p in enumerate(paths):
        if not ok_h[leaf]:
            out.append(None)
            continue
        k = len(p)
        out.append((list(p), [float(c) for c in coef_h[leaf, :k]],
                    float(coef_h[leaf, P])))
    return out


def fit_linear_leaves_plain(raw: np.ndarray, row_leaf: np.ndarray,
                            grad: np.ndarray, hess: np.ndarray,
                            in_bag: np.ndarray, paths: List[List[int]],
                            lam: float) -> Fit:
    """Plain version of :func:`fit_linear_leaves`: the JAX package's
    per-leaf numpy loop on host arrays."""
    g = np.asarray(grad, np.float64)
    h = np.asarray(hess, np.float64)
    out: Fit = []
    for leaf, feats in enumerate(paths):
        out.append(None)
        if not feats:
            continue
        rows = np.nonzero((row_leaf == leaf) & in_bag)[0]
        if len(rows) < len(feats) + 2:
            continue
        Xl = raw[np.ix_(rows, feats)].astype(np.float64)
        ok = ~np.isnan(Xl).any(axis=1)
        rows = rows[ok]
        if len(rows) < len(feats) + 2:
            continue
        Xl = np.concatenate([Xl[ok], np.ones((len(rows), 1))], axis=1)
        XtHX = (Xl * h[rows][:, None]).T @ Xl
        XtHX[np.diag_indices_from(XtHX)] += lam
        Xtg = Xl.T @ g[rows]
        try:
            coef = -np.linalg.solve(XtHX, Xtg)
        except np.linalg.LinAlgError:
            continue
        if not np.isfinite(coef).all():
            continue
        out[leaf] = ([int(f) for f in feats], [float(c) for c in coef[:-1]],
                     float(coef[-1]))
    return out


def linear_leaf_outputs(tree, X: torch.Tensor,
                        leaves: torch.Tensor) -> torch.Tensor:
    """[n] float64 outputs of a linear HostTree for rows ``X`` [n, F] (any
    float dtype, cast to float64) in leaves ``leaves`` [n]: the leaf's
    ``leaf_const`` plus its coefficients times the row's values; a row
    with NaN in any of its leaf's columns takes the constant
    ``leaf_value`` (ref: tree.cpp PredictLinear)."""
    dev = X.device
    L = tree.num_leaves
    lf = list(tree.leaf_features) + [[]] * max(0, L - len(tree.leaf_features))
    lc = list(tree.leaf_coeff) + [[]] * max(0, L - len(tree.leaf_coeff))
    const = np.zeros(L, np.float64)
    k = min(L, len(tree.leaf_const))
    const[:k] = np.asarray(tree.leaf_const, np.float64)[:k]
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    leaves = leaves.long()
    base = t(const)[leaves]
    feats, mask, _, P = _leaf_table(lf[:L], dev)
    if P == 0:
        return base
    coef = np.zeros(tuple(mask.shape), np.float64)
    for leaf, cs in enumerate(lc[:L]):
        coef[leaf, :len(cs)] = cs
    m = mask[leaves]
    x = torch.gather(X, 1, feats[leaves]).double()
    nan = (torch.isnan(x) & m).any(1)
    x = torch.where(m, x, torch.zeros((), dtype=x.dtype, device=dev))
    vals = base + (x * t(coef)[leaves]).sum(1)
    lv = t(np.asarray(tree.leaf_value, np.float64)[:L])
    return torch.where(nan, lv[leaves], vals)
