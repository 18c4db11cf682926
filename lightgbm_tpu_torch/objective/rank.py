"""Learning-to-rank objectives.

PyTorch counterpart of ``lightgbm_tpu/objective/rank.py`` (ref:
src/objective/rank_objective.hpp LambdarankNDCG, RankXENDCG). The queries
are padded into a ``[num_queries, max_docs]`` gather (``RankingObjective``)
and every query's lambdas come from one batched tensor program on the
training device, with no per-query Python loop and no host read:

- ``lambdarank``: each query's documents sorted by score (a stable sort,
  as ``jnp.argsort(stable=True)``: the first iteration's scores all tie),
  then the pairwise lambdas weighted by |ΔNDCG| over the pairs whose upper
  position lies under ``lambdarank_truncation_level``. The JAX package
  builds the full ``[Q, D, D]`` pair tensor; only its first
  ``min(truncation, D)`` rows can hold a pair, so the port builds
  ``[Q, T, D]`` and chunks the queries to bound each temporary (the sums
  are over the same pairs);
- ``rank_xendcg``: the listwise XE-NDCG gradients with Gumbel noise drawn
  from ``jax.random``'s Threefry on ``objective_seed`` (``utils/random``
  ``split`` and ``uniform``, the same bits).

The exact sigmoid replaces the reference's lookup table, as in the JAX
package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import dcg, log
from ..utils import random as ref_random
from .base import K_EPSILON, ObjectiveFunction

# elements of one [chunk, T, D] pair temporary (f32: 64 MiB)
PAIR_CHUNK_ELEMS = 1 << 24


class RankingObjective(ObjectiveFunction):
    """Shared query handling (ref: rank_objective.hpp:25-93): the padded
    ``[Q, D]`` row gather, its validity mask and the padded labels."""

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            log.fatal("Ranking tasks require query information")
        self.query_boundaries = metadata.query_boundaries
        self.num_queries = len(self.query_boundaries) - 1
        qb = self.query_boundaries.astype(np.int64)
        sizes = np.diff(qb)
        self.max_docs = int(sizes.max()) if len(sizes) else 0
        Q, D = self.num_queries, self.max_docs
        q_of_row = np.repeat(np.arange(Q), sizes)
        pos = np.arange(int(qb[-1])) - qb[q_of_row]
        # under a rank layout the boundaries run over the compacted real
        # rows and ``query_row_map`` carries each one's padded global row
        # (parallel/multiproc.GlobalMetadata): the gathers, the scatter
        # and the labels go through it, over all the padded rows
        self._row_map = getattr(metadata, "query_row_map", None)
        rows = np.arange(int(qb[-1]))
        if self._row_map is not None:
            rows = np.asarray(self._row_map, np.int64)
        self._out_rows = (num_data if self._row_map is None
                          else len(metadata.label))
        idx = np.zeros((Q, D), np.int64)
        valid = np.zeros((Q, D), bool)
        idx[q_of_row, pos] = rows
        valid[q_of_row, pos] = True
        self._qsizes = sizes
        self._label_padded = np.where(valid, self.label[idx], 0.0) \
            .astype(np.float32)
        t = torch.as_tensor
        self._pad_idx = t(idx, device=device)
        self._valid = t(valid, device=device)
        self._rows = t(idx[valid], device=device)
        self._labels = t(self._label_padded, device=device)
        self._weight = self._dev(self.weight)

    def _unpad(self, padded: torch.Tensor) -> torch.Tensor:
        """Padded [Q, D] values back to [1, n] row order ([1, Np] under a
        rank layout)."""
        out = torch.zeros(self._out_rows, dtype=torch.float32,
                          device=padded.device)
        out[self._rows] = padded[self._valid]
        return out[None, :]

    def _finish(self, lam: torch.Tensor, hes: torch.Tensor):
        g, h = self._unpad(lam), self._unpad(hes)
        if self._weight is not None:
            w = self._weight[None, :]
            g, h = g * w, h * w
        return g, h

    def to_string(self):
        return self.name


class LambdarankNDCG(RankingObjective):
    """Pairwise lambdas weighted by |ΔNDCG| (ref:
    rank_objective.hpp:96-277; lightgbm_tpu/objective/rank.py:68-197)."""

    name = "lambdarank"

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0.0:
            log.fatal("Sigmoid param %f should be greater than zero",
                      self.sigmoid)
        self.norm = bool(config.lambdarank_norm)
        self.truncation_level = int(config.lambdarank_truncation_level)
        self.label_gain = dcg.default_label_gain(config.label_gain)

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        dcg.check_label(self.label, len(self.label_gain))
        # inverse max DCG per query (ref: rank_objective.hpp:124-135)
        # (the JAX package reads label[qb[q]:qb[q + 1]] here, which under
        # a rank layout is the query's rows only where no rank block
        # before it is padded; the port reads through the row map)
        inv = np.zeros(self.num_queries)
        for q in range(self.num_queries):
            m = dcg.max_dcg_at_k(self.truncation_level,
                                 self.label[dcg.query_rows(
                                     self.query_boundaries, self._row_map,
                                     q)], self.label_gain)
            inv[q] = 1.0 / m if m > 0 else 0.0
        self._inv_max_dcg = self._dev(inv)
        self._gain_table = self._dev(self.label_gain)
        self._disc = self._dev(dcg.discounts(self.max_docs))

    def get_gradients(self, score):
        s = score[0][self._pad_idx]
        Q, D = s.shape
        T = min(self.truncation_level, D)
        chunk = max(1, PAIR_CHUNK_ELEMS // max(1, T * D))
        lam = torch.empty((Q, D), dtype=torch.float32, device=s.device)
        hes = torch.empty_like(lam)
        for q0 in range(0, Q, chunk):
            q1 = min(Q, q0 + chunk)
            lam[q0:q1], hes[q0:q1] = self._query_lambdas(
                s[q0:q1], self._labels[q0:q1], self._valid[q0:q1],
                self._inv_max_dcg[q0:q1], T)
        return self._finish(lam, hes)

    def _query_lambdas(self, s, y, valid, inv_max_dcg, T: int):
        """Lambdas and hessians of a block of padded queries (ref:
        rank_objective.hpp:139-230 GetGradientsForOneQuery), the pair
        (i, j) with i < j held once at [i, j] for i < T."""
        C, D = s.shape
        dev = s.device
        sig = self.sigmoid
        s_masked = torch.where(valid, s, float("-inf"))
        order = torch.sort(-s_masked, dim=1, stable=True).indices
        ys = torch.gather(y, 1, order)
        ss = torch.gather(s_masked, 1, order)
        ok = torch.gather(valid, 1, order) & torch.isfinite(ss)
        n_ok = ok.sum(1)
        best = ss[:, 0]
        worst = torch.gather(ss, 1, (n_ok - 1).clamp(min=0)[:, None])[:, 0]
        gains = self._gain_table[ys.long()]
        pos = torch.arange(D, device=dev)
        mi = pos[:T, None]
        mj = pos[None, :]
        yi, yj = ys[:, :T, None], ys[:, None, :]
        pair = ((mi < mj)[None] & ok[:, :T, None] & ok[:, None, :]
                & (yi != yj))
        hi_is_i = yi > yj
        si, sj = ss[:, :T, None], ss[:, None, :]
        ds = torch.where(hi_is_i, si - sj, sj - si)
        dcg_gap = torch.abs(gains[:, :T, None] - gains[:, None, :])
        paired_disc = torch.abs(self._disc[:T, None] - self._disc[None, :])
        delta = dcg_gap * paired_disc * inv_max_dcg[:, None, None]
        if self.norm:
            delta = torch.where((best != worst)[:, None, None],
                                delta / (0.01 + torch.abs(ds)), delta)
        p = 1.0 / (1.0 + torch.exp(sig * ds))
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        p_hess = torch.where(pair, p * (1.0 - p) * (sig * sig) * delta, zero)
        p_lambda = torch.where(pair, -sig * delta * p, zero)
        # the higher label takes +p_lambda, the lower -p_lambda; the
        # hessian adds to both
        contrib_i = torch.where(hi_is_i, p_lambda, -p_lambda)
        lam_sorted = -contrib_i.sum(1)
        lam_sorted[:, :T] += contrib_i.sum(2)
        hess_sorted = p_hess.sum(1)
        hess_sorted[:, :T] += p_hess.sum(2)
        if self.norm:
            sum_lambdas = -2.0 * p_lambda.sum((1, 2))
            factor = torch.where(
                sum_lambdas > 0,
                torch.log2(1.0 + sum_lambdas)
                / torch.clamp(sum_lambdas, min=K_EPSILON),
                torch.ones_like(sum_lambdas))
            lam_sorted = lam_sorted * factor[:, None]
            hess_sorted = hess_sorted * factor[:, None]
        lam = torch.zeros_like(lam_sorted).scatter_(1, order, lam_sorted)
        hes = torch.zeros_like(hess_sorted).scatter_(1, order, hess_sorted)
        return lam, hes


class RankXENDCG(RankingObjective):
    """XE_NDCG listwise objective [arxiv.org/abs/1911.09798] (ref:
    rank_objective.hpp:284-363; lightgbm_tpu/objective/rank.py:200-274).
    Each call draws a fresh ``[Q, D]`` Gumbel ``u`` from the next key of
    ``jax.random.split`` on ``PRNGKey(objective_seed)``."""

    name = "rank_xendcg"

    def __init__(self, config):
        super().__init__(config)
        self.seed = int(config.objective_seed)

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        self._rng_key = ref_random.prng_key(self.seed, device)

    def get_gradients(self, score):
        s = score[0][self._pad_idx]
        Q, D = s.shape
        keys = ref_random.split(self._rng_key)
        self._rng_key = keys[0]
        u = ref_random.uniform(keys[1], Q * D).reshape(Q, D)
        valid = self._valid
        zero = torch.zeros((), dtype=torch.float32, device=s.device)
        # softmax over the valid documents (ref: :315 Common::Softmax)
        rho = torch.where(valid, torch.softmax(
            torch.where(valid, s, float("-inf")), dim=1), zero)
        # Phi(l, u) = 2^l - u (ref: :355-357)
        params = torch.where(valid, torch.exp2(self._labels) - u, zero)
        inv_denom = 1.0 / torch.clamp(params.sum(1, keepdim=True),
                                      min=K_EPSILON)
        # first, second and third order terms (ref: :332-352)
        term1 = -params * inv_denom + rho
        lam = term1
        one_m_rho = torch.clamp(1.0 - rho, min=K_EPSILON)
        params1 = torch.where(valid, term1 / one_m_rho, zero)
        term2 = rho * (params1.sum(1, keepdim=True) - params1)
        lam = lam + term2
        params2 = torch.where(valid, term2 / one_m_rho, zero)
        lam = lam + rho * (params2.sum(1, keepdim=True) - params2)
        hes = rho * (1.0 - rho)
        keep = (valid.sum(1, keepdim=True) > 1) & valid
        return self._finish(torch.where(keep, lam, zero),
                            torch.where(keep, hes, zero))
