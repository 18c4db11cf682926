"""DCG/NDCG helpers shared by the lambdarank objective and rank metrics.

A numpy copy of ``lightgbm_tpu/utils/dcg.py`` (ref:
src/metric/dcg_calculator.cpp DCGCalculator), so the port builds the same
gain and discount tables and ideal DCGs without importing the JAX package.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from . import log

K_MAX_POSITION = 10000


def default_label_gain(label_gain: Optional[Sequence[float]]) -> np.ndarray:
    """label_gain[i] = 2^i - 1 (ref: dcg_calculator.cpp:33)."""
    if label_gain:
        return np.asarray(label_gain, dtype=np.float64)
    return np.array([0.0] + [float((1 << i) - 1) for i in range(1, 31)])


def discounts(n: int) -> np.ndarray:
    """discount[i] = 1/log2(2+i) (ref: dcg_calculator.cpp:49)."""
    return 1.0 / np.log2(2.0 + np.arange(n, dtype=np.float64))


def query_rows(query_boundaries: np.ndarray, row_map: Optional[np.ndarray],
               q: int) -> np.ndarray:
    """The rows of query ``q``: ``[qb[q], qb[q + 1])``, or under a rank
    layout those compacted rows' padded global rows through ``row_map``
    (``parallel/multiproc.GlobalMetadata.query_row_map``)."""
    rows = np.arange(query_boundaries[q], query_boundaries[q + 1])
    return rows if row_map is None else np.asarray(row_map)[rows]


def check_label(label: np.ndarray, num_gains: int) -> None:
    # ref: dcg_calculator.cpp CheckLabel — integral labels within gain table
    li = label.astype(np.int64)
    if np.any(np.abs(label - li) > 1e-9) or label.min() < 0:
        log.fatal("NDCG labels must be non-negative integers")
    if li.max() >= num_gains:
        log.fatal("Label %d is larger than the size of label_gain (%d)",
                  int(li.max()), num_gains)


def max_dcg_at_k(k: int, label: np.ndarray,
                 label_gain: np.ndarray) -> float:
    """Ideal DCG@k — greedy from the top label (ref: dcg_calculator.cpp:55
    CalMaxDCGAtK)."""
    n = len(label)
    k = min(k, n)
    sorted_gain = np.sort(label_gain[label.astype(np.int64)])[::-1]
    return float(np.sum(sorted_gain[:k] * discounts(k)))


def dcg_at_k(ks: Sequence[int], label: np.ndarray, score: np.ndarray,
             label_gain: np.ndarray) -> List[float]:
    """DCG at each k for one query, docs ranked by score descending
    (ref: dcg_calculator.cpp CalDCG; stable sort matches reference)."""
    order = np.argsort(-score, kind="stable")
    gains = label_gain[label.astype(np.int64)[order]]
    n = len(label)
    disc = discounts(n)
    cum = np.cumsum(gains * disc)
    return [float(cum[min(k, n) - 1]) if n > 0 else 0.0 for k in ks]
