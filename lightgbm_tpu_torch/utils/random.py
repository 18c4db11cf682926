"""Reference-parity pseudo-random streams (a numpy copy of
``lightgbm_tpu/utils/random.py``).

The reference drives every sampling decision (bagging membership, by-tree
column subsets, ...) off one small LCG (ref: include/LightGBM/utils/random.h:18
Random — x = 214013*x + 2531011 mod 2^32, int16 draws from bits 16..30) plus
a per-1024-row-block generator array for bagging (ref:
src/boosting/gbdt.cpp:804-808, gbdt.h:536). These classes reproduce those
streams draw for draw, so the port samples the same rows and columns as the
JAX package and the reference.

The per-block bagging draw matrix is computed closed-form: the k-step LCG
jump is x_k = A_k * x0 + C_k (mod 2^32) with A_k = a^k and
C_k = c * (a^{k-1} + ... + 1), so one [block_size, n_blocks] broadcast
yields every row's draw without a Python loop.
"""
from __future__ import annotations

from typing import List

import numpy as np


def round_int(x: float) -> int:
    """(ref: utils/common.h RoundInt — floor(x + 0.5))"""
    return int(np.floor(x + 0.5))


class Random:
    """Scalar LCG stream (ref: utils/random.h:18). Plain-int arithmetic
    masked to 32 bits — numpy scalar uint ops warn on wraparound."""

    def __init__(self, seed: int = 123456789):
        self.x = int(seed) & 0xFFFFFFFF

    def _step(self) -> int:
        self.x = (214013 * self.x + 2531011) & 0xFFFFFFFF
        return self.x

    def rand_int16(self) -> int:
        return (self._step() >> 16) & 0x7FFF

    def rand_int32(self) -> int:
        return self._step() & 0x7FFFFFFF

    def next_short(self, lo: int, hi: int) -> int:
        return self.rand_int16() % (hi - lo) + lo

    def next_int(self, lo: int, hi: int) -> int:
        return self.rand_int32() % (hi - lo) + lo

    def next_float(self) -> float:
        # float32 division like the reference's float arithmetic
        return float(np.float32(self.rand_int16()) / np.float32(32768.0))

    def sample(self, n: int, k: int) -> List[int]:
        """K ordered samples from {0..N-1} (ref: random.h:67 Sample —
        probability walk for large K, Floyd's set insertion otherwise)."""
        out: List[int] = []
        if k > n or k <= 0:
            return out
        if k == n:
            return list(range(n))
        if k > 1 and k > (n / np.log2(k)):
            for i in range(n):
                prob = (k - len(out)) / float(n - i)
                if self.next_float() < prob:
                    out.append(i)
            return out
        chosen = set()
        for r in range(n - k, n):
            v = self.next_int(0, r + 1)
            if v in chosen:
                chosen.add(r)
            else:
                chosen.add(v)
        return sorted(chosen)


class BlockBaggingStreams:
    """Vectorized per-block bagging generators: block i of 1024 rows owns
    an independent LCG seeded ``bagging_seed + i`` whose stream persists
    across iterations, each row consuming exactly one draw per bagging
    round (ref: gbdt.cpp:192 BaggingHelper / :804 ResetBaggingConfig)."""

    BLOCK = 1024  # ref: gbdt.h:536 bagging_rand_block_

    def __init__(self, seed: int, num_data: int):
        self.num_data = num_data
        nb = (num_data + self.BLOCK - 1) // self.BLOCK
        self.state = np.asarray(
            (int(seed) + np.arange(nb, dtype=np.int64)) & 0xFFFFFFFF,
            np.uint32)
        # closed-form k-step jump tables A_k, C_k for k = 1..BLOCK
        # (python-int arithmetic to avoid numpy scalar overflow warnings)
        a = np.empty(self.BLOCK + 1, np.uint32)
        c = np.empty(self.BLOCK + 1, np.uint32)
        ai, ci = 1, 0
        a[0], c[0] = ai, ci
        for kk in range(1, self.BLOCK + 1):
            ai = (ai * 214013) & 0xFFFFFFFF
            ci = (ci * 214013 + 2531011) & 0xFFFFFFFF
            a[kk], c[kk] = ai, ci
        self._jump_a, self._jump_c = a, c
        # per-block row counts (the last block may be partial)
        cnt = np.full(nb, self.BLOCK, np.int64)
        if num_data % self.BLOCK:
            cnt[-1] = num_data % self.BLOCK
        self._cnt = cnt

    def next_floats(self) -> np.ndarray:
        """[num_data] float32 draw per row for one bagging round, row r
        served by stream r // 1024 in row order."""
        # draws[k, b] uses state after k+1 steps of block b
        a = self._jump_a[1:, None]            # [BLOCK, 1]
        c = self._jump_c[1:, None]
        X = a * self.state[None, :] + c       # uint32 wraps
        draws = ((X >> np.uint32(16)) & np.uint32(0x7FFF)).astype(
            np.float32) / np.float32(32768.0)
        # advance each block by the number of rows it served
        self.state = (self._jump_a[self._cnt] * self.state
                      + self._jump_c[self._cnt])
        return draws.T.reshape(-1)[:self.num_data]
