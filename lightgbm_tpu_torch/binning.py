"""Feature binning: value -> bin mapping construction.

TPU-native analog of the reference BinMapper (ref: include/LightGBM/bin.h:61-218,
src/io/bin.cpp:78-520).  Behavior-equivalent re-implementation in vectorized
numpy: greedy equal-count bin finding honoring ``min_data_in_bin``, the
zero-as-one-bin partition around ``kZeroThreshold``, NaN handling as an extra
last bin, categorical vocabularies sorted by count, forced bin bounds, trivial
feature pre-filtering, and the default/most-frequent-bin bookkeeping used by
the histogram FixHistogram trick.

Binning runs on host (numpy) — the reference also does this on CPU during
dataset loading — while the resulting ``[num_rows, num_features]`` bin matrix
is what lives in device memory. A numpy-only copy of
``lightgbm_tpu/binning.py`` (the port imports nothing of the JAX package), so
both packages bin a matrix identically.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from .utils import log

# ref: include/LightGBM/meta.h:54
K_ZERO_THRESHOLD = 1e-35
# ref: include/LightGBM/bin.h:39
K_SPARSE_THRESHOLD = 0.7

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

BIN_NUMERICAL = 0
BIN_CATEGORICAL = 1

_MISSING_TYPE_STR = {MISSING_NONE: "None", MISSING_ZERO: "Zero", MISSING_NAN: "NaN"}
_MISSING_TYPE_FROM_STR = {v: k for k, v in _MISSING_TYPE_STR.items()}


def _next_after(a: float) -> float:
    # ref: utils/common.h:855 GetDoubleUpperBound
    return math.nextafter(a, math.inf)


def _double_equal_ordered(a: float, b: float) -> bool:
    # ref: utils/common.h:850 CheckDoubleEqualOrdered
    return b <= math.nextafter(a, math.inf)


def greedy_find_bin(distinct_values: Sequence[float], counts: Sequence[int],
                    max_bin: int, total_cnt: int, min_data_in_bin: int) -> List[float]:
    """Equal-count greedy bin boundary search over a sorted distinct-value
    histogram (behavioral analog of ref: src/io/bin.cpp:78 GreedyFindBin).

    Values with count >= mean bin size get dedicated bins; the rest are packed
    greedily to roughly equal counts.  Returns bin upper bounds ending in +inf.
    """
    n = len(distinct_values)
    bounds: List[float] = []
    if max_bin <= 0:
        log.fatal("max_bin must be positive")
    if n <= max_bin:
        cur_cnt = 0
        for i in range(n - 1):
            cur_cnt += counts[i]
            if cur_cnt >= min_data_in_bin:
                val = _next_after((distinct_values[i] + distinct_values[i + 1]) / 2.0)
                if not bounds or not _double_equal_ordered(bounds[-1], val):
                    bounds.append(val)
                    cur_cnt = 0
        bounds.append(math.inf)
        return bounds

    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, total_cnt // min_data_in_bin))
    mean_bin_size = total_cnt / max_bin

    # Event-driven form of the sequential greedy packer: a bin closes at
    # the first index hitting one of three events (a big value, the
    # running count reaching the mean, or the count reaching half the
    # mean right before a big value), so each closure is found with a
    # prefix-sum search instead of walking every distinct value. The
    # comparisons are re-checked exactly at the landing index (the
    # searchsorted threshold base+mean can round) so the boundaries are
    # bit-identical to the sequential walk.
    dv = np.asarray(distinct_values, np.float64)
    cnts = np.asarray(counts, np.int64)
    big = cnts >= mean_bin_size
    rest_bins = max_bin - int(np.sum(big))
    rest_cnt0 = total_cnt - int(np.sum(cnts[big]))
    rest_cnt = rest_cnt0
    mean_bin_size = rest_cnt / rest_bins if rest_bins > 0 else math.inf

    cum = np.cumsum(cnts)                       # inclusive prefix counts
    cum_rest = np.cumsum(np.where(big, 0, cnts))
    big_idx = np.nonzero(big)[0]

    def first_cum_at_least(s, base, thr):
        """Smallest i >= s with cum[i] - base >= thr (exact), or n."""
        if math.isinf(thr):
            return n
        i = int(np.searchsorted(cum, base + thr, side="left"))
        while i > s and cum[i - 1] - base >= thr:
            i -= 1
        while i < n and cum[i] - base < thr:
            i += 1
        return max(i, s)

    uppers: List[float] = []
    lowers: List[float] = [float(dv[0])]
    s = 0
    while s <= n - 2 and len(uppers) < max_bin - 1:
        base = int(cum[s - 1]) if s > 0 else 0
        bp = int(np.searchsorted(big_idx, s))
        c_big = int(big_idx[bp]) if bp < len(big_idx) else n
        c_mean = first_cum_at_least(s, base, mean_bin_size)
        half = max(1.0, mean_bin_size * 0.5)
        # the only half-mean candidate that can precede c_big is the index
        # right before the first big value (later bigs are dominated)
        c_half = n
        if s + 1 <= c_big < n:
            ch = first_cum_at_least(s, base, half)
            if ch <= c_big - 1:
                c_half = c_big - 1
        closure = min(c_big, c_mean, c_half)
        if closure > n - 2:
            break
        uppers.append(float(dv[closure]))
        lowers.append(float(dv[closure + 1]))
        if len(uppers) >= max_bin - 1:
            break
        if not big[closure]:
            rest_bins -= 1
            rest_cnt = rest_cnt0 - int(cum_rest[closure])
            mean_bin_size = rest_cnt / rest_bins if rest_bins > 0 \
                else math.inf
        s = closure + 1

    for i in range(len(uppers)):
        val = _next_after((uppers[i] + lowers[i + 1]) / 2.0)
        if not bounds or not _double_equal_ordered(bounds[-1], val):
            bounds.append(val)
    bounds.append(math.inf)
    return bounds


def _split_zero_counts(distinct_values, counts):
    dv = np.asarray(distinct_values, np.float64)
    c = np.asarray(counts, np.int64)
    left = dv <= -K_ZERO_THRESHOLD
    right = dv > K_ZERO_THRESHOLD
    left_cnt_data = int(c[left].sum())
    right_cnt_data = int(c[right].sum())
    cnt_zero = int(c.sum()) - left_cnt_data - right_cnt_data
    return left_cnt_data, cnt_zero, right_cnt_data


def find_bin_zero_as_one(distinct_values: List[float], counts: List[int],
                         max_bin: int, total_cnt: int,
                         min_data_in_bin: int) -> List[float]:
    """Numerical bin bounds with a dedicated zero bin (ref: bin.cpp:256)."""
    n = len(distinct_values)
    dv = np.asarray(distinct_values, np.float64)
    left_cnt_data, cnt_zero, right_cnt_data = _split_zero_counts(
        distinct_values, counts)

    # first index with value > -K_ZERO_THRESHOLD (distinct is sorted)
    left_cnt = int(np.searchsorted(dv, -K_ZERO_THRESHOLD, side="right"))

    bounds: List[float] = []
    if left_cnt > 0 and max_bin > 1:
        denom = total_cnt - cnt_zero
        left_max_bin = max(1, int(left_cnt_data / denom * (max_bin - 1))) \
            if denom > 0 else 1
        bounds = greedy_find_bin(distinct_values[:left_cnt], counts[:left_cnt],
                                 left_max_bin, left_cnt_data, min_data_in_bin)
        if bounds:
            bounds[-1] = -K_ZERO_THRESHOLD

    right_start = int(np.searchsorted(dv, K_ZERO_THRESHOLD, side="right"))
    if right_start >= n:
        right_start = -1
    right_max_bin = max_bin - 1 - len(bounds)
    if right_start >= 0 and right_max_bin > 0:
        right = greedy_find_bin(distinct_values[right_start:],
                                counts[right_start:], right_max_bin,
                                right_cnt_data, min_data_in_bin)
        bounds.append(K_ZERO_THRESHOLD)
        bounds.extend(right)
    else:
        bounds.append(math.inf)
    return bounds


def find_bin_with_forced(distinct_values: List[float], counts: List[int],
                         max_bin: int, total_cnt: int, min_data_in_bin: int,
                         forced_bounds: List[float]) -> List[float]:
    """Numerical bin bounds honoring user-forced boundaries
    (ref: bin.cpp:157 FindBinWithPredefinedBin)."""
    n = len(distinct_values)
    dv = np.asarray(distinct_values, np.float64)
    left_cnt = int(np.searchsorted(dv, -K_ZERO_THRESHOLD, side="right"))
    right_start = int(np.searchsorted(dv, K_ZERO_THRESHOLD, side="right"))
    if right_start >= n:
        right_start = -1

    bounds: List[float] = []
    if max_bin == 2:
        bounds.append(K_ZERO_THRESHOLD if left_cnt == 0 else -K_ZERO_THRESHOLD)
    elif max_bin >= 3:
        if left_cnt > 0:
            bounds.append(-K_ZERO_THRESHOLD)
        if right_start >= 0:
            bounds.append(K_ZERO_THRESHOLD)
    bounds.append(math.inf)

    max_to_insert = max_bin - len(bounds)
    inserted = 0
    for fb in forced_bounds:
        if inserted >= max_to_insert:
            break
        if abs(fb) > K_ZERO_THRESHOLD:
            bounds.append(fb)
            inserted += 1
    bounds.sort()

    free_bins = max_bin - len(bounds)
    to_add: List[float] = []
    value_ind = 0
    for i, ub in enumerate(bounds):
        cnt_in_bin = 0
        bin_start = value_ind
        while value_ind < n and distinct_values[value_ind] < ub:
            cnt_in_bin += counts[value_ind]
            value_ind += 1
        bins_remaining = max_bin - len(bounds) - len(to_add)
        num_sub = min(round(cnt_in_bin * free_bins / total_cnt), bins_remaining) + 1
        if i == len(bounds) - 1:
            num_sub = bins_remaining + 1
        sub = greedy_find_bin(distinct_values[bin_start:value_ind],
                              counts[bin_start:value_ind], num_sub,
                              cnt_in_bin, min_data_in_bin)
        to_add.extend(sub[:-1])  # last bound is inf
    bounds.extend(to_add)
    bounds.sort()
    if len(bounds) > max_bin:
        log.fatal("forced bins produced more than max_bin bounds")
    return bounds


def effective_bin_counts(mappers: Sequence["BinMapper"]) -> np.ndarray:
    """Per-feature EFFECTIVE bin counts (NaN/zero bins included) — what
    the adaptive per-feature kernel layout
    (``ops/layout.packed_feature_layout``, ``tpu_adaptive_bins``) sizes
    each feature's slab from, instead of padding every feature to the
    global pow2 ``max_bin``.  The single emission point: dataset
    finalization routes through here, so the layout and the split-scan
    ``num_bin_per_feat`` can never disagree."""
    return np.array([max(1, int(m.num_bin)) for m in mappers], np.int32)


class BinMapper:
    """Per-feature value→bin mapping (ref: include/LightGBM/bin.h:61)."""

    def __init__(self):
        self.num_bin: int = 1
        self.missing_type: int = MISSING_NONE
        self.is_trivial: bool = True
        self.sparse_rate: float = 1.0
        self.bin_type: int = BIN_NUMERICAL
        self.min_val: float = 0.0
        self.max_val: float = 0.0
        self.default_bin: int = 0
        self.most_freq_bin: int = 0
        self.bin_upper_bound: np.ndarray = np.array([np.inf])
        self.bin_2_categorical: List[int] = []
        self.categorical_2_bin: Dict[int, int] = {}

    # ------------------------------------------------------------------
    def find_bin(self, values: np.ndarray, total_sample_cnt: int, max_bin: int,
                 min_data_in_bin: int, min_split_data: int, pre_filter: bool,
                 bin_type: int, use_missing: bool, zero_as_missing: bool,
                 forced_bounds: Optional[List[float]] = None) -> None:
        """Construct the mapping from non-zero sampled ``values``
        (behavioral analog of ref: src/io/bin.cpp:325 BinMapper::FindBin).

        ``total_sample_cnt`` includes implicit zeros not present in ``values``.
        """
        forced_bounds = forced_bounds or []
        values = np.asarray(values, dtype=np.float64)
        finite = values[~np.isnan(values)]
        na_cnt = 0
        if not use_missing:
            self.missing_type = MISSING_NONE
        elif zero_as_missing:
            self.missing_type = MISSING_ZERO
        else:
            if finite.size == values.size:
                self.missing_type = MISSING_NONE
            else:
                self.missing_type = MISSING_NAN
                na_cnt = values.size - finite.size

        self.bin_type = bin_type
        self.default_bin = 0
        zero_cnt = int(total_sample_cnt - finite.size - na_cnt)

        # distinct values with zero inserted at its sorted position, merging
        # float-equal neighbors (keeping the larger; ref: bin.cpp:357-389).
        # Vectorized: a group BREAK happens exactly where the next raw value
        # exceeds nextafter(previous raw value), and each group keeps its
        # last (largest) member — identical to the sequential chain-merge.
        sv = np.sort(finite, kind="stable")
        if sv.size == 0:
            distinct = np.array([0.0])
            counts = np.array([zero_cnt], dtype=np.int64)
        else:
            brk = sv[1:] > np.nextafter(sv[:-1], np.inf)
            starts = np.concatenate(([0], np.nonzero(brk)[0] + 1))
            ends = np.concatenate((starts[1:], [sv.size]))  # exclusive
            distinct = sv[ends - 1]
            counts = (ends - starts).astype(np.int64)
            zero_at = -1
            if sv[0] > 0.0:
                if zero_cnt > 0:     # leading zero group is gated
                    zero_at = 0
            elif sv[-1] < 0.0:
                if zero_cnt > 0:     # trailing zero group is gated
                    zero_at = len(distinct)
            else:
                # the break where the previous group ends negative and the
                # next starts positive — inserted UNCONDITIONALLY like the
                # sequential walk (a zero entry with count 0 still lands
                # in the distinct list and can shift forced/categorical
                # binning)
                first_vals = sv[starts]
                hits = np.nonzero((distinct[:-1] < 0.0)
                                  & (first_vals[1:] > 0.0))[0]
                if hits.size:
                    zero_at = int(hits[0]) + 1
            if zero_at >= 0:
                distinct = np.insert(distinct, zero_at, 0.0)
                counts = np.insert(counts, zero_at, zero_cnt)

        self.min_val = float(distinct[0]) if len(distinct) else 0.0
        self.max_val = float(distinct[-1]) if len(distinct) else 0.0

        cnt_in_bin: List[int] = []
        if bin_type == BIN_NUMERICAL:
            if self.missing_type == MISSING_NAN:
                eff_max_bin, eff_total = max_bin - 1, total_sample_cnt - na_cnt
            else:
                eff_max_bin, eff_total = max_bin, total_sample_cnt
            if forced_bounds:
                bounds = find_bin_with_forced(distinct, counts, eff_max_bin,
                                              eff_total, min_data_in_bin,
                                              forced_bounds)
            else:
                bounds = find_bin_zero_as_one(distinct, counts, eff_max_bin,
                                              eff_total, min_data_in_bin)
            if self.missing_type == MISSING_ZERO and len(bounds) == 2:
                self.missing_type = MISSING_NONE
            if self.missing_type == MISSING_NAN:
                bounds.append(math.nan)
            self.bin_upper_bound = np.asarray(bounds)
            self.num_bin = len(bounds)
            # bin of each distinct value = first bound >= value (the NaN
            # sentinel bound, when present, is last and never reached
            # since the numeric bounds end at +inf)
            numeric_bounds = np.asarray(bounds[:self.num_bin - 1],
                                        np.float64)
            dbin = np.searchsorted(numeric_bounds, np.asarray(distinct),
                                   side="left")
            cnt_in_bin = np.bincount(
                dbin, weights=np.asarray(counts, np.float64),
                minlength=self.num_bin).astype(np.int64).tolist()
            if self.missing_type == MISSING_NAN:
                cnt_in_bin[-1] = na_cnt
        else:
            # categorical: count-sorted vocabulary, bin 0 = NaN/other
            # (ref: bin.cpp:424-491)
            dvi = np.asarray(distinct, np.float64).astype(np.int64)
            ci = np.asarray(counts, np.int64)
            neg = dvi < 0
            if np.any(neg):
                na_cnt += int(ci[neg].sum())
                log.warning("Met negative value in categorical features, "
                            "will convert it to NaN")
            # aggregate per integer value (distinct floats can alias the
            # same int); unique is sorted, so a stable argsort by -count
            # keeps ascending-value order among ties like the dict walk
            vals, inv = np.unique(dvi[~neg], return_inverse=True)
            agg = np.bincount(inv, weights=ci[~neg].astype(np.float64)) \
                .astype(np.int64) if vals.size else np.zeros(0, np.int64)
            rest_cnt = total_sample_cnt - na_cnt
            self.categorical_2_bin = {-1: 0}
            self.bin_2_categorical = [-1]
            cnt_in_bin = [0]
            self.num_bin = 1
            if rest_cnt > 0:
                perm = np.argsort(-agg, kind="stable")
                order = [(int(vals[p]), int(agg[p])) for p in perm]
                cut_cnt = int(round(rest_cnt * 0.99))
                distinct_cnt = len(order) + (1 if na_cnt > 0 else 0)
                eff_max_bin = min(distinct_cnt, max_bin)
                used_cnt = 0
                for idx, (cat, c) in enumerate(order):
                    if not (used_cnt < cut_cnt or self.num_bin < eff_max_bin):
                        break
                    if c < min_data_in_bin and idx > 1:
                        break
                    self.bin_2_categorical.append(cat)
                    self.categorical_2_bin[cat] = self.num_bin
                    used_cnt += c
                    cnt_in_bin.append(c)
                    self.num_bin += 1
                if len(self.bin_2_categorical) - 1 == len(order) and na_cnt == 0:
                    self.missing_type = MISSING_NONE
                else:
                    self.missing_type = MISSING_NAN
                cnt_in_bin[0] = total_sample_cnt - used_cnt

        self.is_trivial = self.num_bin <= 1
        if not self.is_trivial and pre_filter and self._need_filter(
                cnt_in_bin, total_sample_cnt, min_split_data):
            self.is_trivial = True

        if not self.is_trivial:
            self.default_bin = int(self.value_to_bin(0.0))
            self.most_freq_bin = int(np.argmax(cnt_in_bin))
            max_sparse_rate = cnt_in_bin[self.most_freq_bin] / total_sample_cnt
            if (self.most_freq_bin != self.default_bin
                    and max_sparse_rate < K_SPARSE_THRESHOLD):
                self.most_freq_bin = self.default_bin
            self.sparse_rate = cnt_in_bin[self.most_freq_bin] / total_sample_cnt
        else:
            self.sparse_rate = 1.0

    def _need_filter(self, cnt_in_bin: List[int], total_cnt: int,
                     filter_cnt: int) -> bool:
        """True if no split on this feature could satisfy min_data
        (ref: bin.h:87-120 NeedFilter analog: cumulative count check)."""
        if self.bin_type == BIN_NUMERICAL:
            sum_left = 0
            for i in range(len(cnt_in_bin) - 1):
                sum_left += cnt_in_bin[i]
                if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
                    return False
            return True
        else:
            if len(cnt_in_bin) <= 2:
                for c in cnt_in_bin:
                    if c >= filter_cnt and total_cnt - c >= filter_cnt:
                        return False
                return True
            return False

    # ------------------------------------------------------------------
    def _bounds_f32(self, n_numeric: int) -> np.ndarray:
        """Largest-float32-not-above each f64 bound: for float32 inputs v,
        v <= bound_f64 iff v <= bound_f32, so binning float32 data against
        these is bit-identical to the f64 comparison without upcasting the
        whole column."""
        cached = getattr(self, "_bounds_f32_cache", None)
        if cached is not None and len(cached) == n_numeric:
            return cached
        b = np.asarray(self.bin_upper_bound[:n_numeric], np.float64)
        b32 = b.astype(np.float32)
        over = b32.astype(np.float64) > b
        b32[over] = np.nextafter(b32[over], np.float32(-np.inf))
        self._bounds_f32_cache = b32
        return b32

    def value_to_bin(self, value):
        """Vectorized value→bin (ref: bin.h:457-495 ValueToBin)."""
        scalar = np.isscalar(value)
        arr = np.atleast_1d(np.asarray(value))
        if self.bin_type == BIN_CATEGORICAL:
            v = arr.astype(np.float64, copy=False)
            iv = np.where(np.isnan(v), -1, v).astype(np.int64)
            cached = getattr(self, "_cat_lookup_cache", None)
            if cached is None or len(cached[0]) != len(
                    self.categorical_2_bin):
                cats = np.array(sorted(self.categorical_2_bin), np.int64)
                cbins = np.array([self.categorical_2_bin[c] for c in cats],
                                 np.int32)
                cached = self._cat_lookup_cache = (cats, cbins)
            cats, cbins = cached
            pos = np.clip(np.searchsorted(cats, iv), 0, len(cats) - 1)
            out = np.where(cats[pos] == iv, cbins[pos], 0).astype(np.int32)
            return out[0] if scalar else out
        # float32 columns bin against pre-rounded f32 bounds (exact; see
        # _bounds_f32) — no 2x column upcast copy on the hot ingest path
        n_numeric = self.num_bin - (1 if self.missing_type == MISSING_NAN
                                    else 0)
        if arr.dtype == np.float32:
            v = arr
            bounds = self._bounds_f32(n_numeric)
            zero = np.float32(0.0)
        else:
            v = arr.astype(np.float64, copy=False)
            bounds = self.bin_upper_bound[:n_numeric]
            zero = 0.0
        nan_mask = np.isnan(v)
        # bin = smallest i with value <= bin_upper_bound[i]; searchsorted
        # side='left' returns exactly the first index whose bound >= value
        safe_v = np.where(nan_mask, zero, v)
        out = np.searchsorted(bounds, safe_v, side="left").astype(np.int32)
        out = np.minimum(out, n_numeric - 1)
        if self.missing_type == MISSING_NAN:
            out = np.where(nan_mask, self.num_bin - 1, out)
        return out[0] if scalar else out

    def bin_to_value(self, bin_idx: int) -> float:
        """Representative threshold for a bin (used in model text output —
        ref: tree.cpp RealThreshold uses the bin upper bound)."""
        if self.bin_type == BIN_CATEGORICAL:
            return float(self.bin_2_categorical[bin_idx])
        return float(self.bin_upper_bound[bin_idx])
