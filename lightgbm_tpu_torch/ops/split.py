"""Best-split search over histogram planes, on the device.

PyTorch counterpart of ``lightgbm_tpu/ops/split.py``: the reference's
per-(leaf, feature) sequential threshold scan (ref:
src/treelearner/feature_histogram.hpp:85 FindBestThreshold, :858-1090
FindBestThresholdSequentially) done for a whole ``[slots, features, bins]``
tensor at once with cumulative sums and an argmax.

Semantics (feature_histogram.hpp:158-200 FuncForNumricalL3):
- missing None  -> reverse scan only (default_left=True always).
- missing Zero  -> reverse + forward scans, the zero (default) bin excluded
  from the directional accumulation so its rows ride the default direction;
  threshold == default_bin (forward) / default_bin-1 (reverse) skipped.
- missing NaN   -> reverse + forward; the NaN bin (last) is excluded from the
  reverse accumulation so NaN rows go left; forward leaves it on the right.
- num_bin <= 2  -> single scan (forward iff missing NaN).
- Ties: reverse beats forward; earlier feature beats later; within forward the
  smallest threshold wins, within reverse the largest (scan orders).
  ``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does.

Categorical features (``best_categorical_split_cm``, ref:
feature_histogram.hpp:278-470) split one-vs-rest under
``max_cat_to_onehot`` bins, else by the sorted-subset scan; a winner's
left set is an explicit bin mask (``cat_mask``), bin 0 (NaN/other) never
in it. ``best_split_cm`` takes the better of the two scans per slot.

Monotone constraints (``lightgbm_tpu/ops/split.py:254-400``): with
``monotone`` [F] every candidate whose outputs break its feature's
direction gets gain 0 (ref: GetSplitGains USE_MC); with per-slot bounds
``bound_lo``/``bound_hi`` the candidate outputs are clipped into the
slot's interval and the gain is taken on the clipped outputs, the
winner's outputs come back clipped (a categorical winner's too, with no
direction), and ``monotone_penalty`` scales the net gain of monotone
splits by the slot's depth (``leaf_depth``). Unbounded slots carry
-inf/+inf, which a clamp leaves bit-equal. The advanced mode
(``lightgbm_tpu/ops/split.py:259-296``, the leaf-wise grower's) gives the
numerical scan per-(feature, bin) bound planes ``bound_lo_plane`` /
``bound_hi_plane``: a candidate child's bound is the extremum of the plane
over the bins it covers (prefix ``cummin``/``cummax`` for the left child,
suffix for the right), the missing bin folded into its default side.

CEGB (cost-effective gradient boosting, ref:
cost_effective_gradient_boosting.hpp:66 DetlaGain): an ``[S, F]``
``cegb_delta`` is subtracted from every finite per-feature gain before the
feature choice, in the numerical and the categorical scans
(``lightgbm_tpu/ops/split.py:412-552``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

K_EPSILON = 1e-15
K_MIN_SCORE = float("-inf")

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2


class SplitParams(NamedTuple):
    """Split-finding hyper-parameters (the subset of the JAX package's
    SplitParams that its numerical and categorical scans read)."""
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    max_delta_step: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    path_smooth: float = 0.0
    monotone_penalty: float = 0.0
    # categorical split search (ref: config.h cat_l2/cat_smooth/...)
    max_cat_to_onehot: int = 4
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    min_data_per_group: int = 100
    # CEGB (ref: config.h cegb_tradeoff, cegb_penalty_split); the JAX
    # package's SplitParams holds them after lambda_l1
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0


def threshold_l1(s, l1):
    # ref: feature_histogram.hpp:737 ThresholdL1
    reg = torch.clamp(torch.abs(s) - l1, min=0.0)
    return torch.sign(s) * reg


def calculate_leaf_output(sum_grad, sum_hess, p: SplitParams,
                          num_data=None, parent_output=0.0, l2=None):
    """Closed-form Newton leaf value
    (ref: feature_histogram.hpp:742 CalculateSplittedLeafOutput).
    ``l2`` overrides p.lambda_l2 (categorical splits add cat_l2)."""
    ret = -threshold_l1(sum_grad, p.lambda_l1) / (
        sum_hess + (p.lambda_l2 if l2 is None else l2))
    if p.max_delta_step > 0:
        ret = torch.clamp(ret, -p.max_delta_step, p.max_delta_step)
    if p.path_smooth > 0 and num_data is not None:
        n_s = num_data / p.path_smooth
        ret = ret * n_s / (n_s + 1.0) + parent_output / (n_s + 1.0)
    return ret


def leaf_gain_given_output(sum_grad, sum_hess, p: SplitParams, output,
                           l2=None):
    # ref: feature_histogram.hpp:846 GetLeafGainGivenOutput
    sg = threshold_l1(sum_grad, p.lambda_l1)
    return -(2.0 * sg * output
             + (sum_hess + (p.lambda_l2 if l2 is None else l2))
             * output * output)


def leaf_gain(sum_grad, sum_hess, p: SplitParams, num_data=None,
              parent_output=0.0, l2=None):
    # ref: feature_histogram.hpp:828 GetLeafGain
    if p.max_delta_step <= 0 and p.path_smooth <= 0:
        sg = threshold_l1(sum_grad, p.lambda_l1)
        return (sg * sg) / (sum_hess + (p.lambda_l2 if l2 is None else l2))
    out = calculate_leaf_output(sum_grad, sum_hess, p, num_data,
                                parent_output, l2)
    return leaf_gain_given_output(sum_grad, sum_hess, p, out, l2)


class BestSplit(NamedTuple):
    """Per-slot best split record — the SplitInfo analog
    (ref: src/treelearner/split_info.hpp:22)."""
    feature: torch.Tensor        # int32 [S], inner feature index, -1 if none
    threshold: torch.Tensor      # int32 [S], bin threshold (left: bin <= t)
    default_left: torch.Tensor   # bool  [S]
    gain: torch.Tensor           # f32   [S], gain minus shift; -inf if invalid
    left_output: torch.Tensor    # f32   [S]
    right_output: torch.Tensor
    left_sum_grad: torch.Tensor
    left_sum_hess: torch.Tensor
    left_count: torch.Tensor     # f32 (weighted count channel)
    right_sum_grad: torch.Tensor
    right_sum_hess: torch.Tensor
    right_count: torch.Tensor
    cat_flag: torch.Tensor       # bool  [S] categorical split? (None
    cat_mask: torch.Tensor       # bool  [S, B] bins routed left   with no
    #                              categorical feature: nothing reads them)


def map_split(fn, *splits) -> BestSplit:
    """``fn`` applied field by field across BestSplits; the categorical
    fields of an all-numerical search stay None."""
    return BestSplit(*[None if fs[0] is None else fn(*fs)
                       for fs in zip(*splits)])


def _take(a: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.gather(a, dim, idx.unsqueeze(dim)).squeeze(dim)


def best_numerical_split_cm(grad: torch.Tensor, hess: torch.Tensor,
                            cnt: torch.Tensor, num_bin_per_feat: torch.Tensor,
                            missing_type: torch.Tensor,
                            default_bin: torch.Tensor,
                            feature_mask: torch.Tensor, params: SplitParams,
                            parent_output: torch.Tensor,
                            monotone: torch.Tensor = None,
                            bound_lo: torch.Tensor = None,
                            bound_hi: torch.Tensor = None,
                            leaf_depth: torch.Tensor = None,
                            cegb_delta: torch.Tensor = None,
                            bound_lo_plane: torch.Tensor = None,
                            bound_hi_plane: torch.Tensor = None
                            ) -> BestSplit:
    """Best numerical split per slot from channel-major planes.

    Args:
      grad/hess/cnt: ``[S, F, B]`` float32 histogram planes.
      num_bin_per_feat: ``[F]`` int32 actual bin counts (rest is padding).
      missing_type: ``[F]`` int32 (0 none / 1 zero / 2 nan).
      default_bin: ``[F]`` int32 (bin of value 0; the zero-missing bin).
      feature_mask: ``[F]`` or ``[S, F]`` bool.
      parent_output: ``[S]`` f32 leaf outputs (for path smoothing).
      monotone: ``[F]`` int32 in {-1, 0, 1}, or None (no constraint).
      bound_lo/bound_hi: ``[S]`` f32 per-slot output bounds (the JAX
        package's ``use_bounds``), or None; ``leaf_depth`` ``[S]`` int32
        with them, for ``monotone_penalty``.
      cegb_delta: ``[S, F]`` f32 CEGB cost, or None.
      bound_lo_plane/bound_hi_plane: ``[S, F, B]`` f32 advanced-mode
        segment bounds (with the scalar bounds, which still clip the
        winner), or None.
    """
    S, F, B = grad.shape
    p = params
    dev = grad.device
    fm3 = (feature_mask[None, :, None] if feature_mask.dim() == 1
           else feature_mask[:, :, None])

    t_iota = torch.arange(B, dtype=torch.int32, device=dev)[None, None, :]
    nb = num_bin_per_feat[None, :, None]
    mt = missing_type[None, :, None]
    db = default_bin[None, :, None]
    is_pad = t_iota >= nb

    # leaf totals: every feature's bins partition the same rows, so feature
    # 0's bin sums are the leaf totals (padding bins hold no mass)
    tot_g = grad[:, 0, :].sum(1)[:, None, None]
    tot_h = (hess[:, 0, :].sum(1) + 2.0 * K_EPSILON)[:, None, None]
    tot_c = cnt[:, 0, :].sum(1)[:, None, None]

    parent_out = parent_output[:, None, None]
    gain_shift = leaf_gain(tot_g, tot_h, p, tot_c, parent_out)
    min_gain_shift = gain_shift + p.min_gain_to_split          # [S,1,1]

    nan_bin = nb - 1
    is_missing_bin_fwd = (mt == MISSING_ZERO) & (t_iota == db)
    is_missing_bin_rev = is_missing_bin_fwd | ((mt == MISSING_NAN)
                                               & (t_iota == nan_bin))
    zero = torch.zeros((), dtype=grad.dtype, device=dev)
    neg_inf = torch.full((), K_MIN_SCORE, dtype=grad.dtype, device=dev)
    use_bounds = bound_lo is not None
    mono = monotone[None, :, None] if monotone is not None else None
    if use_bounds:
        blo = bound_lo[:, None, None]
        bhi = bound_hi[:, None, None]

    def directional_best(excl_missing_mask, thresh_valid, reverse):
        m = (~is_pad) & (~excl_missing_mask)
        g = torch.where(m, grad, zero)
        h = torch.where(m, hess, zero)
        c = torch.where(m, cnt, zero)
        if not reverse:
            left_g = torch.cumsum(g, 2)
            left_h = torch.cumsum(h, 2) + K_EPSILON
            left_c = torch.cumsum(c, 2)
            right_g = tot_g - left_g
            right_h = tot_h - left_h
            right_c = tot_c - left_c
        else:
            # right side accumulates bins > t (scan from the right)
            def rcum(x):
                r = torch.flip(torch.cumsum(torch.flip(x, [2]), 2), [2])
                return torch.cat([r[..., 1:], torch.zeros_like(r[..., :1])],
                                 2)
            right_g = rcum(g)
            right_h = rcum(h) + K_EPSILON
            right_c = rcum(c)
            left_g = tot_g - right_g
            left_h = tot_h - right_h
            left_c = tot_c - right_c

        ok = (thresh_valid
              & (left_c >= p.min_data_in_leaf)
              & (right_c >= p.min_data_in_leaf)
              & (left_h >= p.min_sum_hessian_in_leaf)
              & (right_h >= p.min_sum_hessian_in_leaf)
              & fm3)
        if bound_hi_plane is not None:
            lo, ro = _plane_clip(
                calculate_leaf_output(left_g, left_h, p, left_c, parent_out),
                calculate_leaf_output(right_g, right_h, p, right_c,
                                      parent_out),
                bound_lo_plane, bound_hi_plane, is_pad,
                excl_missing_mask, reverse)
            gains = (leaf_gain_given_output(left_g, left_h, p, lo)
                     + leaf_gain_given_output(right_g, right_h, p, ro))
        elif use_bounds:
            # candidate outputs clipped into the slot's feasible interval,
            # the gain taken on the clipped outputs (ref:
            # monotone_constraints.hpp BasicLeafConstraints +
            # feature_histogram GetSplitGains USE_MC)
            lo = torch.clamp(calculate_leaf_output(left_g, left_h, p, left_c,
                                                   parent_out), blo, bhi)
            ro = torch.clamp(calculate_leaf_output(right_g, right_h, p,
                                                   right_c, parent_out),
                             blo, bhi)
            gains = (leaf_gain_given_output(left_g, left_h, p, lo)
                     + leaf_gain_given_output(right_g, right_h, p, ro))
        else:
            gains = (leaf_gain(left_g, left_h, p, left_c, parent_out)
                     + leaf_gain(right_g, right_h, p, right_c, parent_out))
        if mono is not None:
            if not use_bounds and bound_hi_plane is None:
                lo = calculate_leaf_output(left_g, left_h, p, left_c,
                                           parent_out)
                ro = calculate_leaf_output(right_g, right_h, p, right_c,
                                           parent_out)
            # the direction check (ref: GetSplitGains USE_MC -> 0)
            viol = ((mono > 0) & (lo > ro)) | ((mono < 0) & (lo < ro))
            gains = torch.where(viol, zero, gains)
        gains = torch.where(ok & (gains > min_gain_shift), gains, neg_inf)

        if reverse:
            # prefer the LARGEST threshold on ties (the reverse scan visits
            # high t first and replaces only on strictly-greater gain)
            t_best = (B - 1) - torch.argmax(torch.flip(gains, [2]), 2)
        else:
            t_best = torch.argmax(gains, 2)
        g_best = _take(gains, t_best, 2)
        picked = [_take(a, t_best, 2)
                  for a in (left_g, left_h, left_c, right_g, right_h,
                            right_c)]
        return t_best.to(torch.int32), g_best, picked

    is_nan_mt = (mt == MISSING_NAN).to(torch.int32)
    rev_thresh_valid = ((t_iota <= nb - 2 - is_nan_mt)
                        & ~((mt == MISSING_ZERO) & (t_iota == db - 1))
                        & ~((nb <= 2) & (mt == MISSING_NAN)))
    t_rev, g_rev, s_rev = directional_best(is_missing_bin_rev,
                                           rev_thresh_valid, reverse=True)
    fwd_runs = torch.where(nb > 2, mt != MISSING_NONE, mt == MISSING_NAN)
    fwd_thresh_valid = ((t_iota <= nb - 2)
                        & ~((mt == MISSING_ZERO) & (t_iota == db))
                        & fwd_runs)
    t_fwd, g_fwd, s_fwd = directional_best(is_missing_bin_fwd,
                                           fwd_thresh_valid, reverse=False)

    # reverse wins ties (it runs first in the reference)
    use_fwd = g_fwd > g_rev
    t_best = torch.where(use_fwd, t_fwd, t_rev)                     # [S,F]
    g_best = torch.where(use_fwd, g_fwd, g_rev)
    stats = [torch.where(use_fwd, a, b) for a, b in zip(s_fwd, s_rev)]
    default_left = ~use_fwd
    if use_bounds and p.monotone_penalty > 0:
        # the depth penalty on the NET gain of monotone-feature splits,
        # after the validity gate on the gross gain (ref:
        # monotone_constraints.hpp:355 ComputeMonotoneSplitGainPenalty)
        pen = p.monotone_penalty
        d = leaf_depth[:, None].to(torch.float32)
        factor = torch.where(
            pen >= d + 1.0, torch.full_like(d, K_EPSILON),
            1.0 - pen / torch.exp2(d) + K_EPSILON if pen <= 1.0
            else 1.0 - torch.exp2(pen - 1.0 - d) + K_EPSILON)
        shift2 = min_gain_shift[:, :, 0]
        net = torch.where(torch.isfinite(g_best),
                          (g_best - shift2) * factor + shift2, g_best)
        g_best = torch.where(monotone[None, :] != 0, net, g_best)
    if cegb_delta is not None:
        g_best = torch.where(torch.isfinite(g_best), g_best - cegb_delta,
                             g_best)

    # across features: first feature wins ties (argmax picks first max)
    f_best = torch.argmax(g_best, 1)                                 # [S]
    gain = _take(g_best, f_best, 1)
    lg, lh, lc, rg, rh, rc = [_take(a, f_best, 1) for a in stats]
    valid = torch.isfinite(gain)

    left_out = calculate_leaf_output(lg, lh, p, lc, parent_output)
    right_out = calculate_leaf_output(rg, rh, p, rc, parent_output)
    if use_bounds:
        left_out = torch.clamp(left_out, bound_lo, bound_hi)
        right_out = torch.clamp(right_out, bound_lo, bound_hi)
    out_gain = torch.where(valid, gain - min_gain_shift[:, 0, 0], neg_inf)
    return BestSplit(
        feature=torch.where(valid, f_best.to(torch.int32),
                            torch.full_like(f_best, -1, dtype=torch.int32)),
        threshold=_take(t_best, f_best, 1),
        default_left=_take(default_left, f_best, 1),
        gain=out_gain,
        left_output=left_out,
        right_output=right_out,
        left_sum_grad=lg, left_sum_hess=lh - K_EPSILON, left_count=lc,
        right_sum_grad=rg, right_sum_hess=rh - K_EPSILON, right_count=rc,
        cat_flag=None, cat_mask=None,
    )


def _plane_clip(lo, ro, lo_plane, hi_plane, is_pad, excl_missing, reverse):
    """Candidate outputs [S, F, B] clipped by the advanced mode's segment
    bounds (lightgbm_tpu/ops/split.py:259-296): the left child covers bins
    <= t (prefix extrema of the planes), the right child bins > t (suffix
    extrema); the missing bins ride the default side (left in the reverse
    scan, right in the forward one) and fold their plane entries in."""
    inf = torch.full((), float("inf"), dtype=lo.dtype, device=lo.device)
    hi_pl = torch.where(is_pad, inf, hi_plane)
    lo_pl = torch.where(is_pad, -inf, lo_plane)
    hi_pref = torch.cummin(hi_pl, 2).values
    lo_pref = torch.cummax(lo_pl, 2).values
    hi_suf = torch.flip(torch.cummin(torch.flip(hi_pl, [2]), 2).values, [2])
    lo_suf = torch.flip(torch.cummax(torch.flip(lo_pl, [2]), 2).values, [2])
    hi_right = torch.cat([hi_suf[..., 1:], inf.expand_as(hi_suf[..., :1])],
                         2)
    lo_right = torch.cat([lo_suf[..., 1:], (-inf).expand_as(lo_suf[..., :1])],
                         2)
    mm = excl_missing & ~is_pad
    miss_hi = torch.where(mm, hi_pl, inf).amin(2, keepdim=True)
    miss_lo = torch.where(mm, lo_pl, -inf).amax(2, keepdim=True)
    if reverse:
        l_hi = torch.minimum(hi_pref, miss_hi)
        l_lo = torch.maximum(lo_pref, miss_lo)
        r_hi, r_lo = hi_right, lo_right
    else:
        l_hi, l_lo = hi_pref, lo_pref
        r_hi = torch.minimum(hi_right, miss_hi)
        r_lo = torch.maximum(lo_right, miss_lo)
    return (torch.minimum(torch.maximum(lo, l_lo), l_hi),
            torch.minimum(torch.maximum(ro, r_lo), r_hi))


def best_categorical_split_cm(grad: torch.Tensor, hess: torch.Tensor,
                              cnt: torch.Tensor,
                              num_bin_per_feat: torch.Tensor,
                              cat_feature_mask: torch.Tensor,
                              params: SplitParams,
                              parent_output: torch.Tensor,
                              cat_idx: torch.Tensor = None,
                              cegb_delta: torch.Tensor = None) -> BestSplit:
    """Best categorical split per slot (ref: feature_histogram.hpp:278-470
    FindBestThresholdCategoricalInner; lightgbm_tpu/ops/split.py:412-625).

    Two modes, per feature:
    - one-vs-rest when ``num_bin <= max_cat_to_onehot`` (plain lambda_l2);
    - otherwise the bins with count >= cat_smooth, sorted by
      grad / (hess + cat_smooth), scanned from both ends up to
      ``min(max_cat_threshold, (used + 1) // 2)`` categories, with
      lambda_l2 + cat_l2 and min_data_per_group batching.

    As in the JAX package, real counts (the count channel) replace the
    reference's hessian-based estimate, and bin 0 (NaN/other) is never in
    the left set. The scans are sequential over the sorted positions (a
    group restarts where a candidate passes), as the JAX package's
    ``lax.scan``; positions past ``max_cat_threshold`` are never
    candidates, so the loop stops there.

    Args:
      grad/hess/cnt: [S, F, B] float32 planes.
      num_bin_per_feat: [F] int32.
      cat_feature_mask: [F] or [S, F] bool: the categorical features that
        may be used.
      parent_output: [S] f32.
      cat_idx: the categorical features' indices, ascending (a host-known
        set): the scan then runs on those planes only, with the same
        result.
      cegb_delta: [S, F] f32 CEGB cost, or None.

    Returns a BestSplit whose winners are categorical (cat_flag True,
    cat_mask the left bin set, default_left False, threshold 0).
    """
    if cat_idx is not None:
        out = best_categorical_split_cm(
            grad[:, cat_idx], hess[:, cat_idx], cnt[:, cat_idx],
            num_bin_per_feat[cat_idx], cat_feature_mask[..., cat_idx],
            params, parent_output,
            cegb_delta=(None if cegb_delta is None
                        else cegb_delta[:, cat_idx]))
        f = out.feature
        return out._replace(feature=torch.where(
            f >= 0, cat_idx[f.clamp(min=0).long()].to(torch.int32), f))
    S, F, B = grad.shape
    p = params
    dev = grad.device
    l2_cat = p.lambda_l2 + p.cat_l2
    eps = K_EPSILON
    zero = torch.zeros((), dtype=grad.dtype, device=dev)
    neg_inf = torch.full((), K_MIN_SCORE, dtype=grad.dtype, device=dev)

    b_iota = torch.arange(B, dtype=torch.int32, device=dev)[None, None, :]
    nb = num_bin_per_feat[None, :, None]
    in_range = (b_iota >= 1) & (b_iota < nb)          # bin 0 = NaN/other

    tot_g = grad.sum(2)                               # [S, F]
    tot_h = hess.sum(2) + 2.0 * eps
    tot_c = cnt.sum(2)
    parent_out = parent_output[:, None]
    min_gain_shift = (leaf_gain(tot_g, tot_h, p, tot_c, parent_out)
                      + p.min_gain_to_split)          # [S, F]

    # ---------------- one-vs-rest (ref :318-374)
    lh1 = hess + eps
    rg1 = tot_g[..., None] - grad
    rh1 = tot_h[..., None] - lh1 - eps
    rc1 = tot_c[..., None] - cnt
    ok1 = (in_range
           & (cnt >= p.min_data_in_leaf) & (lh1 >= p.min_sum_hessian_in_leaf)
           & (rc1 >= p.min_data_in_leaf)
           & (rh1 >= p.min_sum_hessian_in_leaf))
    po3 = parent_out[..., None]
    gains1 = (leaf_gain(grad, lh1, p, cnt, po3)
              + leaf_gain(rg1, rh1, p, rc1, po3))
    gains1 = torch.where(ok1 & (gains1 > min_gain_shift[..., None]), gains1,
                         neg_inf)
    t1 = torch.argmax(gains1, 2)                      # [S, F]
    onehot_allowed = (num_bin_per_feat <= p.max_cat_to_onehot)[None, :]
    g1 = torch.where(onehot_allowed, _take(gains1, t1, 2), neg_inf)

    # ---------------- sorted subset (ref :376-473)
    ok_bin = in_range & (cnt >= p.cat_smooth)
    ratio = torch.where(ok_bin, grad / (hess + p.cat_smooth),
                        torch.full((), float("inf"), device=dev))
    order = torch.sort(ratio, dim=2, stable=True).indices  # filtered last
    sorted3 = torch.stack([torch.gather(a, 2, order)
                           for a in (grad, hess, cnt)])  # [3, S, F, B]
    used = ok_bin.sum(2)                               # [S, F]
    max_num_cat = torch.clamp((used + 1) // 2, max=p.max_cat_threshold)
    P = min(B, p.max_cat_threshold)
    tot3 = torch.stack([tot_g, tot_h, tot_c])

    def scan_dir(seq3):
        """Prefix scan over the first P sorted positions -> [S, F, P]
        candidate gains (-inf where not a candidate)."""
        sums = torch.zeros_like(tot3)
        grp = torch.zeros_like(tot_c)
        out = []
        for i in range(P):
            live = (used > i) & (max_num_cat > i)
            sums = sums + torch.where(live, seq3[..., i], zero)
            grp = grp + torch.where(live, seq3[2, ..., i], zero)
            sum_g, sum_h, sum_c = sums
            rg, rh, rc = tot3 - sums
            rh = rh - eps
            ok = (live
                  & (sum_c >= p.min_data_in_leaf)
                  & (sum_h + eps >= p.min_sum_hessian_in_leaf)
                  & (rc >= p.min_data_in_leaf)
                  & (rc >= p.min_data_per_group)
                  & (rh >= p.min_sum_hessian_in_leaf)
                  & (grp >= p.min_data_per_group))
            gain = (leaf_gain(sum_g, sum_h + eps, p, sum_c, parent_out,
                              l2_cat)
                    + leaf_gain(rg, rh, p, rc, parent_out, l2_cat))
            out.append(torch.where(ok & (gain > min_gain_shift), gain,
                                   neg_inf))
            grp = torch.where(ok, zero, grp)
        return torch.stack(out, 2)

    gains_fwd = scan_dir(sorted3)
    # reverse: walk the valid region from its end (position used-1-i)
    rev_idx = torch.clamp(
        used[..., None] - 1 - torch.arange(P, device=dev)[None, None, :],
        0, B - 1)
    gains_rev = scan_dir(torch.gather(
        sorted3, 3, rev_idx.expand(3, -1, -1, -1)))
    i_fwd = torch.argmax(gains_fwd, 2)
    i_rev = torch.argmax(gains_rev, 2)
    g_fwd = _take(gains_fwd, i_fwd, 2)
    g_rev = _take(gains_rev, i_rev, 2)

    # ---------------- the modes per feature, then across features (fwd
    # beats rev on ties: the reference replaces only on strictly greater)
    use_rev = g_rev > g_fwd
    g_feat = torch.where(onehot_allowed, g1,
                         torch.where(use_rev, g_rev, g_fwd))
    if cegb_delta is not None:
        g_feat = torch.where(torch.isfinite(g_feat), g_feat - cegb_delta,
                             g_feat)
    cfm = (cat_feature_mask[None, :] if cat_feature_mask.dim() == 1
           else cat_feature_mask)
    g_feat = torch.where(cfm, g_feat, neg_inf)
    f_best = torch.argmax(g_feat, 1)                   # [S]
    gain = _take(g_feat, f_best, 1)
    valid = torch.isfinite(gain)

    def take(a):
        return _take(a, f_best, 1)

    def take_b(a):                                     # [S, F, B] -> [S, B]
        return torch.gather(a, 1, f_best[:, None, None].expand(S, 1, B))[:, 0]
    is_onehot = onehot_allowed[0][f_best]
    # the left set over bins [S, B]: one bin, or the first i_fwd + 1 /
    # last i_rev + 1 of the sorted candidates
    rank = torch.empty_like(order).scatter_(
        2, order, torch.arange(B, device=dev).expand(S, F, B))
    rank_b = take_b(rank)
    okb_b = take_b(ok_bin)
    mask_fwd = okb_b & (rank_b <= take(i_fwd)[:, None])
    mask_rev = okb_b & (rank_b >= (take(used) - 1 - take(i_rev))[:, None])
    mask_sorted = torch.where(take(use_rev)[:, None], mask_rev, mask_fwd)
    mask_onehot = torch.arange(B, device=dev)[None, :] == take(t1)[:, None]
    cat_mask = torch.where(is_onehot[:, None], mask_onehot, mask_sorted) \
        & valid[:, None]

    # the winner's left and right sums
    lg = torch.where(cat_mask, take_b(grad), zero).sum(1)
    lh = torch.where(cat_mask, take_b(hess), zero).sum(1) + eps
    lc = torch.where(cat_mask, take_b(cnt), zero).sum(1)
    rg = take(tot_g) - lg
    rh = take(tot_h) - lh - eps
    rc = take(tot_c) - lc
    l2_out = torch.where(is_onehot, torch.full((), p.lambda_l2, device=dev),
                         torch.full((), l2_cat, device=dev))
    left_out = calculate_leaf_output(lg, lh, p, lc, parent_output, l2_out)
    right_out = calculate_leaf_output(rg, rh, p, rc, parent_output, l2_out)
    return BestSplit(
        feature=torch.where(valid, f_best.to(torch.int32),
                            torch.full_like(f_best, -1, dtype=torch.int32)),
        threshold=torch.zeros(S, dtype=torch.int32, device=dev),
        default_left=torch.zeros(S, dtype=torch.bool, device=dev),
        gain=torch.where(valid, gain - take(min_gain_shift), neg_inf),
        left_output=left_out,
        right_output=right_out,
        left_sum_grad=lg, left_sum_hess=lh - eps, left_count=lc,
        right_sum_grad=rg, right_sum_hess=rh, right_count=rc,
        cat_flag=valid,
        cat_mask=cat_mask,
    )


def best_split_cm(grad, hess, cnt, num_bin_per_feat, missing_type,
                  default_bin, feature_mask, is_cat, params: SplitParams,
                  parent_output, cat_idx=None, monotone=None, bound_lo=None,
                  bound_hi=None, leaf_depth=None, cegb_delta=None,
                  bound_lo_plane=None, bound_hi_plane=None) -> BestSplit:
    """Combined numerical + categorical best split per slot (the JAX
    package's ``best_split_cm``, ``lightgbm_tpu/ops/split.py:627-668``;
    FindBestThreshold's dispatch on bin_type, ref:
    feature_histogram.hpp:85). ``cat_idx`` (the categorical features'
    indices, None when there are none: the JAX package's static
    ``has_cat``) turns on the categorical scan; a categorical winner takes
    the slot where its gain is strictly greater. Without it the result's
    categorical fields are None. ``monotone``, the bounds, the bound
    planes (numerical features only) and ``cegb_delta`` as for
    :func:`best_numerical_split_cm`; under bounds a categorical winner's
    outputs are clipped too (the JAX package's winner-level clamp)."""
    ic = is_cat[None, :] if feature_mask.dim() == 2 else is_cat
    num = best_numerical_split_cm(
        grad, hess, cnt, num_bin_per_feat, missing_type, default_bin,
        feature_mask & ~ic, params, parent_output, monotone=monotone,
        bound_lo=bound_lo, bound_hi=bound_hi, leaf_depth=leaf_depth,
        cegb_delta=cegb_delta, bound_lo_plane=bound_lo_plane,
        bound_hi_plane=bound_hi_plane)
    if cat_idx is None:
        return num
    cat = best_categorical_split_cm(
        grad, hess, cnt, num_bin_per_feat, feature_mask & ic, params,
        parent_output, cat_idx=cat_idx, cegb_delta=cegb_delta)
    if bound_lo is not None:
        cat = cat._replace(
            left_output=torch.clamp(cat.left_output, bound_lo, bound_hi),
            right_output=torch.clamp(cat.right_output, bound_lo, bound_hi))
    use_cat = cat.gain > num.gain
    num = num._replace(cat_flag=torch.zeros_like(cat.cat_flag),
                       cat_mask=torch.zeros_like(cat.cat_mask))
    return map_split(lambda a, b: torch.where(
        use_cat if a.dim() == 1 else use_cat[:, None], a, b), cat, num)
