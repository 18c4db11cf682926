"""Best-split search over histogram planes, on the device.

PyTorch counterpart of ``lightgbm_tpu/ops/split.py`` (numerical branch):
the reference's per-(leaf, feature) sequential threshold scan (ref:
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

Categorical splits, monotone bounds and CEGB are not ported yet.
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
    """Numerical split-finding hyper-parameters (the subset of the JAX
    package's SplitParams that its numerical scan reads)."""
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    max_delta_step: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    path_smooth: float = 0.0


def threshold_l1(s, l1):
    # ref: feature_histogram.hpp:737 ThresholdL1
    reg = torch.clamp(torch.abs(s) - l1, min=0.0)
    return torch.sign(s) * reg


def calculate_leaf_output(sum_grad, sum_hess, p: SplitParams,
                          num_data=None, parent_output=0.0):
    """Closed-form Newton leaf value
    (ref: feature_histogram.hpp:742 CalculateSplittedLeafOutput)."""
    ret = -threshold_l1(sum_grad, p.lambda_l1) / (sum_hess + p.lambda_l2)
    if p.max_delta_step > 0:
        ret = torch.clamp(ret, -p.max_delta_step, p.max_delta_step)
    if p.path_smooth > 0 and num_data is not None:
        n_s = num_data / p.path_smooth
        ret = ret * n_s / (n_s + 1.0) + parent_output / (n_s + 1.0)
    return ret


def leaf_gain_given_output(sum_grad, sum_hess, p: SplitParams, output):
    # ref: feature_histogram.hpp:846 GetLeafGainGivenOutput
    sg = threshold_l1(sum_grad, p.lambda_l1)
    return -(2.0 * sg * output + (sum_hess + p.lambda_l2) * output * output)


def leaf_gain(sum_grad, sum_hess, p: SplitParams, num_data=None,
              parent_output=0.0):
    # ref: feature_histogram.hpp:828 GetLeafGain
    if p.max_delta_step <= 0 and p.path_smooth <= 0:
        sg = threshold_l1(sum_grad, p.lambda_l1)
        return (sg * sg) / (sum_hess + p.lambda_l2)
    out = calculate_leaf_output(sum_grad, sum_hess, p, num_data,
                                parent_output)
    return leaf_gain_given_output(sum_grad, sum_hess, p, out)


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


def _take(a: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.gather(a, dim, idx.unsqueeze(dim)).squeeze(dim)


def best_numerical_split_cm(grad: torch.Tensor, hess: torch.Tensor,
                            cnt: torch.Tensor, num_bin_per_feat: torch.Tensor,
                            missing_type: torch.Tensor,
                            default_bin: torch.Tensor,
                            feature_mask: torch.Tensor, params: SplitParams,
                            parent_output: torch.Tensor) -> BestSplit:
    """Best numerical split per slot from channel-major planes.

    Args:
      grad/hess/cnt: ``[S, F, B]`` float32 histogram planes.
      num_bin_per_feat: ``[F]`` int32 actual bin counts (rest is padding).
      missing_type: ``[F]`` int32 (0 none / 1 zero / 2 nan).
      default_bin: ``[F]`` int32 (bin of value 0; the zero-missing bin).
      feature_mask: ``[F]`` or ``[S, F]`` bool.
      parent_output: ``[S]`` f32 leaf outputs (for path smoothing).
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
        gains = (leaf_gain(left_g, left_h, p, left_c, parent_out)
                 + leaf_gain(right_g, right_h, p, right_c, parent_out))
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

    # across features: first feature wins ties (argmax picks first max)
    f_best = torch.argmax(g_best, 1)                                 # [S]
    gain = _take(g_best, f_best, 1)
    lg, lh, lc, rg, rh, rc = [_take(a, f_best, 1) for a in stats]
    valid = torch.isfinite(gain)

    left_out = calculate_leaf_output(lg, lh, p, lc, parent_output)
    right_out = calculate_leaf_output(rg, rh, p, rc, parent_output)
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
    )


def best_split_cm(grad, hess, cnt, num_bin_per_feat, missing_type,
                  default_bin, feature_mask, is_cat, params: SplitParams,
                  parent_output) -> BestSplit:
    """Numerical best split per slot, with categorical features masked out
    (the JAX package's combined scan; its categorical half is not ported
    yet, so ``is_cat`` features are never chosen)."""
    ic = is_cat[None, :] if feature_mask.dim() == 2 else is_cat
    return best_numerical_split_cm(
        grad, hess, cnt, num_bin_per_feat, missing_type, default_bin,
        feature_mask & ~ic, params, parent_output)
