"""Gradient boosting driver on the fused engine.

PyTorch counterpart of ``lightgbm_tpu/boosting/gbdt.py`` on its main
training path — the serial learner's per-iteration body of the fast step
and the megastep (``GBDT._make_fused_tree_loop``): gradients from the
scores, ``pack_gh``, ``grow_tree_fused``, ``tree_score_delta``. The
megastep's ``lax.scan`` is a plain Python loop over iterations here.

Layout (``_init_fused``): the binned matrix transposed to ``bins_T``
[Fp=max(F_oh, 8), Rp] with Rp rounded up to 2048, int8 for Bp <= 128 and
int16 above; padded rows sit at leaf -1 and carry zero gradients.

Not ported yet (they raise or are absent): bagging, feature_fraction,
init scores, valid sets, callbacks, multiclass, categorical features, EFB, quantized
gradients, adaptive bins, screening, monotone and interaction constraints,
distributed learners, DART/GOSS/RF.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..config import Config
from ..dataset import BinnedDataset
from ..models.frontier2 import grow_tree_fused, tree_score_delta
from ..models.learner import FeatureMeta
from ..models.tree import HostTree, TreeArrays
from ..ops.fused_level import NCH_FAST, NCH_PRECISE, pack_gh
from ..ops.layout import feature_layout
from ..ops.split import SplitParams
from ..utils import log

K_EPSILON = 1e-15
ROW_BLOCK = 2048   # Rp granularity (the JAX package's widest kernel tile)


def split_params_from_config(config: Config) -> SplitParams:
    return SplitParams(
        lambda_l1=float(config.lambda_l1),
        lambda_l2=float(config.lambda_l2),
        max_delta_step=float(config.max_delta_step),
        min_data_in_leaf=int(config.min_data_in_leaf),
        min_sum_hessian_in_leaf=float(config.min_sum_hessian_in_leaf),
        min_gain_to_split=float(config.min_gain_to_split),
        path_smooth=float(config.path_smooth))


_UNPORTED = (
    ("boosting", lambda v: v != "gbdt", "boosting types other than gbdt"),
    ("tree_learner", lambda v: v != "serial", "distributed tree learners"),
    ("num_class", lambda v: int(v) != 1, "multiclass"),
    ("bagging_freq", lambda v: int(v) > 0, "bagging"),
    ("feature_fraction", lambda v: float(v) < 1.0, "feature_fraction"),
    ("feature_fraction_bynode", lambda v: float(v) < 1.0,
     "feature_fraction_bynode"),
    ("interaction_constraints", bool, "interaction constraints"),
    ("linear_tree", bool, "linear trees"),
    ("tpu_quantized_grad", lambda v: int(v) != 0, "quantized gradients"),
    ("tpu_adaptive_bins", bool, "adaptive bins"),
    ("tpu_gain_screening", bool, "gain screening"),
    ("forcedsplits_filename", bool, "forced splits"),
    ("cegb_penalty_split", lambda v: float(v) != 0.0, "CEGB"),
    ("cegb_penalty_feature_lazy", bool, "CEGB"),
    ("cegb_penalty_feature_coupled", bool, "CEGB"),
)


class GBDT:
    """Boosting state on one device (ref: src/boosting/gbdt.cpp)."""

    def init(self, config: Config, train_data: BinnedDataset,
             objective) -> None:
        for key, bad, what in _UNPORTED:
            if bad(getattr(config, key)):
                log.fatal("%s is not ported to lightgbm_tpu_torch yet "
                          "(%s=%r)", what, key, getattr(config, key))
        self.config = config
        self.train_data = train_data
        self.objective = objective
        self.device = train_data.device
        self.num_data = train_data.num_data
        self.num_tree_per_iteration = 1
        self.shrinkage_rate = float(config.learning_rate)
        self.max_leaves = max(2, int(config.num_leaves))
        self.max_bins = int(train_data.max_num_bin)
        self.params = split_params_from_config(config)
        self.models: List[HostTree] = []
        self.scores = torch.zeros((1, self.num_data), dtype=torch.float32,
                                  device=self.device)
        self._init_fused(train_data)

    def _init_fused(self, train_data: BinnedDataset) -> None:
        """Transposed, padded bin matrix + f_oh-padded feature metadata for
        the fused level kernels (gbdt.py _init_fused, unbundled
        single-process branch)."""
        F = train_data.num_features
        F_oh, Bp = feature_layout(F, self.max_bins)
        R = self.num_data
        Rp = ((R + ROW_BLOCK - 1) // ROW_BLOCK) * ROW_BLOCK
        Fp = max(F_oh, 8)
        # int8 covers bins <= 127; larger max_bin needs int16
        dtype = torch.int8 if Bp <= 128 else torch.int16
        bins_T = torch.zeros((Fp, Rp), dtype=dtype, device=self.device)
        if F:
            bins_T[:F, :R] = train_data.bins_dev.t().to(dtype)
        self.fused_bins_T = bins_T
        self.fused_f_oh = F_oh
        self.fused_Bp = Bp
        self.fused_Rp = Rp
        self.fused_nch = (NCH_FAST if self.config.tpu_hist_precision == "bf16"
                          else NCH_PRECISE)

        def pad(a):
            out = np.zeros(F_oh, np.int32)
            out[:F] = a
            return torch.as_tensor(out, device=self.device)
        self.fused_meta = FeatureMeta(
            num_bin=pad(train_data.num_bin_per_feat),
            missing_type=pad(train_data.missing_types),
            default_bin=pad(train_data.default_bins()),
            monotone=pad(np.zeros(F, np.int32)))
        self.fused_fmask = torch.arange(F_oh, device=self.device) < F

    # ------------------------------------------------------------------
    def _boost_from_average(self) -> float:
        """(ref: gbdt.cpp:346 BoostFromAverage) — first iteration only."""
        cfg = self.config
        if self.models or self.objective is None:
            return 0.0
        if not (cfg.boost_from_average or self.train_data.num_features == 0):
            return 0.0
        init_score = self.objective.boost_from_score(0)
        if abs(init_score) > K_EPSILON:
            self.scores[0] += torch.tensor(init_score, dtype=torch.float32)
            log.info("Start training from score %f", init_score)
            return init_score
        return 0.0

    def grow_one(self) -> Tuple[TreeArrays, torch.Tensor]:
        """One tree from the current scores: gradients, gh pack, fused
        growth, score delta (the serial branch of the JAX package's
        ``_make_fused_tree_loop``). Returns (tree, score delta [n])."""
        n = self.num_data
        pad = self.fused_Rp - n
        grad, hess = self.objective.get_gradients(self.scores)
        # every row is in the bag (bagging is not ported): weight 1, and 0
        # on the padding rows
        w = torch.ones(n, dtype=torch.float32, device=self.device)
        gh_T = pack_gh(*[torch.nn.functional.pad(x, (0, pad))
                         for x in (grad[0], hess[0], w)], self.fused_nch)
        tree, row_leaf = grow_tree_fused(
            self.fused_bins_T, gh_T, self.fused_meta, self.fused_fmask,
            self.params, self.max_leaves, self.fused_Bp, self.fused_f_oh,
            num_rows=n, nch=self.fused_nch,
            max_depth=int(self.config.max_depth),
            extra_levels=int(self.config.tpu_extra_levels))
        delta = tree_score_delta(tree, row_leaf, self.shrinkage_rate,
                                 num_rows=n)
        return tree, delta

    def train_one_iter(self) -> bool:
        """One boosting iteration; True when training must stop (no split
        met the requirements — ref: gbdt.cpp:421-445)."""
        if self.objective is None:
            log.fatal("lightgbm_tpu_torch trains with a built-in objective "
                      "only (custom gradients are not ported yet)")
        init_score = self._boost_from_average()
        tree, delta = self.grow_one()
        if tree.num_leaves <= 1:
            if not self.models:
                # the reference keeps one constant tree carrying the init
                # score and adds it to the scorer a second time
                # (gbdt.cpp:377,433; matched by the JAX package)
                ht = HostTree(1)
                ht.leaf_value[0] = init_score
                self.scores[0] += torch.tensor(init_score,
                                               dtype=torch.float32)
                self.models.append(ht)
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            return True
        self.scores[0] += delta
        ht = self._to_host_tree(tree)
        ht.apply_shrinkage(self.shrinkage_rate)
        if abs(init_score) > K_EPSILON:
            ht.add_bias(init_score)
        self.models.append(ht)
        return False

    # ------------------------------------------------------------------
    def _to_host_tree(self, tree: TreeArrays) -> HostTree:
        """Device TreeArrays -> HostTree with real thresholds
        (gbdt.py _to_host_tree, numerical splits)."""
        ds = self.train_data
        nl = int(tree.num_leaves)
        ni = max(0, nl - 1)
        host = {k: v.cpu().numpy() for k, v in tree._asdict().items()
                if isinstance(v, torch.Tensor)}
        ht = HostTree(nl, shrinkage=1.0)
        sf_inner = host["split_feature"][:ni]
        tb = host["threshold_bin"][:ni]
        dl = host["default_left"][:ni]
        ht.split_feature = np.array(
            [ds.real_feature_index(int(f)) if f >= 0 else 0
             for f in sf_inner], np.int32)
        thr = np.zeros(ni, np.float64)
        dt = np.zeros(ni, np.int32)
        for i in range(ni):
            f = int(sf_inner[i])
            if f < 0:
                continue
            m = ds.mappers[ds.real_feature_index(f)]
            thr[i] = m.bin_to_value(int(tb[i]))
            dt[i] = HostTree.make_decision_type(False, bool(dl[i]),
                                                int(m.missing_type))
        ht.threshold = thr
        ht.threshold_bin = tb.astype(np.int32)
        ht.decision_type = dt
        ht.left_child = host["left_child"][:ni].astype(np.int32)
        ht.right_child = host["right_child"][:ni].astype(np.int32)
        ht.split_gain = host["split_gain"][:ni].astype(np.float64)
        ht.internal_value = host["internal_value"][:ni].astype(np.float64)
        ht.internal_weight = host["internal_weight"][:ni].astype(np.float64)
        ht.internal_count = host["internal_count"][:ni].astype(np.int64)
        ht.leaf_value = host["leaf_value"][:nl].astype(np.float64)
        ht.leaf_weight = host["leaf_weight"][:nl].astype(np.float64)
        ht.leaf_count = host["leaf_count"][:nl].astype(np.int64)
        ht.leaf_depth = host["leaf_depth"][:nl].astype(np.int32)
        return ht
