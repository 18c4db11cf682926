"""Gradient boosting driver on the fused and frontier-v1 engines.

PyTorch counterpart of ``lightgbm_tpu/boosting/gbdt.py`` on its main
training path, the serial learner. ``tpu_engine`` picks the engine as the
JAX package resolves it (``gbdt.py:1956-2037``), with only the branches
the port can take: ``auto`` and ``fused`` train the fused engine,
``frontier`` the frontier-v1 engine (with ``tpu_histogram_impl`` auto or
pallas), and anything else raises, naming what is not ported.

The fused engine has two iteration bodies, as in the JAX package:

- the **megastep body** (``_fused_iter_body``; the JAX package's
  ``_make_fused_tree_loop``, whose ``lax.scan`` is a plain Python loop over
  iterations here): gradients from the scores, times the bag weights,
  ``pack_gh``, ``grow_tree_fused``, ``tree_score_delta``. ``engine.train``
  arms it while ``tpu_megastep`` is true (the default), as the JAX
  ``engine.train`` does on the TPU;
- the **epilogue body** (``_epi_iter_body``; the JAX package's
  ``_epi_iter_body``): the tree grows from the carried root histogram and
  packed gradients, its final route is deferred, and one ``epilogue_pass``
  routes, updates the scores and builds the next iteration's gradients and
  root histogram. A bare ``Booster.update()`` takes it, and so does
  ``train()`` with ``tpu_megastep=False``, wherever ``_use_epilogue()``
  holds (binary or L2, ``tpu_fused_epilogue``, one tree per iteration);
  the megastep body otherwise.

The frontier-v1 engine has one (``_frontier_iter_body``; the serial,
single-class branch of the JAX package's ``_sync_iter_body``): gradients,
``gh3 = [g*bag, h*bag, bag]``, ``grow_tree_frontier``, the host tree, its
shrinkage applied in float64 on the host, and an f32 copy of the shrunk
leaf values added to the scores through the per-row lookup. That order
differs from the fused bodies' f32 ``leaf_value * shrinkage`` in the last
bits (the JAX package's ``gbdt.py:3162-3164``), so each engine keeps its
own. Neither the megastep nor the epilogue applies to it.

Caller-given gradients (``train_one_iter(gradients, hessians)``, what
``Booster.update(fobj=...)`` feeds) take the body of the JAX package's
``_sync_iter_body``: on the fused engine one ``grow_tree_fused`` with the
final route, the host tree's shrunk leaf values added to the scores
through ``table_lookup``; on the frontier engine its own body. No
``boost_from_average`` then.

Valid sets (``add_valid_data``) keep f32 scores ``[1, n]`` on the device,
updated per tree body by body as in the JAX package: the megastep and
epilogue bodies route each valid row through the device ``TreeArrays``
and add ``leaf_value * shrinkage`` in f32 (``_make_valid_apply``); the
frontier and caller-gradient bodies add the host tree's shrunk values
(``_add_tree_to_score``). ``eval_metric_set`` evaluates a set's metrics on
the device where the metric has a device form and on a float64 host copy
otherwise. Init scores (``Metadata.init_score``) seed the training and
valid scores, and ``boost_from_average`` is then skipped.

Bagging (balanced bagging included) and per-tree feature_fraction draw
from the reference's LCG streams (``utils/random.py``) in the JAX
package's order; the epilogue body draws the next round's bag one
iteration ahead without changing that order.

Layouts: ``_init_fused`` transposes the binned matrix to ``bins_T``
[Fp=max(F_oh, 8), Rp] with Rp rounded up to 2048, int8 for Bp <= 128 and
int16 above (padded rows sit at leaf -1 and carry zero gradients);
``_init_frontier`` keeps it row-major, ``bins_i32`` [num_data, Fp] int32,
with no row padding.

The histogram-plane cuts (``gbdt.py:2107-2161`` of the JAX package) run on
the fused engine's megastep body, alone or together:
``tpu_quantized_grad`` 8 or 16 (``pack_gh_quant`` with the dither seed of
``_quant_seed``; int32 histograms), ``tpu_adaptive_bins`` (``bins_T``'s rows
permuted into a ``PackedLayout``) and ``tpu_gain_screening`` (a per-tree
top-k mask over an EMA of realized split gains, composed with the
feature_fraction mask and applied in the kernel). The epilogue body does
not take them (its kernel is f32 and padded), and on the frontier engine
they are dropped with a log line, as in the JAX package.

Not ported yet (they raise or are absent): GOSS, feature_fraction_bynode,
multiclass, categorical features, EFB, monotone and interaction
constraints, distributed learners, DART/RF, resilience checkpoints.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..dataset import BinnedDataset
from ..models.frontier import grow_tree_frontier, leaf_value_lookup
from ..models.frontier2 import grow_tree_fused, level_caps, tree_score_delta
from ..models.learner import FeatureMeta
from ..models.tree import HostTree, TreeArrays
from ..ops.fused_level import (NCH_FAST, NCH_PRECISE, epilogue_pass,
                               max_slot_cap, pack_gh, pack_gh_quant,
                               table_lookup)
from ..ops.layout import feature_layout, packed_feature_layout
from ..ops.pallas_histogram import pad_feature_layout
from ..ops.predict import add_tree_score, tree_depth
from ..ops.quantize import QNCH
from ..ops.split import SplitParams
from ..utils import log
from ..utils import random as ref_random

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
    ("feature_fraction_bynode", lambda v: float(v) < 1.0,
     "feature_fraction_bynode"),
    ("interaction_constraints", bool, "interaction constraints"),
    ("linear_tree", bool, "linear trees"),
    ("forcedsplits_filename", bool, "forced splits"),
    ("cegb_penalty_split", lambda v: float(v) != 0.0, "CEGB"),
    ("cegb_penalty_feature_lazy", bool, "CEGB"),
    ("cegb_penalty_feature_coupled", bool, "CEGB"),
)


class GBDT:
    """Boosting state on one device (ref: src/boosting/gbdt.cpp)."""

    def init(self, config: Config, train_data: BinnedDataset,
             objective, training_metrics: Sequence = ()) -> None:
        self._check_ported(config)
        self.config = config
        self.train_data = train_data
        self.objective = objective
        self.training_metrics = list(training_metrics)
        self.device = train_data.device
        self.num_data = train_data.num_data
        self.num_tree_per_iteration = 1
        self.shrinkage_rate = float(config.learning_rate)
        self.max_leaves = max(2, int(config.num_leaves))
        self.max_bins = int(train_data.max_num_bin)
        self.params = split_params_from_config(config)
        self.models: List[HostTree] = []
        self.iter = 0
        md = train_data.metadata
        self.has_init_score = md.init_score is not None
        self.scores = self._initial_scores(md, self.num_data)
        self.valid_data: List[BinnedDataset] = []
        self.valid_scores: List[torch.Tensor] = []   # [1, n_valid] f32
        self.valid_metrics: List[List] = []
        self.valid_names: List[str] = []
        self._setup_engine(config, train_data)
        self._megastep_armed = False
        # epilogue body: (score [1, Rp], root hist, gh_T) carried to the
        # next iteration; None = the next iteration primes
        self._epi_carry = None
        self._epi_spec = (objective.epilogue_spec()
                          if objective is not None else None)
        self._epi_ops = None

        # bagging state (ref: gbdt.cpp:686-758 ResetBaggingConfig;
        # utils/random.h LCG, gbdt.cpp:804 per-block bagging generators,
        # col_sampler.hpp:26 by-tree stream)
        n = self.num_data
        self.bag_streams = ref_random.BlockBaggingStreams(
            int(config.bagging_seed), n)
        self._bag_round_cache = {}
        self.feat_rng = ref_random.Random(int(config.feature_fraction_seed))
        self.balanced_bagging = False
        self.is_bagging = False
        if config.bagging_freq > 0:
            if config.bagging_fraction < 1.0:
                self.is_bagging = True
            elif (objective is not None and objective.name == "binary"
                  and (config.pos_bagging_fraction < 1.0
                       or config.neg_bagging_fraction < 1.0)):
                self.is_bagging = True
                self.balanced_bagging = True
        self.bag_weight = torch.ones(n, dtype=torch.float32,
                                     device=self.device)   # 1 = in the bag
        self.bag_cnt = n

    @staticmethod
    def _check_ported(config: Config) -> None:
        for key, bad, what in _UNPORTED:
            if bad(getattr(config, key)):
                log.fatal("%s is not ported to lightgbm_tpu_torch yet "
                          "(%s=%r)", what, key, getattr(config, key))

    def _initial_scores(self, md, n: int) -> torch.Tensor:
        """[1, n] f32 scores: the init score where one is set, else 0."""
        if md is None or md.init_score is None:
            return torch.zeros((1, n), dtype=torch.float32,
                               device=self.device)
        init = np.asarray(md.init_score, np.float64)
        if init.size != n:
            log.fatal("init_score has %d values for %d rows (multiclass "
                      "init scores are not ported yet)", init.size, n)
        return torch.as_tensor(init.reshape(1, n).astype(np.float32),
                               device=self.device)

    def add_valid_data(self, valid_data: BinnedDataset, name: str,
                       metrics: Sequence) -> None:
        """A validation set binned with the training mappers: its f32
        scores (from its init score, then every tree trained so far
        replayed onto it) and its metrics (ref: gbdt.cpp
        AddValidDataset)."""
        self._epi_carry = None
        self.valid_data.append(valid_data)
        score = self._initial_scores(valid_data.metadata,
                                     valid_data.num_data)
        for ht in self.models:
            score[0] = self._add_host_tree(score[0], valid_data.bins_dev, ht)
        self.valid_scores.append(score)
        self.valid_metrics.append(list(metrics))
        self.valid_names.append(name)

    def _setup_engine(self, config: Config,
                      train_data: BinnedDataset) -> None:
        """Resolve ``tpu_engine`` (gbdt.py:1956-2037, the branches the port
        can take) and build that engine's layout. Never falls back."""
        engine = str(config.tpu_engine)
        if engine == "xla":
            log.fatal("tpu_engine=xla (the XLA growers of models/learner.py "
                      "and the XLA histograms of ops/histogram.py) is not "
                      "ported to lightgbm_tpu_torch yet")
        if engine == "frontier" \
                and config.tpu_histogram_impl not in ("auto", "pallas"):
            log.fatal("tpu_engine=frontier with tpu_histogram_impl=%s needs "
                      "the XLA histograms of ops/histogram.py, which are not "
                      "ported to lightgbm_tpu_torch yet",
                      config.tpu_histogram_impl)
        if engine not in ("auto", "fused", "frontier"):
            log.fatal("unknown tpu_engine=%r (auto, fused, frontier or xla)",
                      engine)
        self.use_frontier = engine == "frontier"
        self._setup_plane_cuts(config)
        if self.use_frontier:
            self._init_frontier(train_data)
        else:
            self._init_fused(train_data)

    def _setup_plane_cuts(self, config: Config) -> None:
        """The histogram-plane cuts (gbdt.py:2107-2161): fused-engine
        features, each gated on its own; the frontier engine drops them
        and trains unchanged."""
        qb = int(config.tpu_quantized_grad or 0)
        if qb not in (0, 8, 16):
            log.fatal("tpu_quantized_grad must be 0, 8 or 16; got %s", qb)
        adaptive = bool(config.tpu_adaptive_bins)
        scr = bool(config.tpu_gain_screening)
        if self.use_frontier and (qb or adaptive or scr):
            log.info("tpu_quantized_grad, tpu_adaptive_bins and "
                     "tpu_gain_screening require the fused engine; "
                     "training without them")
            qb, adaptive, scr = 0, False, False
        self.quant_bits = qb
        self.use_adaptive_bins = adaptive
        self.use_screening = scr

    def _init_frontier(self, train_data: BinnedDataset) -> None:
        """Feature-padded int32 row-major bin matrix and padded feature
        metadata for the frontier-v1 grower (gbdt.py _init_frontier; the
        transposed copy is not kept, routing gathers from this one)."""
        F = train_data.num_features
        Fp, Bp = pad_feature_layout(F, self.max_bins)
        self.frontier_Fp = Fp
        self.frontier_Bp = Bp
        bins = torch.zeros((self.num_data, Fp), dtype=torch.int32,
                           device=self.device)
        if F:
            bins[:, :F] = train_data.bins_dev.to(torch.int32)
        self.bins_i32 = bins
        # pad features are trivial (num_bin 2) and never selected
        self.frontier_meta = self._padded_meta(train_data, Fp, 2)

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
        self.fused_packed = None
        if F:
            src = train_data.bins_dev.t()
            if self.use_adaptive_bins:
                # each feature's slab at its own pow2 width, bins_T's rows
                # in the layout's width-class order (the logical order
                # comes back at the plane decode)
                self.fused_packed = packed_feature_layout(
                    train_data.num_bin_per_feat, self.max_bins, f_oh=F_oh)
                src = src[list(self.fused_packed.feat_order)]
            bins_T[:src.shape[0], :R] = src.to(dtype)
        self.fused_bins_T = bins_T
        self.fused_f_oh = F_oh
        self.fused_Bp = Bp
        self.fused_Rp = Rp
        if self.quant_bits:      # the quantized channel layout overrides
            self.fused_nch = QNCH[self.quant_bits]
        elif self.config.tpu_hist_precision == "bf16":
            self.fused_nch = NCH_FAST
        else:
            self.fused_nch = NCH_PRECISE
        self.fused_meta = self._padded_meta(train_data, F_oh, 0)
        # gain screening: the EMA of each feature's realized split gains
        self._gain_ema = torch.zeros(F_oh, dtype=torch.float32,
                                     device=self.device)

    def _padded_meta(self, train_data: BinnedDataset, width: int,
                     pad_num_bin: int) -> FeatureMeta:
        """Feature metadata padded to the engine's feature width, padding
        features at ``pad_num_bin`` bins; sets ``fmask_full``, the mask of
        the real features."""
        F = train_data.num_features

        def pad(a, fill=0):
            out = np.full(width, fill, np.int32)
            out[:F] = a
            return torch.as_tensor(out, device=self.device)
        self.fmask_full = torch.arange(width, device=self.device) < F
        return FeatureMeta(
            num_bin=pad(train_data.num_bin_per_feat, pad_num_bin),
            missing_type=pad(train_data.missing_types),
            default_bin=pad(train_data.default_bins()),
            monotone=pad(np.zeros(F, np.int32)))

    # ------------------------------------------------------------------
    def _boost_from_average(self) -> float:
        """(ref: gbdt.cpp:346 BoostFromAverage) — first iteration only,
        and not over init scores."""
        cfg = self.config
        if self.models or self.has_init_score or self.objective is None:
            return 0.0
        if not (cfg.boost_from_average or self.train_data.num_features == 0):
            return 0.0
        init_score = self.objective.boost_from_score(0)
        if abs(init_score) > K_EPSILON:
            self._add_constant(init_score)
            log.info("Start training from score %f", init_score)
            return init_score
        return 0.0

    def _add_constant(self, value: float) -> None:
        """Add ``value`` (as f32) to the training and every valid score."""
        c = torch.tensor(value, dtype=torch.float32)
        self.scores[0] += c
        for vs in self.valid_scores:
            vs[0] += c

    # ---------------------------------------------------- bagging, columns
    def _bag_mask_for(self, it: int) -> np.ndarray:
        """In-bag mask [n] bool effective at iteration ``it``. Rounds fire
        at iterations where it % bagging_freq == 0 and are drawn in stream
        order on first sight, cached by firing iteration (the two most
        recent kept): the epilogue body asks one round ahead, and a
        rollback within the window replays the round it used."""
        cfg = self.config
        fire = (it // cfg.bagging_freq) * cfg.bagging_freq
        cache = self._bag_round_cache
        if fire not in cache:
            # one float per row per round from the row's 1024-block LCG
            # stream (ref: gbdt.cpp:192 BaggingHelper), compared against
            # the double fraction like the reference's float-vs-double
            # promotion
            draws = self.bag_streams.next_floats().astype(np.float64)
            if self.balanced_bagging:
                frac = np.where(self.train_data.metadata.label > 0,
                                np.float64(cfg.pos_bagging_fraction),
                                np.float64(cfg.neg_bagging_fraction))
            else:
                frac = np.float64(cfg.bagging_fraction)
            cache[fire] = draws < frac
            for old in [key for key in cache
                        if key < fire - cfg.bagging_freq]:
                del cache[old]
        return cache[fire]

    def _bagging(self, it: int) -> None:
        """Renew the in-bag weights when a round fires at ``it`` (ref:
        gbdt.cpp:230 Bagging)."""
        cfg = self.config
        if not self.is_bagging or it % cfg.bagging_freq != 0:
            return
        mask = self._bag_mask_for(it)
        self.bag_cnt = int(mask.sum())
        self.bag_weight = torch.as_tensor(mask.astype(np.float32),
                                          device=self.device)
        log.debug("Re-bagging, using %d data to train", self.bag_cnt)

    def _bag_weight_for_iter(self, it: int) -> torch.Tensor:
        """[n] f32 in-bag weights effective at iteration ``it``, without
        touching the live ``bag_weight`` (the epilogue's lookahead)."""
        if not self.is_bagging:
            return torch.ones(self.num_data, dtype=torch.float32,
                              device=self.device)
        return torch.as_tensor(self._bag_mask_for(it).astype(np.float32),
                               device=self.device)

    def _feature_mask(self) -> np.ndarray:
        """Per-tree column sampling [F] bool (ref: col_sampler.hpp:20):
        Sample(F, RoundInt(F * fraction)) from one persistent LCG stream
        (col_sampler.hpp:33 GetCnt, :78 ResetByTree)."""
        F = self.train_data.num_features
        frac = float(self.config.feature_fraction)
        if frac >= 1.0:
            return np.ones(F, bool)
        k = max(ref_random.round_int(F * frac), min(1, F))
        mask = np.zeros(F, bool)
        mask[self.feat_rng.sample(F, k)] = True
        return mask

    def _feature_mask_pad(self) -> torch.Tensor:
        """This tree's feature mask padded to the engine's feature width
        (F_oh, or Fp on the frontier engine), on the device (no draw when
        feature_fraction is 1)."""
        if float(self.config.feature_fraction) >= 1.0:
            return self.fmask_full
        m = np.zeros(self.fmask_full.shape[0], bool)
        m[:self.train_data.num_features] = self._feature_mask()
        return torch.as_tensor(m, device=self.device)

    def _pad_rows(self, x: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.pad(x, (0, self.fused_Rp - self.num_data))

    # ------------------------------------------- histogram-plane cuts
    def _screening_keep_k(self) -> int:
        F = self.train_data.num_features
        ratio = float(self.config.tpu_screening_keep_ratio)
        return max(1, min(F, int(round(F * ratio))))

    def _screening_explore(self, it: int) -> bool:
        """Warm-up and exploration rounds keep every feature eligible, so a
        feature useless early but decisive late re-enters the mask."""
        cfg = self.config
        if it < int(cfg.tpu_screening_warmup):
            return True
        p = int(cfg.tpu_screening_explore_period)
        return p > 0 and it % p == 0

    def _screening_mask(self, explore: bool):
        """EMA-FS screening mask [F_oh] on the device (gbdt.py:148): the
        top ``keep_k`` real features by gain EMA, ties kept; None when
        every feature is eligible (an exploration round, or nothing to
        cut)."""
        F = self.train_data.num_features
        keep_k = self._screening_keep_k()
        if explore or F <= 0 or keep_k >= F:
            return None
        kth = torch.sort(self._gain_ema[:F]).values[F - keep_k]
        return self._gain_ema >= kth

    def screening_active_features(self) -> int:
        """How many features the gain EMA keeps eligible outside an
        exploration round (the JAX package's
        ``screening.active_features`` gauge); a host read."""
        F = self.train_data.num_features
        m = self._screening_mask(False) if self.use_screening else None
        return F if m is None else int(m[:F].sum())

    def _update_gain_ema(self, tree: TreeArrays) -> None:
        """Once per iteration, from the tree's realized split gains
        (gbdt.py:164, 3432-3438); unused nodes (feature -1, gain 0) add
        nothing."""
        sf = tree.split_feature
        sg = tree.split_gain.to(torch.float32)
        ok = (sf >= 0) & torch.isfinite(sg) & (sg > 0)
        F_oh = self._gain_ema.shape[0]
        gains = torch.zeros_like(self._gain_ema).index_add_(
            0, sf.clamp(0, F_oh - 1).long(), torch.where(ok, sg, 0.0))
        a = float(self.config.tpu_screening_ema_alpha)
        self._gain_ema = a * self._gain_ema + (1.0 - a) * gains

    def _quant_seed(self, it: int) -> int:
        """Stochastic-rounding dither seed of iteration ``it``'s (first)
        tree, the JAX package's stream, so identical reruns are
        byte-identical."""
        return (it * self.num_tree_per_iteration) & 0xFFFFFFFF

    # ------------------------------------------------------ iteration bodies
    def _grow(self, gh_T, fmask, root_hist=None, defer=False, scales=None):
        return grow_tree_fused(
            self.fused_bins_T, gh_T, self.fused_meta, fmask, self.params,
            self.max_leaves, self.fused_Bp, self.fused_f_oh,
            num_rows=self.num_data, nch=self.fused_nch,
            max_depth=int(self.config.max_depth),
            extra_levels=int(self.config.tpu_extra_levels),
            root_hist=root_hist, defer_final_route=defer,
            quant_bits=self.quant_bits, packed=self.fused_packed,
            mask_onehot=self.use_screening, gh_scales=scales)

    def arm_megastep(self, on: bool = True) -> None:
        """Permission from a training loop (``engine.train``) to run the
        megastep body; a bare ``Booster.update`` takes the epilogue body
        wherever it applies."""
        self._megastep_armed = bool(on)

    def _use_epilogue(self) -> bool:
        """The epilogue body applies: an objective with a closed form the
        kernel implements (binary, l2), ``tpu_fused_epilogue``, one tree
        per iteration (the serial learner is the only one ported), and no
        histogram-plane cut (its kernel builds f32 padded root histograms,
        and screening's mask must reach the next root; gbdt.py:3487)."""
        return bool(self._epi_spec is not None
                    and not self.use_frontier
                    and self.config.tpu_fused_epilogue
                    and self.num_tree_per_iteration == 1
                    and not self.quant_bits
                    and not self.use_adaptive_bins
                    and not self.use_screening)

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """One boosting iteration; True when training must stop (no split
        met the requirements — ref: gbdt.cpp:421-445). ``gradients`` and
        ``hessians`` ([n] each, from a custom objective) take the body of
        the JAX package's ``_sync_iter_body``."""
        if gradients is not None and hessians is not None:
            return self._caller_iter_body(gradients, hessians)
        if self.objective is None:
            log.fatal("Cannot train without an objective: pass a "
                      "built-in objective or supply gradients via "
                      "Booster.update(fobj=...)")
        if self.use_frontier:
            return self._frontier_iter_body()
        if not self._megastep_armed and self._use_epilogue():
            return self._epi_iter_body()
        self._epi_carry = None   # this body updates the scores in place
        return self._fused_iter_body()

    def _fused_iter_body(self) -> bool:
        """The megastep body: gradients from the scores, times the bag
        weights, gh pack (quantized under ``tpu_quantized_grad``), fused
        growth under the feature mask (and the screening mask), score
        delta, and the gain EMA's update (the serial branch of the JAX
        package's ``_make_fused_tree_loop``, ``grow_k_trees``)."""
        n = self.num_data
        init_score = self._boost_from_average()
        self._bagging(self.iter)
        fmask = self._tree_feature_mask()
        grad, hess = self.objective.get_gradients(self.scores)
        w = self.bag_weight
        gh_T, scales = self._pack(grad[0] * w, hess[0] * w, w)
        tree, row_leaf = self._grow(gh_T, fmask, scales=scales)
        if self.use_screening:
            self._update_gain_ema(tree)
        stop = self._finish_iter(tree, init_score)
        if not stop:
            self.scores[0] += tree_score_delta(tree, row_leaf,
                                               self.shrinkage_rate,
                                               num_rows=n)
        return stop

    def _frontier_iter_body(self, grad=None, hess=None) -> bool:
        """The frontier-v1 engine's body (the serial, single-class branch
        of the JAX package's ``_sync_iter_body``): gradients (the
        objective's, or the caller's [1, n]), bagging, gh3,
        ``grow_tree_frontier``; the score update follows the host tree's
        float64 shrinkage (``_finish_iter``)."""
        init_score = 0.0
        if grad is None:
            init_score = self._boost_from_average()
        self._bagging(self.iter)
        if grad is None:
            grad, hess = self.objective.get_gradients(self.scores)
        w = self.bag_weight
        gh3 = torch.stack([grad[0] * w, hess[0] * w, w], 1)
        tree, row_leaf = grow_tree_frontier(
            self.bins_i32, gh3, self.frontier_meta, self._feature_mask_pad(),
            self.params, self.max_leaves, self.frontier_Bp,
            int(self.config.max_depth))
        return self._finish_iter(
            tree, init_score, row_leaf,
            lambda lv, rl: leaf_value_lookup(lv, rl, self.max_leaves))

    def _caller_iter_body(self, gradients, hessians) -> bool:
        """Caller-given gradients (``_sync_iter_body`` of the JAX package):
        no boost from average, the bag weights applied, then on the fused
        engine one ``grow_tree_fused`` with its final route and the host
        tree's shrunk leaf values added through ``table_lookup``."""
        self._epi_carry = None   # the scores change outside the carry
        n = self.num_data

        def dev(a):
            return torch.as_tensor(
                np.asarray(a, np.float32).reshape(1, n), device=self.device)
        grad, hess = dev(gradients), dev(hessians)
        if self.use_frontier:
            return self._frontier_iter_body(grad, hess)
        self._bagging(self.iter)
        w = self.bag_weight
        gh_T, scales = self._pack(grad[0] * w, hess[0] * w, w)
        tree, row_leaf = self._grow(gh_T, self._tree_feature_mask(),
                                    scales=scales)
        if self.use_screening:
            self._update_gain_ema(tree)
        return self._finish_iter(
            tree, 0.0, row_leaf,
            lambda lv, rl: table_lookup(rl[None, :n], lv)[0])

    def _tree_feature_mask(self) -> torch.Tensor:
        """This tree's feature mask, with gain screening's when it is on."""
        fmask = self._feature_mask_pad()
        if self.use_screening:
            smask = self._screening_mask(self._screening_explore(self.iter))
            if smask is not None:
                fmask = fmask & smask
        return fmask

    def _pack(self, g, h, w):
        """Row-padded gh block (quantized under ``tpu_quantized_grad``)
        and its scales (None unquantized)."""
        gh = [self._pad_rows(x) for x in (g, h, w)]
        if self.quant_bits:
            return pack_gh_quant(*gh, self.quant_bits,
                                 seed=self._quant_seed(self.iter))
        return pack_gh(*gh, self.fused_nch), None

    def _epi_iter_body(self) -> bool:
        """The epilogue body: grow from the carry (or prime it from the
        scores), then one ``epilogue_pass`` applies the deferred final
        route, adds the shrunk leaf values to the scores and builds the
        next iteration's packed gradients (with the next round's bag
        weights) and root histogram."""
        n = self.num_data
        init_score = self._boost_from_average()
        self._bagging(self.iter)            # live bookkeeping, iteration t
        kind, (op0, op1), sig = self._epi_spec
        if self._epi_ops is None:
            # zero operand rows make the padding rows' gradients vanish
            ops = torch.zeros((8, self.fused_Rp), dtype=torch.float32,
                              device=self.device)
            ops[0, :n] = op0
            ops[1, :n] = op1
            self._epi_ops = ops
        ops = self._epi_ops
        fmask = self._feature_mask_pad()
        bag_next = self._pad_rows(self._bag_weight_for_iter(self.iter + 1))
        if self._epi_carry is None:
            score_pad = self._pad_rows(self.scores)
            g, h = self.objective.gradients_from(score_pad, (ops[0], ops[1]))
            bag = self._pad_rows(self.bag_weight)
            gh_T = pack_gh(g[0] * bag, h[0] * bag, bag, self.fused_nch)
            root_hist = None
        else:
            score_pad, root_hist, gh_T = self._epi_carry
        tree, row_leaf, W_last, tbl_last = self._grow(gh_T, fmask, root_hist,
                                                      defer=True)
        if tree.num_leaves > 1:
            lv = tree.leaf_value * torch.tensor(self.shrinkage_rate,
                                                dtype=torch.float32)
        else:
            lv = torch.zeros_like(tree.leaf_value)
        hist0, score2, gh_next = epilogue_pass(
            self.fused_bins_T, row_leaf[None, :], W_last, tbl_last, lv,
            score_pad, ops, bag_next[None, :], num_bins=self.fused_Bp,
            f_oh=self.fused_f_oh, nch=self.fused_nch, kind=kind,
            sigmoid=float(sig))
        self._epi_carry = (score2, hist0, gh_next)
        self.scores = score2[:, :n]
        return self._finish_iter(tree, init_score)

    def _finish_iter(self, tree: TreeArrays, init_score: float,
                     row_leaf: torch.Tensor = None, lookup=None) -> bool:
        """Host bookkeeping of one grown tree; True (and no model appended
        past the first) when it grew no split. With ``row_leaf`` (the
        frontier and caller-gradient bodies) the tree's score update
        happens here, in ``_sync_iter_body``'s order (gbdt.py:4700-4788):
        shrinkage in float64 on the host tree, then its leaf values as f32
        added per row through ``lookup(leaf_values, row_leaf)`` and to the
        valid scores, then the bias. Without it (the fused megastep and
        epilogue bodies) the valid scores take the device tree's f32
        ``leaf_value * shrinkage``."""
        if tree.num_leaves <= 1:
            self._epi_carry = None
            if not self.models:
                # the reference keeps one constant tree carrying the init
                # score and adds it to the scorers a second time
                # (gbdt.cpp:377,433; matched by the JAX package)
                ht = HostTree(1)
                ht.leaf_value[0] = init_score
                self._add_constant(init_score)
                self.models.append(ht)
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            return True
        ht = self._to_host_tree(tree)
        ht.apply_shrinkage(self.shrinkage_rate)
        if row_leaf is not None:
            lv = torch.as_tensor(ht.leaf_value.astype(np.float32),
                                 device=self.device)
            self.scores[0] += lookup(lv, row_leaf)
            for vd, vs in zip(self.valid_data, self.valid_scores):
                vs[0] = self._add_host_tree(vs[0], vd.bins_dev, ht)
        else:
            self._update_valid_from_tree(tree)
        if abs(init_score) > K_EPSILON:
            ht.add_bias(init_score)
        self.models.append(ht)
        self.iter += 1
        return False

    def _fast_tree_depth_bound(self) -> int:
        """Routing steps that cover any tree of the fused grower: one per
        scheduled level pass, plus one (gbdt.py:3238)."""
        caps = level_caps(self.max_leaves, int(self.config.max_depth),
                          int(self.config.tpu_extra_levels),
                          slot_cap=max_slot_cap(
                              self.fused_f_oh * self.fused_Bp,
                              self.fused_nch))
        return len(caps) + 1

    def _update_valid_from_tree(self, tree: TreeArrays) -> None:
        """The fused bodies' valid update (gbdt.py:3252-3281
        ``_make_valid_apply``): every valid row routed through the device
        tree, plus its f32 ``leaf_value * shrinkage``; no host read."""
        if not self.valid_scores:
            return
        lv = tree.leaf_value * torch.tensor(self.shrinkage_rate,
                                            dtype=torch.float32)
        steps = self._fast_tree_depth_bound()
        m = self.fused_meta
        for vd, vs in zip(self.valid_data, self.valid_scores):
            vs[0] = add_tree_score(
                vs[0], vd.bins_dev, lv, tree.split_feature,
                tree.threshold_bin, tree.default_left, tree.left_child,
                tree.right_child, m.num_bin, m.missing_type, m.default_bin,
                steps)

    def _add_host_tree(self, score: torch.Tensor, bins: torch.Tensor,
                       ht: HostTree, scale: float = 1.0) -> torch.Tensor:
        """``score + scale * leaf_value[route(row)]`` of a host tree on
        binned rows, its leaf values as f32 (gbdt.py:3077
        ``_add_tree_to_score``)."""
        lv = torch.as_tensor(np.asarray(ht.leaf_value, np.float32),
                             device=self.device)
        if scale != 1.0:
            lv = lv * scale
        if ht.num_leaves <= 1:
            return score + lv[0]
        ni = ht.num_internal
        inner = [self.train_data.used_features.index(int(f))
                 for f in ht.split_feature[:ni]]

        def t(a, dt=torch.int64):
            return torch.as_tensor(np.asarray(a), dtype=dt,
                                   device=self.device)
        meta = self.frontier_meta if self.use_frontier else self.fused_meta
        return add_tree_score(
            score, bins, lv, t(inner), t(ht.threshold_bin[:ni]),
            t((ht.decision_type[:ni] & 2) != 0, torch.bool),
            t(ht.left_child[:ni]), t(ht.right_child[:ni]),
            meta.num_bin, meta.missing_type, meta.default_bin,
            tree_depth(ht.left_child, ht.right_child))

    def rollback_one_iter(self) -> None:
        """Drop the last iteration's tree and subtract it from the training
        and valid scores (ref: gbdt.cpp:456 RollbackOneIter). The epilogue
        carry is dropped, so the next iteration primes again; the bag round
        cache is kept, so a retrain replays the round it used."""
        self._epi_carry = None
        if self.iter <= 0:
            return
        ht = self.models[-1]
        self.scores[0] = self._add_host_tree(
            self.scores[0], self.train_data.bins_dev, ht, -1.0)
        for vd, vs in zip(self.valid_data, self.valid_scores):
            vs[0] = self._add_host_tree(vs[0], vd.bins_dev, ht, -1.0)
        del self.models[-1]
        self.iter -= 1

    def reset_config(self, config: Config) -> None:
        """Re-derive the training state from an updated config (ref:
        gbdt.cpp:686-839 ResetConfig/ResetBaggingConfig; the JAX
        package's ``reset_config``): shrinkage, leaves, split parameters,
        the engine's layout, and the bagging state, whose per-block
        streams are drawn anew."""
        self._check_ported(config)
        self.config = config
        self.shrinkage_rate = float(config.learning_rate)
        self.max_leaves = max(2, int(config.num_leaves))
        self.params = split_params_from_config(config)
        self._epi_carry = None
        self._setup_engine(config, self.train_data)
        n = self.num_data
        obj = self.objective
        self.is_bagging = False
        self.balanced_bagging = False
        if config.bagging_freq > 0:
            if config.bagging_fraction < 1.0:
                self.is_bagging = True
            elif (obj is not None and obj.name == "binary"
                  and (config.pos_bagging_fraction < 1.0
                       or config.neg_bagging_fraction < 1.0)):
                self.is_bagging = True
                self.balanced_bagging = True
        if not self.is_bagging:
            self.bag_weight = torch.ones(n, dtype=torch.float32,
                                         device=self.device)
            self.bag_cnt = n
        self.bag_streams = ref_random.BlockBaggingStreams(
            int(config.bagging_seed), n)
        self._bag_round_cache = {}

    def eval_metric_set(self, ds_name: str, metrics, score_dev):
        """[(ds_name, metric_name, value, is_higher_better)] of one score
        set (gbdt.py:5063): each metric's device form on ``score_dev``
        where it has one (a 0-d tensor; the caller fetches every scalar at
        once), else its host form on one float64 copy of the scores."""
        out = []
        host_score = None
        cache = {}    # the converted score row, shared by the set's metrics
        for m in metrics:
            vals = m.eval_device(score_dev, self.objective, cache)
            if vals is None:
                if host_score is None:
                    host_score = score_dev.double().cpu().numpy()
                vals = m.eval(host_score, self.objective)
            for name, v in zip(m.names, vals):
                out.append((ds_name, name, v, m.is_bigger_better))
        return out

    def megastep_eval_precheck(self, include_training: bool
                               ) -> Tuple[bool, Optional[str]]:
        """Whether ``engine.train`` may run the megastep body with its
        built-in callbacks (gbdt.py:4159): ``(True, None)``, or ``(False,
        reason)`` naming the first blocker, as the JAX package decides it
        (its interpret-mode opt-in aside): the fused engine, a built-in
        objective, ``tpu_traced_eval`` and ``tpu_megastep``, and every
        metric with a device form."""
        if not bool(self.config.tpu_traced_eval):
            return False, "config:tpu_traced_eval=false"
        if self.use_frontier:
            return False, "engine:frontier"
        if self.objective is None:
            return False, "fobj"
        if not bool(self.config.tpu_megastep):
            return False, "config:tpu_megastep=false"
        sets = list(self.valid_metrics)
        if include_training:
            sets.insert(0, self.training_metrics)
        for metrics in sets:
            for m in metrics:
                if not m.has_device_form(self.objective):
                    return False, f"metric:{m.names[0]}"
        return True, None

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
