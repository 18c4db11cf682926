"""Gradient boosting on the fused, frontier-v1 and XLA engines.

PyTorch counterpart of ``lightgbm_tpu/boosting/gbdt.py`` on its main
training path, the serial learner. ``_setup_engine`` resolves
``tpu_engine`` and ``grow_policy`` as the JAX package does
(``gbdt.py:1956-2106``), in its order: ``auto`` is the fused engine (the
port always runs on the card, as the JAX package's ``auto`` on a TPU),
``frontier`` the frontier-v1 engine with ``tpu_histogram_impl`` auto or
pallas and the XLA engine's leaf-wise grower otherwise, ``xla`` the XLA
engine; forced splits and CEGB move any engine to ``xla``; ``grow_policy``
``auto`` is depth-wise on the fused and frontier engines and under CEGB,
leaf-wise otherwise, and ``leafwise`` on any engine takes the XLA
leaf-wise grower (``depthwise`` with ``xla`` its depth-wise grower).

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

The frontier-v1 engine takes the synchronous body below (``gh3 = [g*bag,
h*bag, bag]`` into ``grow_tree_frontier``); neither the megastep nor the
epilogue applies to it. Nor to the XLA engine (``models/learner.py``'s
``grow_tree_leafwise`` and ``grow_tree_depthwise`` on the same ``gh3``,
their histograms through ``ops/histogram.py``), which the synchronous
body drives too.

The **synchronous body** (``_sync_iter_body``; the JAX package's
``_sync_iter_body``, ``gbdt.py:4649-4800``) grows one tree per class and
finishes each on the host before the next: gradients (the objective's,
with ``boost_from_average`` per class, or the caller's ``[k, n]``), then
``_bagging`` (the hook GOSS overrides to sample rows and scale their
gradients), then per class the engine's grower (the fused one with the
per-node feature masks, or the frontier-v1 one), the host tree, leaf
renewal for the L1 family (in-bag rows, float64 residuals, one stable
argsort), shrinkage in float64, and the f32 leaf values added to the
scores through ``table_lookup`` (``leaf_value_lookup`` on the frontier
engine). ``train_one_iter`` takes it exactly where the JAX package's
``_fast_path_ok`` says no: a boosting subclass (GOSS), leaf renewal, node
masks, a class with nothing to learn (``class_need_train``), caller
gradients, or the frontier engine. That order differs from the fused
bodies' f32 ``leaf_value * shrinkage`` in the last bits (the JAX
package's ``gbdt.py:3162-3164``), so each body keeps its own.

Scores are ``[k, n]`` f32 with ``k = num_tree_per_iteration`` (the
objective's ``num_model_per_iteration``: ``num_class`` for multiclass and
multiclassova). The megastep body loops over the k class trees as the JAX
package's ``grow_k_trees`` does (gradients once, then for each class pack,
grow and add its score delta; a class that grows no split adds nothing
and gets a constant tree, the others keep boosting); the epilogue body
stays single-class.

Valid sets (``add_valid_data``) keep f32 scores ``[k, n]`` on the device,
updated per tree body by body as in the JAX package: the megastep and
epilogue bodies route each valid row through the device ``TreeArrays``
and add ``leaf_value * shrinkage`` in f32 (``_make_valid_apply``); the
synchronous body adds the host tree's shrunk values
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
with no row padding; ``_init_xla`` routes on the dataset's own bins
(``xla_bins``, the bundle columns under bundles) and keeps the histogram
kernel's int32 feature-padded copy once (``xla_hist_bins``).

Forced splits (``forcedsplits_filename``; ``gbdt.py:1359-1403``) are a BFS
schedule of (leaf, inner feature, bin threshold) the leaf-wise grower
takes before its gain choice; they disable feature bundling (fatal on a
sparse-built dataset) and CEGB. CEGB (``cegb_*``; ``gbdt.py:1406-1440``)
runs on the depth-wise grower: ``cegb_used`` [F] (the features any
split has used, on the device) and, under lazy penalties,
``cegb_used_rf`` [n, F] persist across trees; ``reset_config`` re-reads
both setups. Neither rides a checkpoint, as in the JAX package: a
resumed booster starts them at zeros.

The histogram-plane cuts (``gbdt.py:2107-2161`` of the JAX package) run on
the fused engine's megastep body, alone or together:
``tpu_quantized_grad`` 8 or 16 (``pack_gh_quant`` with the dither seed of
``_quant_seed``; int32 histograms), ``tpu_adaptive_bins`` (``bins_T``'s rows
permuted into a ``PackedLayout``) and ``tpu_gain_screening`` (a per-tree
top-k mask over an EMA of realized split gains, composed with the
feature_fraction mask and applied in the kernel). The epilogue body does
not take them (its kernel is f32 and padded), and on the frontier engine
they are dropped with a log line, as in the JAX package.

Interaction constraints and ``feature_fraction_bynode`` (``node_masks``)
narrow each node's split search in the fused grower; the by-node draws
come from the port's Threefry (``utils/random.py``), keyed on
``feature_fraction_seed + 12345`` folded with the iteration. Under them
the frontier-v1 engine degrades to the fused one with a log line, as the
JAX package's ``_setup_engine`` does.

Categorical features (``train_data.is_categorical``) join the fused
grower's split search (``cat_idx``); their splits route through the same
kernels by the W rows of their left bin sets. ``_to_host_tree`` turns a
bin-space left set into the category-value bitset of the model text
(``cat_boundaries``, ``cat_threshold``), and every routing of a host tree
on bins (valid sets, rollback, ``add_valid``) decodes the bitset back
into bins through the training mappers. Under categorical features the
frontier-v1 engine degrades to the fused one with a log line, as the JAX
package's ``_setup_engine`` does. The ranking objectives train on the
megastep or synchronous body like any other objective (their gradients
are ``[1, n]``; they have no epilogue form).

Exclusive feature bundling (``_setup_bundles``, the JAX package's
``gbdt.py:1222-1356``): where ``enable_bundle`` and ``tpu_enable_bundle``
hold (both default on) and the fused engine trains — ``tpu_engine`` fused,
or ``auto``, which in the port always resolves to the fused engine on the
card as ``auto`` does on a TPU — mutually exclusive columns are bundled
whenever that cuts the column count (``ops/efb.find_bundles`` at conflict
rate 1e-4 under the adaptive width cap), and ``_init_fused`` stores the
bundle columns as ``bins_T`` (int8 up to Bc_p = 128, int16 above). A
sparse-built dataset (``BinnedDataset.prebundled``) brings its layout
from ingestion, and replays of host trees on its training bins decode
through ``_replay_bundle``. Under bundles the frontier engine degrades to
fused, adaptive bins yield to the bundle layout, and gain screening keeps
the full build (the mask acts at the split scan only), each as in the JAX
package.

Monotone constraints (``monotone_constraints`` per original column,
indexed by the used features into ``FeatureMeta.monotone``; the JAX
package's ``gbdt.py:81-82, 321, 1990-2075``) run on every grower but the
frontier-v1 one (which degrades to the fused engine): ``use_mono_bounds``
and ``mono_mode`` go to every grow call. ``monotone_constraints_method``
``basic`` and ``intermediate`` run on every grower; ``advanced`` needs the
leaf-wise grower and elsewhere degrades to ``intermediate`` with the JAX
package's warning.

DART (``DART``, the JAX package's ``gbdt.py:5331-5470``) and random
forests (``RF``, ``gbdt.py:5579-5734``) train on the synchronous body.
DART drops trees through the gradient hook (``_get_gradients``): the
dropped trees leave the training scores before the gradients, and
``_normalize`` shrinks them and re-adds their share afterwards. RF takes
fixed gradients at the constant base score and folds that score into every
tree; its scores hold the sum of the trees, which evaluation and
prediction divide by the iterations.

Linear-tree leaves (``linear_tree``; ``gbdt.py:3018-3074, 4719-4770``)
fit after the host tree, on the dataset's raw columns on the device
(``ops/linear.py``), before leaf renewal and shrinkage; the training
scores then take each row's linear output, and a valid set its own raw
rows' outputs where it kept them, the binned constant replay otherwise.

Distributed training (``_setup_parallel``, the JAX package's
``gbdt.py:1441-1645``): ``tree_learner`` data or voting over an
initialised ``torch.distributed`` group with one rank per device, each
rank passing only its own rows. ``MultiProcLayout`` lays the rows out in
rank blocks, the objective and the training metrics are initialised on
the allgathered global metadata (their statistics global, their gradient
operands sliced back to the rank's rows), bagging draws over the global
rows on every rank and keeps the rank's slice, the quantized dither hashes
global rows under the group's scales, and every grower reduces its
histograms over the group (``group``), the epilogue body's next root
histogram included, so every rank grows the same trees. Training metrics
evaluate on the gathered scores; valid sets are replicated, their
agreement checked by a digest. Every composition of the serial learner
trains under ranks with the JAX package's multi-process semantics:

- GOSS samples each rank's own rows (the same seed on every rank, its
  in-bag count gathered; a rank without rows joins every collective);
  DART draws the same drop set on every rank and replays the dropped
  trees on the rank's rows; RF takes fixed gradients on the rank's rows,
  bags over the global rows and evaluates on the gathered average;
- leaf renewal (the L1 family) sets each leaf to the mean of the ranks'
  own renewed outputs over the ranks that hold in-bag rows in it, one
  host gather per tree (``_renew_tree_output``), not a global
  percentile;
- ranking runs on query-aligned shards: the global query boundaries and
  the compacted-to-padded row map (``GlobalMetadata``), the gradients over
  the padded global rows sliced back to the rank's block, ``ndcg`` and
  ``map`` as sums over the rank's queries and one host gather;
- CEGB composes, its lazy penalties dropped with the JAX package's
  warning; forced splits keep the leaf-wise grower under data and voting
  (the vote always sums the forced features' columns);
- dense EFB takes its bundle layout from the gathered binning sample
  (``mp_sample_bins``), so every rank encodes its rows with the same
  layout; fused voting on bundles sums the winners' decoded planes.

Feature-parallel needs every row on every rank: under the trainer it
degrades to data-parallel with the JAX package's warning, as the JAX
package does under many processes, and runs at the grower level
(``parallel.make_feature_parallel_grow_fn``). With no group, or a group of
one rank, ``tree_learner`` warns and trains serially. Sparse (prebundled)
input and ``linear_tree`` are refused in the JAX package's words.

Resilience (``_setup_resilience``, the JAX package's ``gbdt.py:1101-
1219``): ``collective_timeout`` and ``collective_retries`` set the
host-plane guard (``resilience/comms.py``), ``LIGHTGBM_TPU_FAULTS`` arms
the fault hooks (crash and hang at the top of ``train_one_iter``,
diverge after a synchronous iteration), and ``checkpoint_dir`` starts a
writer thread (``resilience/checkpoint.py``) that ``maybe_checkpoint``
feeds every ``checkpoint_period`` iterations with ``resilience/state``'s
capture; GOSS and DART add their random streams
(``_capture_boosting_extra``). ``reset_config`` keeps the writer for the
same directory, and drains and stops it for another or none.

Not ported yet (``_UNPORTED`` raises, naming its ROADMAP item): the
training side of the observability keys (``telemetry_out``,
``trace_out``, ``health_check_period``, ``run_report_out``,
``profile_dir``, ``perf_db``), item 10e; ``metrics_port``,
``slo_enabled`` and ``slo_config``, item 10f.
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..binning import BIN_CATEGORICAL
from ..config import Config
from ..dataset import BinnedDataset
from ..models.frontier import grow_tree_frontier, leaf_value_lookup
from ..models.frontier2 import grow_tree_fused, level_caps, tree_score_delta
from ..models.frontier2 import host_syncs
from ..models.learner import (BundleCfg, FeatureMeta, NodeMaskCfg,
                              grow_tree_depthwise, grow_tree_leafwise,
                              make_node_mask_cfg)
from ..models.tree import HostTree, TreeArrays
from ..ops.collectives import record_psum
from ..ops.efb import BundleLayout, encode_bundles, find_bundles
from ..ops.fused_level import (NCH_FAST, NCH_PRECISE, epilogue_pass,
                               max_slot_cap, pack_gh, pack_gh_quant,
                               table_lookup)
from ..ops.histogram import hist_bins
from ..ops.layout import feature_layout, packed_feature_layout
from ..ops.linear import fit_linear_leaves, linear_leaf_outputs
from ..ops.pallas_histogram import pad_feature_layout
from ..ops.predict import (add_tree_score, route_binned_rows_to_leaves,
                           tree_depth, tree_outputs)
from ..ops.quantize import QNCH
from ..ops.split import SplitParams, calculate_leaf_output
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
        path_smooth=float(config.path_smooth),
        monotone_penalty=float(config.monotone_penalty),
        max_cat_to_onehot=int(config.max_cat_to_onehot),
        max_cat_threshold=int(config.max_cat_threshold),
        cat_l2=float(config.cat_l2),
        cat_smooth=float(config.cat_smooth),
        min_data_per_group=int(config.min_data_per_group),
        cegb_tradeoff=float(config.cegb_tradeoff),
        cegb_penalty_split=float(config.cegb_penalty_split))


_UNPORTED = tuple(
    # the training side of obs/ and the SLO plane (lightgbm_tpu/boosting/
    # gbdt.py:460-466, 532, 554-561): a non-default value is refused,
    # never ignored
    (key, bool, f"{key} {what} (ROADMAP Queue A item {item})")
    for key, what, item in (
        ("telemetry_out", "(per-iteration telemetry)", "10e"),
        ("trace_out", "(trace spans)", "10e"),
        ("health_check_period", "(health checks)", "10e"),
        ("metrics_port", "(the metrics exporter)", "10f"),
        ("run_report_out", "(the run report)", "10e"),
        ("profile_dir", "(profiler windows)", "10e"),
        ("perf_db", "(the performance database)", "10e"),
        ("slo_enabled", "(the SLO plane)", "10f"),
        ("slo_config", "(the SLO plane)", "10f")))


class GBDT:
    """Boosting state on one device (ref: src/boosting/gbdt.cpp)."""

    name = "gbdt"

    def init(self, config: Config, train_data: BinnedDataset,
             objective, training_metrics: Sequence = ()) -> None:
        self._check_ported(config)
        # this trainer's host-collective policy guards every gather it
        # makes, the rank layout's below too, not the previous trainer's
        self._set_collective_policy(config)
        self.config = config
        self.train_data = train_data
        self.objective = objective
        self.training_metrics = list(training_metrics)
        self.device = train_data.device
        self.num_data = train_data.num_data
        self.num_tree_per_iteration = (objective.num_model_per_iteration
                                       if objective is not None else
                                       max(1, int(config.num_class)))
        self.shrinkage_rate = float(config.learning_rate)
        self.max_leaves = max(2, int(config.num_leaves))
        self.max_bins = int(train_data.max_num_bin)
        self.params = split_params_from_config(config)
        self.models: List[HostTree] = []
        self.iter = 0
        # iterations adopted from a model (reset_training_data): the init
        # segment, never replayed onto the scores
        self.num_init_iteration = 0
        md = train_data.metadata
        self.has_init_score = md.init_score is not None
        self.scores = self._initial_scores(md, self.num_data)
        self.valid_data: List[BinnedDataset] = []
        self.valid_scores: List[torch.Tensor] = []   # [k, n_valid] f32
        self.valid_metrics: List[List] = []
        self.valid_names: List[str] = []
        self.class_need_train = [
            objective.class_need_train(i) if objective is not None else True
            for i in range(self.num_tree_per_iteration)]
        self._setup_cegb(config)
        self._setup_forced_splits(config, train_data)
        self._setup_bundles(config, train_data)
        self._setup_node_masks(config, train_data)
        self._setup_parallel(config, train_data)
        self._setup_engine(config, train_data)
        self._megastep_armed = False
        # epilogue body: (score [1, Rp], root hist, gh_T) carried to the
        # next iteration; None = the next iteration primes
        self._epi_carry = None
        self._epi_spec = (objective.epilogue_spec()
                          if objective is not None else None)
        if self._epi_spec is not None and self.mp is not None:
            kind, rows, sig = self._epi_spec
            self._epi_spec = (kind, tuple(self.mp.local_block(r)
                                          for r in rows), sig)
        self._epi_ops = None

        # bagging state (ref: gbdt.cpp:686-758 ResetBaggingConfig;
        # utils/random.h LCG, gbdt.cpp:804 per-block bagging generators,
        # col_sampler.hpp:26 by-tree stream); GOSS samples from bag_rng
        self.bag_streams = ref_random.BlockBaggingStreams(
            int(config.bagging_seed), self._bag_rows())
        self._bag_round_cache = {}
        self.bag_rng = np.random.RandomState(int(config.bagging_seed))
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
        self._set_bag(None)
        # the early-stop state of the JAX package's CLI loop (ROADMAP item
        # 11), carried through checkpoints
        self.best_score = {}
        self.best_iter = {}
        # resilience: the checkpoint writer, its cadence and the fault
        # registry
        self._ckpt = None
        self._last_ckpt_iter = 0
        self._setup_resilience(config)

    @staticmethod
    def _check_ported(config: Config) -> None:
        for key, bad, what in _UNPORTED:
            if bad(getattr(config, key)):
                log.fatal("%s is not ported to lightgbm_tpu_torch yet "
                          "(%s=%r)", what, key, getattr(config, key))

    # -------------------------------------------------------- resilience
    @staticmethod
    def _set_collective_policy(config: Config) -> None:
        from ..resilience import comms
        comms.set_collective_policy(float(config.collective_timeout or 0.0),
                                    int(config.collective_retries))

    def _setup_resilience(self, config: Config) -> None:
        """The host-collective policy, the fault registry and the
        checkpoint writer (gbdt.py:1101-1150): a ``reset_config`` with the
        same ``checkpoint_dir`` keeps the writer, a changed or dropped one
        drains and stops it."""
        from ..parallel import mesh
        from ..resilience.checkpoint import CheckpointManager
        from ..resilience.faults import registry_from_env
        self._set_collective_policy(config)
        self._faults = registry_from_env()
        self._ckpt_period = int(config.checkpoint_period or 0)
        root = str(config.checkpoint_dir or "")
        if self._ckpt is not None and self._ckpt.root != root:
            # drain the old writer so its checkpoint commits and its
            # thread does not leak
            try:
                self._ckpt.close()
            except Exception as e:
                log.warning("checkpoint writer shutdown failed: %s", e)
            self._ckpt = None
        if not root:
            if self._ckpt_period > 0:
                log.warning("checkpoint_period=%d set without "
                            "checkpoint_dir; checkpointing is off",
                            self._ckpt_period)
            return
        if self._ckpt_period <= 0:
            log.warning("checkpoint_dir=%s set without checkpoint_period; "
                        "no periodic checkpoints will be written", root)
        if self._ckpt is None:
            self._ckpt = CheckpointManager(
                root, rank=mesh.rank(), world=mesh.world(),
                keep=int(config.checkpoint_keep))

    def maybe_checkpoint(self, extra=None) -> bool:
        """Capture and enqueue a checkpoint when one is due: every
        ``checkpoint_period`` iterations, called by ``engine.train`` once
        each iteration has settled (every body settles its iteration, so
        this is the one cadence point). ``extra`` returns the engine's
        JSON-able state to ride the checkpoint. A failed capture warns and
        never stops training."""
        if (self._ckpt is None or self._ckpt_period <= 0
                or self.iter - self._last_ckpt_iter < self._ckpt_period):
            return False
        try:
            from ..resilience import state as rstate
            payload, arrays = rstate.capture(self, extra)
            self._ckpt.save(self.iter, payload, arrays)
            self._last_ckpt_iter = self.iter
            return True
        except Exception as e:
            log.warning("checkpoint capture at iteration %d failed: %s",
                        self.iter, e)
            return False

    def wait_checkpoints(self) -> None:
        """Join the writer's write in flight, so that a checkpoint taken in
        the last iteration commits before the process may exit (the JAX
        package's ``_finalize_telemetry_body``, gbdt.py:888-896)."""
        if self._ckpt is not None:
            try:
                self._ckpt.wait()
            except Exception as e:
                log.warning("checkpoint writer drain failed: %s", e)

    def _capture_boosting_extra(self) -> Tuple[dict, dict]:
        """Boosting-mode state beyond the base trainer's (payload dict, npz
        arrays); DART and GOSS override."""
        return {}, {}

    def _restore_boosting_extra(self, payload: dict, arrays) -> None:
        pass

    def _health_resync(self, it: int, per_rank) -> bool:
        """Repair a divergence from rank 0's model (the auditor's action,
        ROADMAP item 10e; ``resilience/recovery.py``)."""
        from ..resilience import recovery
        return recovery.resync_from_rank0(self, it, per_rank)

    # ------------------------------------------------------ distribution
    def _setup_parallel(self, config: Config,
                        train_data: BinnedDataset) -> None:
        """The distribution axis of the learner (gbdt.py:1441-1645; ref:
        tree_learner.cpp:17-49): ``tree_learner`` data or voting over the
        default process group, one rank per device, rows sharded. Sets
        ``parallel_mode``, ``group`` (None = serial), ``mp`` (the rank
        layout) and, under it, re-initialises the objective and the
        training metrics on the global metadata."""
        self.parallel_mode = "serial"
        self.group = None
        self.mp = None
        self.top_k = int(config.top_k)
        if not bool(getattr(config, "is_parallel", False)):
            return
        from ..parallel import mesh
        from ..parallel.multiproc import MultiProcLayout, cohort_votes
        mode = str(config.tree_learner)
        if mesh.world() < 2:
            log.warning(
                "tree_learner=%s requested but only one device is visible; "
                "training serially (start one rank per device: "
                "parallel.distributed.init_distributed, or torchrun)", mode)
            return
        import torch.distributed as dist
        if bool(config.linear_tree):
            # REFERENCE PARITY: the reference also refuses this (config.cpp:
            # 348 forces tree_learner=serial under linear_tree)
            log.fatal("linear_tree is serial-only (the reference forces "
                      "tree_learner=serial for linear trees too); not "
                      "supported with multi-process training")
        # a local fact, so the cohort's vote: every rank refuses
        if cohort_votes(train_data.prebundled is not None)[0]:
            log.fatal("sparse-built (prebundled) datasets derive their "
                      "bundle layout from rank-local CSC columns and are "
                      "not supported with multi-process training; dense "
                      "EFB (enable_bundle on dense data) composes — its "
                      "layout comes from the shared binning sample")
        self._drop_lazy_cegb()
        if mode == "feature":
            # feature-parallel replicates rows on every rank; here each
            # rank holds only its own rows
            log.warning("tree_learner=feature needs row-replicated data; "
                        "multi-process runs shard rows per rank — using "
                        "data-parallel")
            mode = "data"
        self.parallel_mode = mode
        self.group = dist.group.WORLD
        # the fused engine's rank blocks align to its widest kernel tile
        # (gbdt.py:1618-1628), so the global row of every local one, which
        # the quantized dither hashes, is the JAX package's
        wants_fused = str(config.tpu_engine) in ("auto", "fused", "frontier")
        self.mp = MultiProcLayout(train_data.num_data,
                                  row_align=ROW_BLOCK if wants_fused else 1)
        # a Dataset constructed before its params named a parallel
        # tree_learner binned from its own rows only
        from ..binning import mappers_digest
        digest = np.frombuffer(bytes.fromhex(
            mappers_digest(train_data.mappers)), np.uint8).copy()
        allg = self.mp._allgather(digest)
        if not bool((allg == allg[0]).all()):
            log.fatal("the bin mappers differ across ranks: give the "
                      "training Dataset tree_learner in its params before "
                      "it is constructed (train() does so for a Dataset "
                      "not yet constructed), so that every rank bins from "
                      "the gathered sample")
        self._mp_metadata = self.mp.global_metadata(train_data.metadata)
        # objectives and metrics: global statistics (the reference's
        # GlobalSyncUp* paths), arrays over the Np padded rows with zero
        # weight on the pads; the gradients read this rank's rows of them
        obj = self.objective
        if obj is not None:
            obj.init(self._mp_metadata, self.mp.total_real, self.device)
            mp = self.mp
            if self._mp_metadata.query_boundaries is not None:
                # ranking: a query's lambdas read all its rows' scores, so
                # the gradients run over the Np padded rows (this rank's
                # scores at its block, zeros elsewhere: its queries are
                # whole) and this rank's block is kept
                full_grad = obj.get_gradients

                def local_grad(score):
                    full = score.new_zeros((score.shape[0], mp.Np))
                    full[:, mp.offset:mp.offset + mp.local_real] = score
                    g, h = full_grad(full)
                    return mp.local_block(g), mp.local_block(h)
                obj.get_gradients = local_grad
            else:
                full_ops = obj.gradient_operands
                obj.gradient_operands = lambda: tuple(
                    None if o is None else mp.local_block(o)
                    for o in full_ops())
            self.class_need_train = [
                obj.class_need_train(i)
                for i in range(self.num_tree_per_iteration)]
        for m in self.training_metrics:
            m.init(self._mp_metadata, self.mp.total_real)
        log.info("Using %s-parallel tree learner over %d ranks", mode,
                 self.mp.process_count)

    def _bag_rows(self) -> int:
        """Rows the bagging streams draw over: the global padded rows
        under a rank layout (every rank draws all of them), else ours."""
        return self.mp.Np if self.mp is not None else self.num_data

    def train_scores_global(self) -> torch.Tensor:
        """[k, Np] training scores of every rank's rows (pads 0), for the
        training metrics, which hold the global metadata."""
        return self.mp.gather_cols(self.scores)

    def _valid_digest_check(self, valid_data: BinnedDataset) -> None:
        """Valid sets are replicated: every rank must pass the same rows,
        or the ranks' metrics, and early stopping with them, would diverge
        (gbdt.py:4200-4228). One host gather of a digest per set."""
        import hashlib
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(
            valid_data.bins_dev.cpu().numpy()).tobytes())
        md = valid_data.metadata
        for arr in (md.label, md.weight, md.init_score):
            if arr is not None:
                h.update(np.ascontiguousarray(
                    np.asarray(arr, np.float64)).tobytes())
        digest = np.frombuffer(h.digest(), np.uint8).copy()
        allg = self.mp._allgather(digest)
        if not bool((allg == allg[0]).all()):
            log.fatal("the valid set differs across ranks: multi-process "
                      "training evaluates replicated valid data, so every "
                      "rank must pass the same rows")

    def _initial_scores(self, md, n: int) -> torch.Tensor:
        """[k, n] f32 scores: the init score where one is set (``k * n``
        values class-major, or ``n`` repeated for every class), else 0."""
        k = self.num_tree_per_iteration
        if md is None or md.init_score is None:
            return torch.zeros((k, n), dtype=torch.float32,
                               device=self.device)
        init = np.asarray(md.init_score, np.float64)
        if init.size == n * k:
            scores = init.reshape(k, n)
        elif init.size == n:
            scores = np.tile(init.reshape(1, n), (k, 1))
        else:
            log.fatal("init_score has %d values for %d rows and %d classes",
                      init.size, n, k)
        return torch.as_tensor(scores.astype(np.float32), device=self.device)

    def add_valid_data(self, valid_data: BinnedDataset, name: str,
                       metrics: Sequence) -> None:
        """A validation set binned with the training mappers: its f32
        scores (from its init score, then every tree trained so far
        replayed onto it) and its metrics (ref: gbdt.cpp
        AddValidDataset)."""
        if self.mp is not None:
            self._valid_digest_check(valid_data)
        self._epi_carry = None
        self.valid_data.append(valid_data)
        score = self._initial_scores(valid_data.metadata,
                                     valid_data.num_data)
        k = self.num_tree_per_iteration
        bundle = self._bundle_of(valid_data)
        for i, ht in enumerate(self.models):
            score[i % k] = self._add_host_tree(score[i % k],
                                               valid_data.bins_dev, ht,
                                               bundle=bundle)
        self.valid_scores.append(score)
        self.valid_metrics.append(list(metrics))
        self.valid_names.append(name)

    def _setup_bundles(self, config: Config,
                       train_data: BinnedDataset) -> None:
        """Exclusive feature bundling for the fused engine (gbdt.py:1222-
        1323; ref: src/io/dataset.cpp FindGroups/FastFeatureBundling). A
        sparse-built dataset brings its layout (the bundle matrix is its
        storage). Otherwise on by default where the fused engine trains,
        and engaged only where bundling cuts the column count, under the
        adaptive width cap: uncapped (32767, the int16 ceiling of
        ``bins_T``) first, then 8 and 4 x max_bin, until the padding to
        the widest column at most doubles the stored bins."""
        self.use_bundles = False
        self._replay_bundle = None
        pb = train_data.prebundled
        if pb is not None:
            if self.n_forced > 0:
                log.fatal("forced splits are not supported on sparse-built "
                          "(prebundled) datasets")
            mfb = np.asarray(train_data.most_freq_bins, np.int32)
            self._install_bundle_layout(train_data, pb, train_data.bins, mfb)
            t = lambda a: torch.as_tensor(np.asarray(a, np.int64),  # noqa
                                          device=self.device)
            self._replay_bundle = (t(pb.col_of_feat), t(pb.offset_of_feat),
                                   t(mfb))
            return
        if not (bool(config.tpu_enable_bundle)
                and bool(config.enable_bundle)):
            return
        if not config.was_set("tpu_enable_bundle") \
                and str(config.tpu_engine) not in ("fused", "auto"):
            # opt-in on the other engines, as in the JAX package
            # (gbdt.py:1253-1266)
            return
        if self.n_forced > 0:
            return   # forced splits route through the leaf-wise grower
        bins_np = train_data.bins
        mfb = np.asarray(train_data.most_freq_bins, np.int32)
        F = train_data.num_features
        n_for_rate = self.num_data
        from ..parallel import mesh
        if mesh.under_ranks(config):
            # the layout must be the same on every rank: the conflict
            # masks come from the gathered binning sample (gbdt.py:
            # 1273-1287; the reference bundles from sampled rows too), and
            # each rank encodes its own rows with that layout. Whether to
            # bundle is the cohort's vote, since it changes which
            # collectives the grower runs
            from ..parallel.multiproc import cohort_votes
            sb = train_data.mp_sample_bins
            if not cohort_votes(sb is not None)[1]:
                log.warning("no shared binning sample retained; skipping "
                            "EFB for this multi-process run")
                return
            masks = [sb[:, k] != mfb[k] for k in range(F)]
            n_for_rate = sb.shape[0]
        else:
            masks = [bins_np[:, k] != mfb[k] for k in range(F)]
        nb_all = [int(x) for x in train_data.num_bin_per_feat]
        for cap in (32767, 8 * self.max_bins, 4 * self.max_bins):
            bundles = find_bundles(masks, n_for_rate,
                                   max_conflict_rate=1e-4,
                                   max_bundle_bins=cap,
                                   num_bin_per_feat=nb_all)
            if len(bundles) >= F:
                return                         # nothing to gain
            widths = [1 + sum(nb_all[f] for f in b) for b in bundles]
            if len(bundles) * max(widths) <= 2 * sum(widths):
                break                          # padding waste bounded
        layout = BundleLayout(bundles, nb_all)
        self._install_bundle_layout(train_data, layout,
                                    encode_bundles(bins_np, mfb, layout), mfb)
        log.info("EFB: %d features bundled into %d columns", F,
                 layout.num_columns)

    def _bundle_of(self, data: BinnedDataset):
        """The replay decode for ``data``'s bins (gbdt.py:3095-3117
        ``_train_bundle``/``_valid_bundle``): ``_replay_bundle`` where they
        are the bundle columns of a sparse-built dataset (a row subset of
        one, as cv's folds are, keeps its layout), None for logical
        bins."""
        return self._replay_bundle if data.prebundled is not None else None

    def _install_bundle_layout(self, train_data: BinnedDataset,
                               layout: BundleLayout, enc_np: np.ndarray,
                               mfb_np: np.ndarray) -> None:
        """``bundle_cfg`` and the device bundle matrix from a layout
        (gbdt.py:1325-1356), for dense EFB and prebundled data alike; the
        FixHistogram residual lands on each feature's most-frequent bin."""
        nb = [int(x) for x in train_data.num_bin_per_feat]
        Bc = max(layout.col_num_bin)
        B = self.max_bins
        F = train_data.num_features
        flat_idx = np.zeros((F, B), np.int32)
        valid = np.zeros((F, B), bool)
        for f in range(F):
            base = int(layout.col_of_feat[f]) * Bc \
                + int(layout.offset_of_feat[f])
            flat_idx[f, :nb[f]] = base + np.arange(nb[f])
            valid[f, :nb[f]] = True

        def t(a, dt=torch.int32):
            return torch.as_tensor(np.asarray(a), dtype=dt,
                                   device=self.device)
        self.bundle_cfg = BundleCfg(
            flat_idx=t(flat_idx), valid=t(valid, torch.bool),
            default_bin=t(mfb_np), col_of_feat=t(layout.col_of_feat),
            offset_of_feat=t(layout.offset_of_feat))
        # int16 holds every bundle bin (the width cap is 32767)
        self.bundle_bins_dev = torch.as_tensor(
            np.asarray(enc_np).astype(np.int16), device=self.device)
        self.bundle_col_bins = int(Bc)
        self.use_bundles = True

    def _setup_forced_splits(self, config: Config,
                             train_data: BinnedDataset) -> None:
        """The forced-split schedule (gbdt.py:1359-1403; ref: gbdt.cpp:72-80
        and serial_tree_learner.cpp:455 ForceSplits): the JSON's nodes in
        BFS order as device tensors ``forced_leaf`` / ``forced_feat``
        (inner index) / ``forced_thr`` (the threshold's bin, by the
        feature's mapper), at most ``num_leaves - 1``. Leaf ids follow the
        leaf-wise grower: splitting leaf l keeps l as the left child and
        gives the right one the next id. A filtered feature's node is
        skipped (with its subtree); a categorical one is fatal."""
        self.n_forced = 0
        path = str(config.forcedsplits_filename or "")
        if not path:
            return
        with open(path) as fh:
            root = json.load(fh)
        used = train_data.used_features
        leaves, feats, thrs = [], [], []
        queue = [(root, 0)]
        next_id = 1
        while queue:
            node, leaf = queue.pop(0)
            real_f = int(node["feature"])
            if real_f not in used:
                log.warning("forced split on filtered feature %d skipped",
                            real_f)
                continue
            inner = used.index(real_f)
            if bool(train_data.is_categorical[inner]):
                log.fatal("forced splits on categorical features are not "
                          "supported (feature %d)", real_f)
            tbin = int(train_data.mappers[real_f].value_to_bin(
                float(node["threshold"])))
            leaves.append(leaf)
            feats.append(inner)
            thrs.append(tbin)
            right_id = next_id
            next_id += 1
            if node.get("left"):
                queue.append((node["left"], leaf))
            if node.get("right"):
                queue.append((node["right"], right_id))
        n = min(len(leaves), self.max_leaves - 1)
        self.n_forced = n
        self.forced_leaf, self.forced_feat, self.forced_thr = [
            torch.as_tensor(np.asarray(a[:n], np.int64), device=self.device)
            for a in (leaves, feats, thrs)]
        if n:
            log.info("Loaded %d forced splits from %s", n, path)

    def _setup_cegb(self, config: Config) -> None:
        """CEGB's switch and per-feature costs (gbdt.py:1406-1440; ref:
        cost_effective_gradient_boosting.hpp:26 IsEnable), the penalties
        given per original column and indexed by the used features.
        ``cegb_used`` [F] bool and, under lazy penalties, ``cegb_used_rf``
        [n, F] bool live on the device and persist across trees (and
        across ``reset_config``, which re-reads the penalties)."""
        self.use_cegb_lazy = False
        coupled = list(config.cegb_penalty_feature_coupled or [])
        lazy = list(config.cegb_penalty_feature_lazy or [])
        self.use_cegb = (config.cegb_tradeoff < 1.0
                         or config.cegb_penalty_split > 0.0
                         or bool(coupled) or bool(lazy))
        if not self.use_cegb:
            return
        ds = self.train_data
        F = ds.num_features

        def per_inner(pens):
            out = np.zeros(F, np.float32)
            for real_f, pen in enumerate(pens):
                if real_f in ds.used_features:
                    out[ds.used_features.index(real_f)] = pen
            return torch.as_tensor(out, device=self.device)
        self.cegb_coupled = per_inner(coupled)
        if not hasattr(self, "cegb_used"):
            self.cegb_used = torch.zeros(F, dtype=torch.bool,
                                         device=self.device)
        self.cegb_lazy = per_inner(lazy)
        self.use_cegb_lazy = bool((self.cegb_lazy > 0).any())
        if getattr(self, "group", None) is not None:
            self._drop_lazy_cegb()        # reset_config under ranks
        if self.use_cegb_lazy and not hasattr(self, "cegb_used_rf"):
            self.cegb_used_rf = torch.zeros((self.num_data, F),
                                            dtype=torch.bool,
                                            device=self.device)

    def _drop_lazy_cegb(self) -> None:
        """Under ranks the lazy penalties are dropped with the JAX
        package's warning (gbdt.py:1494-1500): their [n, F] bitmap is
        per row, and the distributed growers do not carry it."""
        if self.use_cegb_lazy:
            log.warning("cegb_penalty_feature_lazy keeps a per-(row, "
                        "feature) bitmap on one device and is not wired "
                        "into the distributed growers; dropping the lazy "
                        "penalties for this parallel run")
            self.use_cegb_lazy = False

    def _mark_cegb_used(self, tree: TreeArrays) -> None:
        """The features this tree split on join ``cegb_used``
        (gbdt.py:4718-4721), on the device: a max-scatter of the used nodes'
        features (unused nodes hold -1)."""
        sf = tree.split_feature.long()
        hit = self.cegb_used.to(torch.int32).scatter_reduce(
            0, sf.clamp(min=0), (sf >= 0).to(torch.int32), "amax")
        self.cegb_used = hit > 0

    def _setup_node_masks(self, config: Config,
                          train_data: BinnedDataset) -> None:
        """Interaction constraints (real feature indices, mapped to the
        inner ones) and feature_fraction_bynode (gbdt.py:326-341)."""
        ic = config.interaction_constraints
        bynode = float(config.feature_fraction_bynode)
        self.use_node_masks = bool(ic) or (0.0 < bynode < 1.0)
        self.node_masks: Optional[NodeMaskCfg] = None
        if not self.use_node_masks:
            return
        used = train_data.used_features
        inner_ic = [[used.index(int(f)) for f in g if int(f) in used]
                    for g in (ic or [])]
        self.node_masks = make_node_mask_cfg(
            train_data.num_features, inner_ic, bynode,
            int(config.feature_fraction_seed) + 12345, self.device)

    def _node_masks_for_iter(self) -> Optional[NodeMaskCfg]:
        """The node masks padded to the engine's feature width (the fused
        engine's F_oh; the XLA engine's is F), the key folded with the
        iteration so every tree draws fresh by-node samples
        (gbdt.py:2672-2698); the same key serves every class tree of the
        iteration."""
        nm = self.node_masks
        if nm is None:
            return None
        G, F = nm.group_feat.shape
        F_oh = self.fmask_full.shape[0]
        gf = torch.zeros((G, F_oh), dtype=torch.bool, device=self.device)
        gf[:, :F] = nm.group_feat
        gwf = torch.zeros(F_oh, dtype=torch.int32, device=self.device)
        gwf[:F] = nm.groups_with_f
        return NodeMaskCfg(gf, gwf, nm.bynode_k,
                           ref_random.fold_in(nm.key, self.iter))

    def _setup_engine(self, config: Config,
                      train_data: BinnedDataset) -> None:
        """Resolve ``tpu_engine`` and ``grow_policy`` as the JAX package
        does for the serial learner (gbdt.py:1956-2106, in its order), and
        build the engine's layout: ``use_fused``, ``use_frontier``, and
        otherwise the XLA engine with ``grow_policy`` "leafwise" or
        "depthwise". Never falls back."""
        engine = str(config.tpu_engine)
        if engine not in ("auto", "fused", "frontier", "xla"):
            log.fatal("unknown tpu_engine=%r (auto, fused, frontier or xla)",
                      engine)
        if engine == "auto":
            engine = "fused"
        if self.group is not None and engine == "frontier":
            # the frontier-v1 engine has no multi-chip path (gbdt.py:
            # 1976-1990)
            engine = "xla" if self.parallel_mode == "voting" else "fused"
            log.info("tree_learner=%s runs on the XLA or fused engines; "
                     "using %s", self.parallel_mode, engine)
        has_cat = bool(np.any(train_data.is_categorical))
        mono = self._monotone(train_data)
        self.use_mono_bounds = bool(np.any(mono != 0))
        self.mono_mode = "basic"
        if self.use_mono_bounds:
            method = str(config.monotone_constraints_method)
            if method in ("intermediate", "advanced"):
                self.mono_mode = method
        if self.n_forced > 0 and engine != "xla":
            log.info("forced splits use the leaf-wise XLA engine")
            engine = "xla"
        if self.use_bundles and engine == "frontier":
            log.info("feature bundling is not wired into the frontier-v1 "
                     "engine; using the fused engine")
            engine = "fused"
        if self.use_cegb and engine != "xla":
            log.info("cost-effective gradient boosting uses the depthwise "
                     "XLA engine")
            engine = "xla"
        self.use_fused = engine == "fused"
        self.use_frontier = (engine == "frontier"
                             and config.tpu_histogram_impl
                             in ("auto", "pallas"))
        if self.use_frontier and (has_cat or self.use_node_masks
                                  or self.use_mono_bounds):
            log.warning("tpu_engine=frontier supports neither categorical "
                        "features, monotone bounds, nor interaction/bynode "
                        "constraints; using the fused engine")
            self.use_frontier = False
            self.use_fused = True
        default_policy = ("depthwise" if (self.use_fused or self.use_frontier
                                          or self.use_cegb)
                          else "leafwise")
        policy = str(config.grow_policy)
        self.grow_policy = default_policy if policy == "auto" else policy
        if self.mono_mode == "advanced" and self.grow_policy != "leafwise":
            log.warning("monotone_constraints_method=advanced (segment "
                        "bound planes) runs on the leaf-wise grower; this "
                        "configuration uses intermediate instead")
            self.mono_mode = "intermediate"
        if self.use_cegb and self.grow_policy != "depthwise":
            log.warning("CEGB is implemented on the depthwise grower; "
                        "switching grow_policy")
            self.grow_policy = "depthwise"
        if self.use_bundles and self.n_forced > 0:
            if train_data.prebundled is not None:
                log.fatal("forced splits are not supported on sparse-built "
                          "(prebundled) datasets")
            log.warning("forced splits disable feature bundling")
            self.use_bundles = False
        if self.n_forced > 0 and self.grow_policy != "leafwise":
            log.warning("forced splits are implemented on the leaf-wise "
                        "grower; switching grow_policy")
            self.grow_policy = "leafwise"
        if self.n_forced > 0 and self.use_cegb:
            log.warning("CEGB penalties are not applied when forced splits "
                        "are enabled (leaf-wise grower); disabling CEGB")
            self.use_cegb = False
        if self.grow_policy != "depthwise":
            self.use_fused = self.use_frontier = False
        self._setup_plane_cuts(config)
        if self.use_frontier:
            self._init_frontier(train_data)
        elif self.use_fused:
            self._init_fused(train_data)
        else:
            self._init_xla(train_data)

    def _setup_plane_cuts(self, config: Config) -> None:
        """The histogram-plane cuts (gbdt.py:2107-2161): fused-engine
        features, each gated on its own; the other engines drop them and
        train unchanged."""
        qb = int(config.tpu_quantized_grad or 0)
        if qb not in (0, 8, 16):
            log.fatal("tpu_quantized_grad must be 0, 8 or 16; got %s", qb)
        adaptive = bool(config.tpu_adaptive_bins)
        scr = bool(config.tpu_gain_screening)
        if adaptive and self.use_bundles:
            # EFB already owns the packed flat axis (bundle columns)
            log.info("tpu_adaptive_bins is subsumed by feature bundling; "
                     "keeping the bundle layout")
            adaptive = False
        if adaptive and self.parallel_mode == "voting":
            # the fused vote exchanges whole feature rows of the padded
            # layout (gbdt.py:2130)
            log.info("tpu_adaptive_bins does not compose with the voting "
                     "exchange; keeping the padded layout")
            adaptive = False
        if not self.use_fused and (qb or adaptive or scr):
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

    def _init_xla(self, train_data: BinnedDataset) -> None:
        """The XLA engine's layout (gbdt.py ``bins_dev`` /
        ``bundle_bins_dev`` and ``meta``): the growers route on the
        dataset's bins ([n, F] uint8/uint16, or the [n, C] int16 bundle
        columns under bundles) and histogram through the kernel's int32
        feature-padded copy, made once here; the feature metadata is the
        dataset's, unpadded."""
        if self.use_bundles:
            self.xla_bins = self.bundle_bins_dev
            self.xla_hist_bins = hist_bins(self.bundle_bins_dev,
                                           self.bundle_col_bins)
        else:
            self.xla_bins = train_data.bins_dev
            self.xla_hist_bins = hist_bins(train_data.bins_dev,
                                           self.max_bins)
        self.xla_meta = self._padded_meta(train_data,
                                          train_data.num_features, 0)

    def _engine_meta(self) -> FeatureMeta:
        """The feature metadata of the engine's trees (its padded width)."""
        if self.use_frontier:
            return self.frontier_meta
        return self.fused_meta if self.use_fused else self.xla_meta

    def _init_fused(self, train_data: BinnedDataset) -> None:
        """Transposed, padded bin matrix + f_oh-padded feature metadata for
        the fused level kernels (gbdt.py _init_fused, single-process
        branches). Under bundles ``bins_T`` holds the C_oh bundle columns
        of Bc_p bins each (the kernel layout) while split search, pools
        and route tables stay on the logical [F_oh, Bp] layout, decoded
        through ``fused_bundle_cfg`` (its tables padded to F_oh, the
        padding features invalid everywhere)."""
        F = train_data.num_features
        F_oh, Bp = feature_layout(F, self.max_bins)
        R = self.num_data
        Rp = ((R + ROW_BLOCK - 1) // ROW_BLOCK) * ROW_BLOCK
        self.fused_packed = None
        self.fused_bundle_cols = 0
        self.fused_bundle_col_bins = 0
        self.fused_bundle_cfg = None
        if self.use_bundles:
            n_cols = self.bundle_bins_dev.shape[1]
            C_oh, Bc_p = feature_layout(n_cols, self.bundle_col_bins)
            Fp = max(C_oh, 8)
            dtype = torch.int8 if Bc_p <= 128 else torch.int16
            bins_T = torch.zeros((Fp, Rp), dtype=dtype, device=self.device)
            bins_T[:n_cols, :R] = self.bundle_bins_dev.t().to(dtype)
            self.fused_bundle_cols = C_oh
            self.fused_bundle_col_bins = Bc_p
            bc = self.bundle_cfg
            dev = self.device
            b_i = torch.arange(Bp, dtype=torch.int32, device=dev)[None, :]
            fi = torch.zeros((F_oh, Bp), dtype=torch.int32, device=dev)
            va = torch.zeros((F_oh, Bp), dtype=torch.bool, device=dev)
            db = torch.zeros(F_oh, dtype=torch.int32, device=dev)
            cof = torch.full((F_oh,), -1, dtype=torch.int32, device=dev)
            off = torch.zeros(F_oh, dtype=torch.int32, device=dev)
            fi[:F] = torch.clamp(bc.col_of_feat[:, None] * Bc_p
                                 + bc.offset_of_feat[:, None] + b_i,
                                 max=C_oh * Bc_p - 1)
            va[:F, :bc.valid.shape[1]] = bc.valid
            db[:F] = bc.default_bin
            cof[:F] = bc.col_of_feat
            off[:F] = bc.offset_of_feat
            self.fused_bundle_cfg = BundleCfg(
                flat_idx=fi, valid=va, default_bin=db, col_of_feat=cof,
                offset_of_feat=off)
        else:
            Fp = max(F_oh, 8)
            # int8 covers bins <= 127; larger max_bin needs int16
            dtype = torch.int8 if Bp <= 128 else torch.int16
            bins_T = torch.zeros((Fp, Rp), dtype=dtype, device=self.device)
            if F:
                src = train_data.bins_dev.t()
                if self.use_adaptive_bins:
                    # each feature's slab at its own pow2 width, bins_T's
                    # rows in the layout's width-class order (the logical
                    # order comes back at the plane decode)
                    self.fused_packed = packed_feature_layout(
                        train_data.num_bin_per_feat, self.max_bins,
                        f_oh=F_oh)
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

    @staticmethod
    def _monotone(train_data: BinnedDataset) -> np.ndarray:
        """[F] int32 direction of each used feature (the constraints are
        given per original column)."""
        mc = train_data.monotone_constraints
        if mc is None:
            return np.zeros(train_data.num_features, np.int32)
        return np.asarray(mc, np.int32)[train_data.used_features]

    def _padded_meta(self, train_data: BinnedDataset, width: int,
                     pad_num_bin: int) -> FeatureMeta:
        """Feature metadata padded to the engine's feature width, padding
        features at ``pad_num_bin`` bins; sets ``fmask_full``, the mask of
        the real features."""
        F = train_data.num_features

        def pad(a, fill=0, dtype=np.int32):
            out = np.full(width, fill, dtype)
            out[:F] = a
            return torch.as_tensor(out, device=self.device)
        self.fmask_full = torch.arange(width, device=self.device) < F
        # the categorical features' indices: None turns their scan off
        cat = np.nonzero(train_data.is_categorical)[0]
        self.cat_idx = (torch.as_tensor(cat, device=self.device)
                        if len(cat) else None)
        return FeatureMeta(
            num_bin=pad(train_data.num_bin_per_feat, pad_num_bin),
            missing_type=pad(train_data.missing_types),
            default_bin=pad(train_data.default_bins()),
            monotone=pad(self._monotone(train_data)),
            is_cat=pad(train_data.is_categorical, False, bool))

    # ------------------------------------------------------------------
    def _boost_from_average(self, class_id: int = 0) -> float:
        """(ref: gbdt.cpp:346 BoostFromAverage) — first iteration only,
        and not over init scores; adds the class's score to its row."""
        cfg = self.config
        if self.models or self.has_init_score or self.objective is None:
            return 0.0
        if not (cfg.boost_from_average or self.train_data.num_features == 0):
            if self.objective.name in ("regression_l1", "quantile", "mape"):
                log.warning("Disabling boost_from_average in %s may cause "
                            "the slow convergence", self.objective.name)
            return 0.0
        init_score = self.objective.boost_from_score(class_id)
        if abs(init_score) > K_EPSILON:
            self._add_constant(init_score, class_id)
            log.info("Start training from score %f", init_score)
            return init_score
        return 0.0

    def _add_constant(self, value: float, class_id: int = 0) -> None:
        """Add ``value`` (as f32) to class ``class_id``'s training and
        valid scores."""
        c = torch.tensor(value, dtype=torch.float32)
        self.scores[class_id] += c
        for vs in self.valid_scores:
            vs[class_id] += c

    # ---------------------------------------------------- bagging, columns
    def _set_bag(self, mask: Optional[np.ndarray]) -> None:
        """The in-bag rows: ``mask`` [n] bool, None for every row. The host
        copy serves leaf renewal, which reads in-bag rows on the host."""
        n = self.num_data
        self._bag_host = np.ones(n, bool) if mask is None else mask
        self.bag_cnt = n if mask is None else int(mask.sum())
        self.bag_weight = (torch.ones(n, dtype=torch.float32,
                                      device=self.device)
                           if mask is None else
                           torch.as_tensor(mask.astype(np.float32),
                                           device=self.device))

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
                label = (self._mp_metadata.label if self.mp is not None
                         else self.train_data.metadata.label)
                frac = np.where(label > 0,
                                np.float64(cfg.pos_bagging_fraction),
                                np.float64(cfg.neg_bagging_fraction))
            else:
                frac = np.float64(cfg.bagging_fraction)
            cache[fire] = draws < frac
            for old in [key for key in cache
                        if key < fire - cfg.bagging_freq]:
                del cache[old]
        if self.mp is not None:
            # every rank drew the global rows; it keeps its own
            return self.mp.local_block(cache[fire])
        return cache[fire]

    def _bagging(self, it: int, grad=None, hess=None):
        """Renew the in-bag weights when a round fires at ``it`` (ref:
        gbdt.cpp:230 Bagging); returns the gradients, which GOSS scales."""
        cfg = self.config
        if not self.is_bagging or it % cfg.bagging_freq != 0:
            return grad, hess
        self._set_bag(self._bag_mask_for(it))
        log.debug("Re-bagging, using %d data to train", self.bag_cnt)
        return grad, hess

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

    def _gain_vec(self, split_feature: torch.Tensor,
                  split_gain: torch.Tensor) -> torch.Tensor:
        """[F_oh] realized split gains of one tree's (or one iteration's
        concatenated) nodes (gbdt.py:162); unused nodes (feature -1, gain
        0) add nothing."""
        sg = split_gain.to(torch.float32)
        ok = (split_feature >= 0) & torch.isfinite(sg) & (sg > 0)
        F_oh = self._gain_ema.shape[0]
        return torch.zeros_like(self._gain_ema).index_add_(
            0, split_feature.clamp(0, F_oh - 1).long(),
            torch.where(ok, sg, 0.0))

    def _update_gain_ema(self, gains: torch.Tensor) -> None:
        """Once per iteration, from the iteration's realized split gains
        (gbdt.py:164, 2775, 3432-3438)."""
        a = float(self.config.tpu_screening_ema_alpha)
        self._gain_ema = a * self._gain_ema + (1.0 - a) * gains

    def _quant_seed(self, it: int, tid: int = 0) -> int:
        """Stochastic-rounding dither seed of iteration ``it``'s class tree
        ``tid``, the JAX package's stream, so identical reruns are
        byte-identical."""
        return (it * self.num_tree_per_iteration + tid) & 0xFFFFFFFF

    # ------------------------------------------------------ iteration bodies
    def _grow(self, gh_T, fmask, root_hist=None, defer=False, scales=None,
              node_masks=None):
        return grow_tree_fused(
            self.fused_bins_T, gh_T, self.fused_meta, fmask, self.params,
            self.max_leaves, self.fused_Bp, self.fused_f_oh,
            num_rows=self.num_data, nch=self.fused_nch,
            max_depth=int(self.config.max_depth),
            extra_levels=int(self.config.tpu_extra_levels),
            root_hist=root_hist, defer_final_route=defer,
            quant_bits=self.quant_bits, packed=self.fused_packed,
            mask_onehot=self.use_screening and not self.use_bundles,
            gh_scales=scales, node_masks=node_masks, cat_idx=self.cat_idx,
            bundle_cols=self.fused_bundle_cols,
            bundle_col_bins=self.fused_bundle_col_bins,
            bundle_cfg=self.fused_bundle_cfg,
            use_mono_bounds=self.use_mono_bounds, mono_mode=self.mono_mode,
            group=self.group, parallel_mode=self.parallel_mode,
            top_k=self.top_k)

    def arm_megastep(self, on: bool = True) -> None:
        """Permission from a training loop (``engine.train``) to run the
        megastep body; a bare ``Booster.update`` takes the epilogue body
        wherever it applies."""
        self._megastep_armed = bool(on)

    def _use_epilogue(self) -> bool:
        """The epilogue body applies: an objective with a closed form the
        kernel implements (binary, l2), ``tpu_fused_epilogue``, one tree
        per iteration (under a group its next root histogram is summed
        over the ranks before the next tree reads it), and no
        histogram-plane cut (its kernel builds f32 padded root histograms,
        and screening's mask must reach the next root; gbdt.py:3487)."""
        return bool(self._epi_spec is not None
                    and self.use_fused
                    and self.config.tpu_fused_epilogue
                    and self.num_tree_per_iteration == 1
                    and not self.quant_bits
                    and not self.use_adaptive_bins
                    and not self.use_screening)

    def _fast_path_reason(self) -> Optional[str]:
        """What keeps training on the synchronous body (the JAX package's
        ``_fast_path_reason``, gbdt.py:3185-3228, for the features the port
        has), or None where the megastep and epilogue bodies may run."""
        if type(self) is not GBDT:
            return f"boosting:{self.name}"
        if not bool(self.config.tpu_fast_path):
            return "config:tpu_fast_path=false"
        if not self.use_fused:
            return f"engine:{self.config.tpu_engine}"
        obj = self.objective
        if obj is None:
            return "fobj"
        if obj.is_renew_tree_output:
            return f"objective_leaf_renewal:{obj.name}"
        if bool(self.config.linear_tree):
            return "config:linear_tree"
        if self.use_cegb:
            return "config:cegb"
        if self.n_forced:
            return "config:forcedsplits_filename"
        if self.use_node_masks:
            return "config:interaction_constraints/feature_fraction_bynode"
        if not all(self.class_need_train):
            return f"objective_class_skip:{obj.name}"
        return None

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """One boosting iteration; True when training must stop (no split
        met the requirements — ref: gbdt.cpp:421-445). ``gradients`` and
        ``hessians`` ([k * n] each, class-major, from a custom objective)
        and every case of ``_fast_path_reason`` (the frontier and XLA
        engines among them) take the synchronous body."""
        if self._faults:
            from ..resilience import faults
            faults.on_training_step(self)    # crash and hang chaos hooks
        if gradients is not None and hessians is not None:
            return self._sync_iter_body(gradients, hessians)
        if self.objective is None:
            log.fatal("Cannot train without an objective: pass a "
                      "built-in objective or supply gradients via "
                      "Booster.update(fobj=...)")
        if self._fast_path_reason() is not None:
            return self._sync_iter_body()
        if not self._megastep_armed and self._use_epilogue():
            return self._epi_iter_body()
        self._epi_carry = None   # this body updates the scores in place
        return self._fused_iter_body()

    def _fused_iter_body(self) -> bool:
        """The megastep body: gradients from the scores once, then for each
        of the k class trees the bag-weighted gh pack (quantized under
        ``tpu_quantized_grad``, dither seed per class), fused growth under
        its feature mask (and the iteration's screening mask) and its score
        delta; the gain EMA updates once per iteration (the serial branch
        of the JAX package's ``_make_fused_tree_loop``, ``grow_k_trees``)."""
        k, n = self.num_tree_per_iteration, self.num_data
        init_scores = [self._boost_from_average(tid) for tid in range(k)]
        self._bagging(self.iter)
        # column draws in the JAX package's order: iteration-major, then
        # class tree
        fmasks = [self._feature_mask_pad() for _ in range(k)]
        smask = (self._screening_mask(self._screening_explore(self.iter))
                 if self.use_screening else None)
        grad, hess = self.objective.get_gradients(self.scores)
        w = self.bag_weight
        trees = []
        for tid in range(k):
            fm = fmasks[tid] if smask is None else fmasks[tid] & smask
            gh_T, scales = self._pack(grad[tid] * w, hess[tid] * w, w, tid)
            tree, row_leaf = self._grow(gh_T, fm, scales=scales)
            if tree.num_leaves > 1:
                self.scores[tid] += tree_score_delta(
                    tree, row_leaf, self.shrinkage_rate, num_rows=n)
            trees.append(tree)
        if self.use_screening:
            self._update_gain_ema(self._gain_vec(
                torch.cat([t.split_feature for t in trees]),
                torch.cat([t.split_gain for t in trees])))
        return self._finish_fast_iter(trees, init_scores)

    def _pack(self, g, h, w, tid: int = 0):
        """Row-padded gh block (quantized under ``tpu_quantized_grad``)
        and its scales (None unquantized)."""
        gh = [self._pad_rows(x) for x in (g, h, w)]
        if self.quant_bits:
            return pack_gh_quant(
                *gh, self.quant_bits, seed=self._quant_seed(self.iter, tid),
                row_offset=self.mp.offset if self.mp is not None else 0,
                group=self.group)
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
        k_F, k_B = self._kernel_layout()
        hist0, score2, gh_next = epilogue_pass(
            self.fused_bins_T, row_leaf[None, :], W_last, tbl_last, lv,
            score_pad, ops, bag_next[None, :], num_bins=k_B, f_oh=k_F,
            nch=self.fused_nch, kind=kind, sigmoid=float(sig))
        if self.group is not None:
            # the next root histogram holds this rank's rows only: sum it
            # before the next tree reads it (a full exchange, as the root)
            hist0 = record_psum(hist0, self.group)
        self._epi_carry = (score2, hist0, gh_next)
        self.scores = score2[:, :n]
        return self._finish_fast_iter([tree], [init_score])

    def _finish_fast_iter(self, trees: List[TreeArrays],
                          init_scores: List[float]) -> bool:
        """Host bookkeeping of one iteration of the megastep or epilogue
        body, whose score deltas are already applied (the JAX package's
        ``_finish_fast_iter`` and its drain, gbdt.py:3726-3917): True, with
        no model appended past the first, when no class grew a split.
        Otherwise the valid scores take each grown tree's f32 ``leaf_value
        * shrinkage``, a class that grew nothing gets a constant tree (in
        the first iteration carrying its init score, added to the scores
        once more, as the reference does: gbdt.cpp:421-437), and the host
        trees carry the init score as their bias."""
        k = len(trees)
        if all(t.num_leaves <= 1 for t in trees):
            self._epi_carry = None
            if not self.models:
                for tid in range(k):
                    ht = HostTree(1)
                    ht.leaf_value[0] = init_scores[tid]
                    self._add_constant(init_scores[tid], tid)
                    self.models.append(ht)
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            return True
        self._update_valid_from_trees(trees)
        for tid, tree in enumerate(trees):
            if tree.num_leaves <= 1:
                ht = HostTree(1)
                if len(self.models) < k:
                    ht.leaf_value[0] = init_scores[tid]
                    self._add_constant(init_scores[tid], tid)
                self.models.append(ht)
                continue
            ht = self._to_host_tree(tree)
            ht.apply_shrinkage(self.shrinkage_rate)
            if abs(init_scores[tid]) > K_EPSILON:
                ht.add_bias(init_scores[tid])
            self.models.append(ht)
        self.iter += 1
        return False

    def _sync_iter_body(self, gradients=None, hessians=None) -> bool:
        """The synchronous body (gbdt.py:4649-4800): the objective's
        gradients (after ``boost_from_average`` per class, through the
        ``_get_gradients`` hook) or the caller's ``[k, n]``, then
        ``_bagging``, then per class its tree through the engine's grower,
        the host tree, the linear leaves (``linear_tree``), leaf renewal,
        float64 shrinkage, the f32 leaf values added to the training scores
        per row (``table_lookup``; a linear tree's per-row outputs instead)
        and to the valid scores, then the bias. A class that grows nothing
        gets a constant tree; True when no class grew a split (the
        iteration's trees are then dropped, past the first)."""
        self._epi_carry = None   # the scores change outside the carry
        k, n = self.num_tree_per_iteration, self.num_data
        obj = self.objective
        init_scores = [0.0] * k
        if gradients is None or hessians is None:
            if obj is None:
                log.fatal("Cannot train without an objective: pass a "
                          "built-in objective or supply gradients via "
                          "Booster.update(fobj=...)")
            init_scores = [self._boost_from_average(tid) for tid in range(k)]
            grad, hess = self._get_gradients()
        else:
            grad, hess = [torch.as_tensor(
                np.asarray(a, np.float32).reshape(k, n), device=self.device)
                for a in (gradients, hessians)]
        grad, hess = self._bagging(self.iter, grad, hess)
        should_continue = False
        gains = None
        for tid in range(k):
            tree = None
            if self.class_need_train[tid] \
                    and self.train_data.num_features > 0:
                tree, row_leaf, lookup = self._grow_sync(grad[tid],
                                                         hess[tid], tid)
                if self.use_screening:
                    g = self._gain_vec(tree.split_feature, tree.split_gain)
                    gains = g if gains is None else gains + g
            if tree is not None and tree.num_leaves > 1:
                should_continue = True
                ht = self._to_host_tree(tree)
                if self.use_cegb:
                    self._mark_cegb_used(tree)
                if bool(self.config.linear_tree):
                    self._fit_linear_leaves(ht, row_leaf, grad[tid],
                                            hess[tid])
                if obj is not None and obj.is_renew_tree_output:
                    self._renew_tree_output(ht, row_leaf, tid)
                # shrinkage then score update (ref: gbdt.cpp:414-419)
                ht.apply_shrinkage(self.shrinkage_rate)
                if ht.is_linear:
                    self._add_linear_tree(ht, row_leaf, tid)
                else:
                    lv = torch.as_tensor(ht.leaf_value.astype(np.float32),
                                         device=self.device)
                    self.scores[tid] += lookup(lv, row_leaf)
                    for vd, vs in zip(self.valid_data, self.valid_scores):
                        vs[tid] = self._add_host_tree(
                            vs[tid], vd.bins_dev, ht,
                            bundle=self._bundle_of(vd))
                if abs(init_scores[tid]) > K_EPSILON:
                    ht.add_bias(init_scores[tid])
                self.models.append(ht)
                continue
            # constant tree (ref: gbdt.cpp:422-441)
            ht = HostTree(1)
            if len(self.models) < k:
                output = init_scores[tid]
                if not self.class_need_train[tid]:
                    output = (obj.boost_from_score(tid) if obj is not None
                              else 0.0)
                ht.leaf_value[0] = output
                self._add_constant(output, tid)
            self.models.append(ht)
        if not should_continue:
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            if len(self.models) > k:
                del self.models[-k:]
            return True
        if gains is not None:
            self._update_gain_ema(gains)
        if self._faults:
            from ..resilience import faults
            faults.maybe_diverge(self, self.iter)   # chaos: this rank
        self.iter += 1
        return False

    def _get_gradients(self):
        """The objective's gradients at the training scores (the JAX
        package's ``_boosting_scores``/``_get_gradients``, gbdt.py:
        2426-2433): the hook where DART drops trees and RF returns its
        fixed gradients."""
        return self.objective.get_gradients(self.scores)

    def _fit_linear_leaves(self, ht: HostTree, row_leaf: torch.Tensor,
                           grad: torch.Tensor, hess: torch.Tensor) -> None:
        """Linear leaves of a new tree (gbdt.py:3018-3074): a per-leaf
        ridge on the raw values of the numerical columns of its root path
        (``ops.linear.fit_linear_leaves``, on the device), in-bag rows
        only; the first iteration's trees keep constants only. The path's
        columns are the host tree's real ones and a column is categorical
        by its own bin mapper (the JAX package reads both as inner
        indices: see ``ops/linear.py``)."""
        ds = self.train_data
        if ds.raw_data is None:
            log.warning("linear_tree needs retained raw data; keeping "
                        "constant leaves")
            return
        ht.is_linear = True
        L = ht.num_leaves
        ht.leaf_const = ht.leaf_value.astype(np.float64).copy()
        ht.leaf_features = [[] for _ in range(L)]
        ht.leaf_coeff = [[] for _ in range(L)]
        if len(self.models) < self.num_tree_per_iteration:
            return   # first tree: constants only (ref: is_first_tree)
        paths = [[f for f in p
                  if ds.mappers[f].bin_type != BIN_CATEGORICAL]
                 for p in ht.branch_features()]
        fits = fit_linear_leaves(ds.raw_data, row_leaf, grad, hess,
                                 self.bag_weight > 0, paths,
                                 float(self.config.linear_lambda))
        host_syncs["count"] += 1
        for leaf, fit in enumerate(fits):
            if fit is not None:
                ht.leaf_features[leaf], ht.leaf_coeff[leaf], \
                    ht.leaf_const[leaf] = fit

    def _add_linear_tree(self, ht: HostTree, row_leaf: torch.Tensor,
                         tid: int) -> None:
        """A shrunk linear tree's outputs added to the scores
        (gbdt.py:4730-4760): each training row's, by its leaf, in float64
        and added as f32; a valid set's from its own raw rows where it
        kept them, else the binned replay of the constant leaves."""
        self.scores[tid] += linear_leaf_outputs(
            ht, self.train_data.raw_data, row_leaf).float()
        for vd, vs in zip(self.valid_data, self.valid_scores):
            if vd.raw_data is not None:
                vs[tid] += tree_outputs(ht, vd.raw_data.double()).float()
            else:
                vs[tid] = self._add_host_tree(vs[tid], vd.bins_dev, ht,
                                              bundle=self._bundle_of(vd))

    def _grow_sync(self, g, h, tid: int):
        """One class tree of the synchronous body on the engine's grower:
        (tree, row_leaf [n], lookup(leaf_values, row_leaf) -> [n])."""
        n = self.num_data
        w = self.bag_weight
        if not (self.use_fused or self.use_frontier):
            tree, row_leaf = self._grow_xla(
                torch.stack([g * w, h * w, w], 1))
            return tree, row_leaf, (
                lambda lv, rl: table_lookup(rl[None, :], lv)[0])
        if self.use_frontier:
            gh3 = torch.stack([g * w, h * w, w], 1)
            tree, row_leaf = grow_tree_frontier(
                self.bins_i32, gh3, self.frontier_meta,
                self._feature_mask_pad(), self.params, self.max_leaves,
                self.frontier_Bp, int(self.config.max_depth),
                group=self.group)
            return tree, row_leaf, (lambda lv, rl: leaf_value_lookup(
                lv, rl, self.max_leaves))
        fmask = self._feature_mask_pad()
        if self.use_screening:
            smask = self._screening_mask(self._screening_explore(self.iter))
            if smask is not None:
                fmask = fmask & smask
        gh_T, scales = self._pack(g * w, h * w, w, tid)
        tree, row_leaf = self._grow(gh_T, fmask, scales=scales,
                                    node_masks=self._node_masks_for_iter())
        return tree, row_leaf[:n], (
            lambda lv, rl: table_lookup(rl[None, :], lv)[0])

    def _grow_xla(self, gh3: torch.Tensor):
        """One tree of the XLA engine (gbdt.py:2628-2670): the depth-wise
        grower, with CEGB, or the leaf-wise one, with forced splits, on
        ``gh3`` [n, 3]; the lazy CEGB bitmap carried to the next tree."""
        common = dict(
            hist_impl=self._xla_hist_impl(), cat_idx=self.cat_idx,
            use_mono_bounds=self.use_mono_bounds,
            node_masks=self._node_masks_for_iter(),
            bundle_cfg=self.bundle_cfg if self.use_bundles else None,
            bundle_col_bins=self.bundle_col_bins if self.use_bundles else 0,
            mono_mode=self.mono_mode, hist_bins_i32=self.xla_hist_bins,
            group=self.group, parallel_mode=self.parallel_mode,
            top_k=self.top_k)
        args = (self.xla_bins, gh3, self.xla_meta, self._feature_mask_pad(),
                self.params, self.max_leaves, self.max_bins,
                int(self.config.max_depth))
        if self.grow_policy == "depthwise":
            lazy = self.use_cegb and self.use_cegb_lazy
            out = grow_tree_depthwise(
                *args, use_cegb=self.use_cegb,
                cegb_coupled=self.cegb_coupled if self.use_cegb else None,
                cegb_used=self.cegb_used if self.use_cegb else None,
                use_cegb_lazy=lazy,
                cegb_lazy=self.cegb_lazy if lazy else None,
                cegb_used_rf=self.cegb_used_rf if lazy else None, **common)
            if lazy:
                tree, row_leaf, self.cegb_used_rf = out
                return tree, row_leaf
            return out
        f = self.n_forced > 0
        return grow_tree_leafwise(
            *args, forced_leaf=self.forced_leaf if f else None,
            forced_feat=self.forced_feat if f else None,
            forced_thr=self.forced_thr if f else None, **common)

    def _xla_hist_impl(self) -> str:
        """The XLA growers' histogram formulation (gbdt.py:2697-2699):
        ``tpu_histogram_impl``, pallas read as auto."""
        impl = str(self.config.tpu_histogram_impl)
        return "auto" if impl in ("auto", "pallas") else impl

    def _renew_tree_output(self, ht: HostTree, row_leaf: torch.Tensor,
                           class_id: int, base: float = None) -> None:
        """Leaf renewal for the L1 family (ref: serial_tree_learner.cpp:717
        RenewTreeOutput; gbdt.py:2933-3015): each leaf's value from the
        float64 residuals of its in-bag rows (``_bag_host``: GOSS's
        rank-local mask, or this rank's slice of the bagging draw), grouped
        by one stable argsort. The residuals are against the class's scores
        (two host copies: the scores and the row leaves), or against the
        constant ``base`` (RF, rf.hpp:135-139; one copy).

        Under a rank layout a leaf's value is the AVERAGE of the rank-local
        renewed outputs over the ranks that hold in-bag rows in it, the
        reference's own distributed semantics (serial_tree_learner.cpp:
        744-755: the local RenewTreeOutput, then GlobalSum(outputs) /
        GlobalSum(nonzero)), not a global percentile: one host gather of
        [outputs, nonzero] in float64 per tree, on every rank, even one
        without rows. With one rank that average is the rank's own
        output."""
        obj = self.objective
        mp = self.mp
        label = self.train_data.metadata.label
        if base is None:
            score = self.scores[class_id].double().cpu().numpy()
            host_syncs["count"] += 1
        else:
            score = base
        rl = row_leaf.cpu().numpy()
        host_syncs["count"] += 1
        residual = label.astype(np.float64) - score
        L = ht.num_leaves
        outputs = np.zeros(L, np.float64)
        nonzero = np.zeros(L, np.float64)
        # the objective's weights are the gathered global ones under ranks
        offset = mp.offset if mp is not None else 0
        sel = np.nonzero(self._bag_host)[0]
        order = sel[np.argsort(rl[sel], kind="stable")]
        starts = np.searchsorted(rl[order], np.arange(L + 1))
        for leaf in range(L):
            rows = order[starts[leaf]:starts[leaf + 1]]
            if len(rows):
                outputs[leaf] = obj.renew_tree_output(
                    ht.leaf_value[leaf], residual[rows], rows + offset)
                nonzero[leaf] = 1.0
        if mp is not None:
            allg = mp._allgather(np.concatenate([outputs, nonzero]))
            allg = allg.reshape(mp.process_count, 2, L)
            outputs = allg[:, 0, :].sum(axis=0)
            nonzero = allg[:, 1, :].sum(axis=0)
        ht.leaf_value[:L] = np.where(
            nonzero > 0, outputs / np.maximum(nonzero, 1),
            np.asarray(ht.leaf_value[:L], np.float64))

    def _kernel_layout(self) -> Tuple[int, int]:
        """(kernel rows, bins per kernel row) of ``bins_T``: the bundle
        columns and Bc_p under bundles, else F_oh and Bp (gbdt.py:3518)."""
        if self.fused_bundle_cols:
            return self.fused_bundle_cols, self.fused_bundle_col_bins
        return self.fused_f_oh, self.fused_Bp

    def _fast_tree_depth_bound(self) -> int:
        """Routing steps that cover any tree of the fused grower: one per
        scheduled level pass, plus one (gbdt.py:3238-3249; the slot cap
        from the kernel's flat width, bundle columns under bundles)."""
        k_F, k_B = self._kernel_layout()
        caps = level_caps(self.max_leaves, int(self.config.max_depth),
                          int(self.config.tpu_extra_levels),
                          slot_cap=max_slot_cap(k_F * k_B, self.fused_nch))
        return len(caps) + 1

    def _update_valid_from_trees(self, trees: List[TreeArrays]) -> None:
        """The fused bodies' valid update (gbdt.py:3252-3281
        ``_make_valid_apply``): every valid row routed through each class's
        device tree, plus its f32 ``leaf_value * shrinkage``; a class that
        grew nothing adds nothing; no host read."""
        if not self.valid_scores:
            return
        shrink = torch.tensor(self.shrinkage_rate, dtype=torch.float32)
        steps = self._fast_tree_depth_bound()
        m = self.fused_meta
        for tid, tree in enumerate(trees):
            if tree.num_leaves <= 1:
                continue
            lv = tree.leaf_value * shrink
            cat = ((tree.cat_flag, tree.cat_mask) if self.cat_idx is not None
                   else (None, None))
            for vd, vs in zip(self.valid_data, self.valid_scores):
                vs[tid] = add_tree_score(
                    vs[tid], vd.bins_dev, lv, tree.split_feature,
                    tree.threshold_bin, tree.default_left, tree.left_child,
                    tree.right_child, m.num_bin, m.missing_type,
                    m.default_bin, steps, *cat, self._bundle_of(vd))

    def _add_host_tree(self, score: torch.Tensor, bins: torch.Tensor,
                       ht: HostTree, scale: float = 1.0,
                       bundle: tuple = None) -> torch.Tensor:
        """``score + scale * leaf_value[route(row)]`` of a host tree on
        binned rows, its leaf values as f32 (gbdt.py:3077
        ``_add_tree_to_score``); categorical nodes route through their
        bitsets decoded into bins (``_host_cat_bins``). ``bundle`` is
        ``_replay_bundle`` where ``bins`` holds the bundle columns of a
        sparse-built training set, None for logical bins."""
        if ht.num_leaves <= 1:
            # the scaled constant in float64, added as f32 (gbdt.py:3082)
            return score + float(np.float32(ht.leaf_value[0])) * scale
        lv = torch.as_tensor(np.asarray(ht.leaf_value, np.float32),
                             device=self.device)
        if scale != 1.0:
            lv = lv * scale
        return score + lv[self._host_tree_leaves(bins, ht, bundle)]

    def _host_tree_leaves(self, bins: torch.Tensor, ht: HostTree,
                          bundle: tuple = None) -> torch.Tensor:
        """[n] int64 leaf of every binned row in a host tree of more than
        one leaf (the bin router, ``ops.predict``), as ``_add_host_tree``
        routes them."""
        ni = ht.num_internal
        inner = [self.train_data.used_features.index(int(f))
                 for f in ht.split_feature[:ni]]

        def t(a, dt=torch.int64):
            return torch.as_tensor(np.asarray(a), dtype=dt,
                                   device=self.device)
        meta = self._engine_meta()
        cat = self._host_cat_bins(ht, inner)
        cat = (None, None) if cat is None else [t(a, torch.bool)
                                                 for a in cat]
        return route_binned_rows_to_leaves(
            bins, t(inner), t(ht.threshold_bin[:ni]),
            t((ht.decision_type[:ni] & 2) != 0, torch.bool),
            t(ht.left_child[:ni]), t(ht.right_child[:ni]),
            meta.num_bin, meta.missing_type, meta.default_bin,
            tree_depth(ht.left_child, ht.right_child), *cat, bundle)

    def _host_cat_bins(self, ht: HostTree, inner: List[int]):
        """(cat_flag [N], cat_mask [N, Bp]) of a host tree in bin space:
        bin b of a categorical node goes left iff its category's bit is
        set (gbdt.py:5223-5235, ``_device_tree_from_host``); None when no
        node is categorical."""
        ni = ht.num_internal
        flag = (np.asarray(ht.decision_type[:ni]) & 1) != 0
        if not flag.any():
            return None
        ds = self.train_data
        Bp = (self.frontier_Bp if self.use_frontier else
              self.fused_Bp if self.use_fused else self.max_bins)
        mask = np.zeros((ni, Bp), bool)
        for i in np.nonzero(flag)[0]:
            words = ht.cat_bitset(i)
            m = ds.mappers[ds.real_feature_index(inner[i])]
            for b, c in enumerate(m.bin_2_categorical):
                if c >= 0 and c // 32 < len(words) \
                        and (words[c // 32] >> (c % 32)) & 1:
                    mask[i, b] = True
        return flag, mask

    def rollback_one_iter(self) -> None:
        """Drop the last iteration's k trees and subtract them from the
        training and valid scores (ref: gbdt.cpp:456 RollbackOneIter). The
        epilogue carry is dropped, so the next iteration primes again; the
        bag round cache is kept, so a retrain replays the round it used."""
        self._epi_carry = None
        if self.iter <= 0:
            return
        k = self.num_tree_per_iteration
        for tid in range(k):
            ht = self.models[len(self.models) - k + tid]
            self.scores[tid] = self._add_host_tree(
                self.scores[tid], self.train_data.bins_dev, ht, -1.0,
                self._bundle_of(self.train_data))
            for vd, vs in zip(self.valid_data, self.valid_scores):
                vs[tid] = self._add_host_tree(vs[tid], vd.bins_dev, ht, -1.0,
                                              self._bundle_of(vd))
        del self.models[-k:]
        self.iter -= 1

    def adopt_init_models(self, host_trees: List[HostTree]) -> None:
        """Install already-trained trees as the init segment (the JAX
        package's ``adopt_init_models``, gbdt.py:5254-5267): prepended to
        the models, their scores not replayed, as the reference replays
        only the iterations after the init ones (ref: gbdt.cpp:715)."""
        k = self.num_tree_per_iteration
        if len(host_trees) % k:
            log.fatal("cannot adopt %d trees with %d trees per iteration",
                      len(host_trees), k)
        self.models[:0] = host_trees
        self.num_init_iteration += len(host_trees) // k

    def refit_by_leaf_preds(self, leaf_preds: np.ndarray) -> None:
        """Refit every tree's leaf values on the training data from a
        [num_data, num_models] leaf-assignment matrix (ref: gbdt.cpp:287
        RefitTree, serial_tree_learner.cpp:212 FitByExistingTree; the JAX
        package's gbdt.py:5269-5327): the scores start at the init score;
        each iteration's gradients are the objective's at the f32 running
        scores; each leaf's output is the Newton value of its float64
        gradient sums (taken in f32, as the JAX package's
        ``calculate_leaf_output`` on its device), blended with
        ``refit_decay_rate``, and added back into the float64 scores."""
        k = self.num_tree_per_iteration
        n = self.num_data
        n_models = len(self.models)
        if leaf_preds.shape != (n, n_models):
            log.fatal("leaf_preds shape %s does not match "
                      "[num_data=%d, num_models=%d]",
                      leaf_preds.shape, n, n_models)
        decay = float(self.config.refit_decay_rate)
        md = self.train_data.metadata
        if md.init_score is not None:
            init = np.asarray(md.init_score, np.float64)
            scores = (init.reshape(k, n) if init.size == n * k
                      else np.tile(init.reshape(1, n), (k, 1)))
        else:
            scores = np.zeros((k, n), np.float64)
        for it in range(n_models // k):
            if self.objective is not None:
                g, h = self.objective.get_gradients(torch.as_tensor(
                    scores.astype(np.float32), device=self.device))
                g = g.double().cpu().numpy().reshape(k, n)
                h = h.double().cpu().numpy().reshape(k, n)
            else:
                g = scores - np.asarray(md.label, np.float64)[None, :]
                h = np.ones_like(g)
            for tid in range(k):
                mi = it * k + tid
                ht = self.models[mi]
                L = ht.num_leaves
                lp = leaf_preds[:, mi]
                if int(lp.max(initial=0)) >= L or int(lp.min(initial=0)) < 0:
                    log.fatal("leaf_preds column %d references leaf %d of "
                              "a %d-leaf tree", mi, int(lp.max()), L)
                sum_g = np.bincount(lp, weights=g[tid], minlength=L)
                # the kEpsilon floor of FitByExistingTree's sum_hess
                sum_h = np.bincount(lp, weights=h[tid], minlength=L) + 1e-15
                out = calculate_leaf_output(
                    torch.as_tensor(sum_g, dtype=torch.float32),
                    torch.as_tensor(sum_h, dtype=torch.float32),
                    self.params).double().numpy()
                new_vals = (decay * np.asarray(ht.leaf_value, np.float64)
                            + (1.0 - decay) * out * float(ht.shrinkage))
                ht.leaf_value[:] = new_vals[:len(ht.leaf_value)]
                scores[tid] += new_vals[lp]
        self.scores = torch.as_tensor(scores.astype(np.float32),
                                      device=self.device)
        self._epi_carry = None

    def reset_config(self, config: Config) -> None:
        """Re-derive the training state from an updated config (ref:
        gbdt.cpp:686-839 ResetConfig/ResetBaggingConfig; the JAX
        package's ``reset_config``): shrinkage, leaves, split parameters,
        the CEGB costs and the forced-split schedule, the engine's layout,
        and the bagging state, whose per-block streams are drawn anew."""
        self._check_ported(config)
        self.config = config
        self.shrinkage_rate = float(config.learning_rate)
        self.max_leaves = max(2, int(config.num_leaves))
        self.params = split_params_from_config(config)
        self._epi_carry = None
        self._setup_resilience(config)
        self._setup_cegb(config)
        self._setup_forced_splits(config, self.train_data)
        self._setup_engine(config, self.train_data)
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
            self._set_bag(None)
        self.bag_streams = ref_random.BlockBaggingStreams(
            int(config.bagging_seed), self._bag_rows())
        self._bag_round_cache = {}

    def eval_metric_set(self, ds_name: str, metrics, score_dev):
        """[(ds_name, metric_name, value, is_higher_better)] of one score
        set (gbdt.py:5063): each metric's device form on ``score_dev``
        where it has one (a 0-d tensor; the caller fetches every scalar at
        once), the ranking metrics' distributed form under a rank layout,
        else its host form on one float64 copy of the scores."""
        out = []
        host_score = None
        cache = {}    # the converted score row, shared by the set's metrics
        for m in metrics:
            vals = m.eval_device(score_dev, self.objective, cache)
            if vals is None and getattr(m, "query_row_map", None) \
                    is not None:
                # a ranking metric on the global metadata: sums over this
                # rank's queries and one host gather (gbdt.py:5078-5081)
                vals = m.eval_mp(self.mp.local_block(score_dev).double()
                                 .cpu().numpy(), self.objective, self.mp)
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
        (its interpret-mode opt-in aside): ``tpu_traced_eval``, every
        ``_fast_path_reason``, ``tpu_megastep``, an objective whose
        gradients the JAX package traces, and every metric with a device
        form."""
        if not bool(self.config.tpu_traced_eval):
            return False, "config:tpu_traced_eval=false"
        reason = self._fast_path_reason()
        if reason is not None:
            return False, reason
        if not bool(self.config.tpu_megastep):
            return False, "config:tpu_megastep=false"
        if not self.objective.traced_gradients:
            return False, "objective_untraced_gradients:" + \
                self.objective.name
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
        """Device TreeArrays -> HostTree with real thresholds; a
        categorical node's bin-space left set becomes the bitset of its
        category values (gbdt.py:2860-2929; ref: tree.cpp
        Tree::SplitCategorical cat_boundaries_)."""
        ds = self.train_data
        nl = int(tree.num_leaves)
        ni = max(0, nl - 1)
        host = {k: v.cpu().numpy() for k, v in tree._asdict().items()
                if isinstance(v, torch.Tensor)}
        ht = HostTree(nl, shrinkage=1.0)
        sf_inner = host["split_feature"][:ni]
        tb = host["threshold_bin"][:ni]
        dl = host["default_left"][:ni]
        cat_flag = host["cat_flag"][:ni]
        cat_mask = host["cat_mask"][:ni]
        ht.split_feature = np.array(
            [ds.real_feature_index(int(f)) if f >= 0 else 0
             for f in sf_inner], np.int32)
        thr = np.zeros(ni, np.float64)
        dt = np.zeros(ni, np.int32)
        cat_boundaries = [0]
        cat_threshold: List[int] = []
        for i in range(ni):
            f = int(sf_inner[i])
            if f < 0:
                continue
            m = ds.mappers[ds.real_feature_index(f)]
            if bool(cat_flag[i]):
                cats = [int(m.bin_2_categorical[b])
                        for b in np.nonzero(cat_mask[i])[0]
                        if b < len(m.bin_2_categorical)
                        and m.bin_2_categorical[b] >= 0]
                words = [0] * ((max(cats) // 32 + 1) if cats else 1)
                for c in cats:
                    words[c // 32] |= 1 << (c % 32)
                thr[i] = len(cat_boundaries) - 1   # index into boundaries
                cat_threshold.extend(words)
                cat_boundaries.append(len(cat_threshold))
                dt[i] = HostTree.make_decision_type(True, False,
                                                    int(m.missing_type))
                continue
            thr[i] = m.bin_to_value(int(tb[i]))
            dt[i] = HostTree.make_decision_type(False, bool(dl[i]),
                                                int(m.missing_type))
        if len(cat_boundaries) > 1:
            ht.cat_boundaries = cat_boundaries
            ht.cat_threshold = cat_threshold
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


def abs_gh_class_sum(grad: torch.Tensor, hess: torch.Tensor) -> torch.Tensor:
    """[n] f32 sum of |g·h| over the k classes of [k, n] gradients, added
    in class order: the bits of the JAX package's
    ``jnp.sum(jnp.abs(grad * hess), axis=0)``."""
    a = torch.abs(grad * hess)
    s = a[0]
    for c in range(1, a.shape[0]):
        s = s + a[c]
    return s


class GOSS(GBDT):
    """Gradient-based One-Side Sampling (ref: src/boosting/goss.hpp:25;
    the serial branch of gbdt.py:5473-5569). It always trains on the
    synchronous body."""

    name = "goss"

    def init(self, config, train_data, objective, training_metrics=()):
        super().init(config, train_data, objective, training_metrics)
        if config.top_rate + config.other_rate > 1.0:
            log.fatal("top_rate + other_rate cannot be larger than 1.0 in "
                      "GOSS")
        if config.top_rate <= 0 or config.other_rate <= 0:
            log.fatal("top_rate and other_rate should be positive in GOSS")
        if config.bagging_freq > 0 and config.bagging_fraction != 1.0:
            log.fatal("Cannot use bagging in GOSS")
        log.info("Using GOSS")
        self.is_bagging = False

    def _capture_boosting_extra(self):
        # GOSS samples every iteration from the scores (restored by value)
        # and this MT19937 stream, which is all it needs saved
        _, keys, pos, has_gauss, cached = self.bag_rng.get_state()
        payload = {"goss_mt": {"pos": int(pos),
                               "has_gauss": int(has_gauss),
                               "cached": float(cached)}}
        return payload, {"goss_mt_keys": np.asarray(keys, np.uint32)}

    def _restore_boosting_extra(self, payload, arrays):
        mt = payload.get("goss_mt")
        if mt:
            self.bag_rng.set_state(
                ("MT19937", np.asarray(arrays["goss_mt_keys"], np.uint32),
                 int(mt["pos"]), int(mt["has_gauss"]),
                 float(mt["cached"])))

    def _bagging(self, it, grad=None, hess=None):
        """(ref: goss.hpp:103-159 BaggingHelper/Bagging): no sampling
        before iteration 1/learning_rate; then the rows whose |g·h| summed
        over the classes reaches the top_rate quantile, plus other_rate of
        the rest drawn without replacement, whose gradients are scaled by
        (n - top_k) / other_k. The sums are taken on the device in class
        order, as the JAX package's ``jnp.sum(axis=0)`` reduces them, and
        copied to the host once: the threshold and the draw are numpy's.

        Under a rank layout the sampling is rank-local (gbdt.py:5506-
        5576, as each of the reference's machines samples its own rows):
        the same ``bag_rng`` seed on every rank draws over different rows,
        ``n`` is the rank's rows, the mask stays the rank's (leaf renewal
        reads it), and ``bag_cnt`` is gathered over the host plane."""
        cfg = self.config
        n = self.num_data
        mp = self.mp
        if it < int(1.0 / cfg.learning_rate):
            self._set_bag(None)
            if mp is not None:
                self.bag_cnt = mp.total_real
            return grad, hess
        if mp is not None and n == 0:
            # a rank without rows samples nothing but joins the count's
            # gather, so every rank runs the same collectives
            self._set_bag(np.zeros(0, bool))
            self.bag_cnt = int(mp._allgather(
                np.asarray([0], np.int64)).sum())
            return grad, hess
        g_np = abs_gh_class_sum(grad, hess).cpu().numpy()
        host_syncs["count"] += 1
        top_k = max(1, int(n * cfg.top_rate))
        other_k = max(1, int(n * cfg.other_rate))
        threshold = np.partition(g_np, n - top_k)[n - top_k]
        multiply = (n - top_k) / other_k
        is_top = g_np >= threshold
        rest_idx = np.nonzero(~is_top)[0]
        if len(rest_idx):
            sampled = self.bag_rng.choice(
                rest_idx, size=min(other_k, len(rest_idx)), replace=False)
        else:
            sampled = np.zeros(0, np.int64)
        mask = is_top.copy()
        mask[sampled] = True
        mult = np.ones(n, np.float32)
        mult[sampled] = multiply
        self._set_bag(mask)
        if mp is not None:
            # the in-bag count over every rank's sample
            self.bag_cnt = int(mp._allgather(
                np.asarray([mask.sum()], np.int64)).sum())
        mult_dev = torch.as_tensor(mult, device=self.device)[None, :]
        return grad * mult_dev, hess * mult_dev


class DART(GBDT):
    """DART dropout boosting (ref: src/boosting/dart.hpp:23; the JAX
    package's gbdt.py:5331-5470). It always trains on the synchronous
    body. Each iteration draws its drop set from the reference's LCG
    (``drop_seed``) in the JAX package's order — ``is_skip`` first, then
    one float per trained iteration, stopping at ``max_drop`` — and
    subtracts the dropped trees (their f32 leaf values) from the training
    scores before the gradients; ``_normalize`` then shrinks them in
    float64 and moves their scores by the same factor."""

    name = "dart"

    def init(self, config, train_data, objective, training_metrics=()):
        super().init(config, train_data, objective, training_metrics)
        self.drop_rng = ref_random.Random(int(config.drop_seed))
        self.tree_weight: List[float] = []
        self.sum_weight = 0.0
        self.drop_index: List[int] = []

    def _capture_boosting_extra(self):
        # the drop stream's position and the tree weights: the DART state
        # beyond the (normalized in place, hence checkpointed) trees
        payload = {"drop_rng_x": int(self.drop_rng.x),
                   "sum_weight": float(self.sum_weight)}
        return payload, {"dart_tree_weight": np.asarray(self.tree_weight,
                                                       np.float64)}

    def _restore_boosting_extra(self, payload, arrays):
        if "drop_rng_x" in payload:
            self.drop_rng.x = int(payload["drop_rng_x"])
            self.sum_weight = float(payload.get("sum_weight", 0.0))
            self.tree_weight = [float(x)
                                for x in arrays["dart_tree_weight"]]
            self.drop_index = []

    def _get_gradients(self):
        # drop trees, then the gradients on the reduced scores (ref:
        # dart.hpp:77-86 GetTrainingScore -> DroppingTrees)
        self._dropping_trees()
        return super()._get_gradients()

    def _dropping_trees(self) -> None:
        """(ref: dart.hpp:95-148 DroppingTrees)"""
        cfg = self.config
        self.drop_index = []
        is_skip = self.drop_rng.next_float() < cfg.skip_drop
        if not is_skip:
            drop_rate = cfg.drop_rate
            if not cfg.uniform_drop:
                if self.sum_weight > 0:
                    inv_avg = len(self.tree_weight) / self.sum_weight
                    if cfg.max_drop > 0:
                        drop_rate = min(drop_rate, cfg.max_drop * inv_avg
                                        / self.sum_weight)
                    for i in range(self.iter):
                        if (self.drop_rng.next_float()
                                < drop_rate * self.tree_weight[i] * inv_avg):
                            self.drop_index.append(self.num_init_iteration
                                                   + i)
                            if len(self.drop_index) >= cfg.max_drop > 0:
                                break
            else:
                if cfg.max_drop > 0 and self.iter > 0:
                    drop_rate = min(drop_rate, cfg.max_drop / self.iter)
                for i in range(self.iter):
                    if self.drop_rng.next_float() < drop_rate:
                        self.drop_index.append(self.num_init_iteration + i)
                        if len(self.drop_index) >= cfg.max_drop > 0:
                            break
        k = self.num_tree_per_iteration
        bins, bundle = (self.train_data.bins_dev,
                        self._bundle_of(self.train_data))
        for i in self.drop_index:
            for tid in range(k):
                self.scores[tid] = self._add_host_tree(
                    self.scores[tid], bins, self.models[i * k + tid], -1.0,
                    bundle)
        nd = len(self.drop_index)
        lr = cfg.learning_rate
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = lr / (1.0 + nd)
        else:
            self.shrinkage_rate = lr if nd == 0 else lr / (lr + nd)

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        if super().train_one_iter(gradients, hessians):
            return True
        self._normalize()
        if not self.config.uniform_drop:
            self.tree_weight.append(self.shrinkage_rate)
            self.sum_weight += self.shrinkage_rate
        return False

    def _normalize(self) -> None:
        """(ref: dart.hpp:150-199 Normalize): each dropped tree shrinks to
        nd/(nd+1) of its weight (nd/(nd+lr) in xgboost_dart_mode); the
        valid scores take -1/(nd+1) (-(1 - factor)) of its old f32 values
        and the training scores +nd/(nd+1) (+factor), valid sets first."""
        cfg = self.config
        nd = len(self.drop_index)
        if nd == 0:
            return
        k = self.num_tree_per_iteration
        lr = cfg.learning_rate
        if not cfg.xgboost_dart_mode:
            factor, valid_scale = nd / (nd + 1.0), -1.0 / (nd + 1.0)
        else:
            factor = nd / (nd + lr)
            valid_scale = -(1.0 - factor)
        bins, bundle = (self.train_data.bins_dev,
                        self._bundle_of(self.train_data))
        for i in self.drop_index:
            for tid in range(k):
                ht = self.models[i * k + tid]
                for vd, vs in zip(self.valid_data, self.valid_scores):
                    vs[tid] = self._add_host_tree(vs[tid], vd.bins_dev, ht,
                                                  valid_scale,
                                                  self._bundle_of(vd))
                self.scores[tid] = self._add_host_tree(
                    self.scores[tid], bins, ht, factor, bundle)
                ht.apply_shrinkage(factor)
            if not cfg.uniform_drop:
                j = i - self.num_init_iteration
                div = nd + 1.0 if not cfg.xgboost_dart_mode else nd + lr
                self.sum_weight -= self.tree_weight[j] / div
                self.tree_weight[j] *= nd / div


class RF(GBDT):
    """Random forest mode (ref: src/boosting/rf.hpp:25; the JAX package's
    gbdt.py:5579-5734): bagging required, no shrinkage, gradients fixed at
    the constant base score (``boost_from_score``, 0 over an init score
    or without ``boost_from_average``) and that score folded into every
    tree; the scores hold the sum of the trees, and evaluation and
    prediction divide by the iterations (``average_output``). Leaf
    renewal takes residuals against the base score."""

    name = "rf"
    average_output = True

    def init(self, config, train_data, objective, training_metrics=()):
        if not (config.bagging_freq > 0
                and 0.0 < config.bagging_fraction < 1.0):
            log.fatal("RF mode requires bagging "
                      "(bagging_freq > 0, bagging_fraction in (0,1))")
        super().init(config, train_data, objective, training_metrics)
        self.shrinkage_rate = 1.0
        if objective is None:
            log.fatal("RF mode do not support custom objective function, "
                      "please use built-in objectives.")
        # gradients fixed at the base score (ref: rf.hpp:82-100 Boosting)
        k = self.num_tree_per_iteration
        self.init_scores = [
            0.0 if self.has_init_score or not config.boost_from_average
            else objective.boost_from_score(tid) for tid in range(k)]
        base = torch.as_tensor(np.tile(
            np.asarray(self.init_scores, np.float32)[:, None],
            (1, self.num_data)), device=self.device)
        self._fixed_grad, self._fixed_hess = objective.get_gradients(base)

    def _get_gradients(self):
        return self._fixed_grad, self._fixed_hess

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """(ref: rf.hpp:102-160 TrainOneIter) Per class: grow on the fixed
        gradients, renew, fold in the base score, add the f32 leaf values
        to the training scores (``table_lookup``) and the valid scores. A
        class that grows nothing gets a zero tree; True when none grew."""
        self._epi_carry = None
        k, n = self.num_tree_per_iteration, self.num_data
        if gradients is None:
            grad, hess = self._get_gradients()
        else:
            grad, hess = [torch.as_tensor(
                np.asarray(a, np.float32).reshape(k, n), device=self.device)
                for a in (gradients, hessians)]
        grad, hess = self._bagging(self.iter, grad, hess)
        should_continue = False
        for tid in range(k):
            # the JAX package grows every class tree with tid 0 (its
            # quantized dither seed)
            tree, row_leaf, lookup = self._grow_sync(grad[tid], hess[tid], 0)
            if tree.num_leaves <= 1:
                self.models.append(HostTree(1))
                continue
            should_continue = True
            ht = self._to_host_tree(tree)
            if self.objective.is_renew_tree_output:
                self._renew_tree_output(ht, row_leaf, tid,
                                        base=self.init_scores[tid])
            # the base score rides in every tree; the averaged score then
            # carries it once (ref: rf.hpp:136-138 AddBias)
            if abs(self.init_scores[tid]) > K_EPSILON:
                ht.add_bias(self.init_scores[tid])
            lv = torch.as_tensor(ht.leaf_value.astype(np.float32),
                                 device=self.device)
            self.scores[tid] += lookup(lv, row_leaf)
            for vd, vs in zip(self.valid_data, self.valid_scores):
                vs[tid] = self._add_host_tree(vs[tid], vd.bins_dev, ht,
                                              bundle=self._bundle_of(vd))
            self.models.append(ht)
        if not should_continue:
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            if len(self.models) > k:
                del self.models[-k:]
            return True
        self.iter += 1
        return False
