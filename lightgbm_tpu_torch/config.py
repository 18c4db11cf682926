"""Declarative parameter system (a copy of ``lightgbm_tpu/config.py``).

Every key of the JAX package's registry is kept, so one params dict drives
both packages; the one difference is ``device_type``, which defaults to
``"cuda"`` here (``"cpu"`` runs the kernels' plain PyTorch versions).

Analog of the reference config layer (ref: include/LightGBM/config.h,
src/io/config.cpp:16,45,193 and the generated src/io/config_auto.cpp).  The
reference keeps one source of truth — parameter name, aliases, type, check and
doc — in header comments and code-generates the alias table / setters
(helpers/parameter_generator.py).  Here the same single source of truth is the
``_PARAMS`` registry below; alias resolution, type coercion and range checks are
driven from it at runtime.

Unknown parameters are kept and forwarded with a warning, matching the
reference's behavior of passing unrecognized keys through (config.cpp:193).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from .utils import log

__all__ = ["Config", "PARAM_ALIASES", "param_docs", "resolve_device"]


@dataclasses.dataclass(frozen=True)
class _Param:
    name: str
    ptype: type  # int, float, bool, str, list
    default: Any
    aliases: Tuple[str, ...] = ()
    check: Optional[Tuple[str, float]] = None  # (op, bound): ">", ">=", "<", "<="
    check2: Optional[Tuple[str, float]] = None
    desc: str = ""


def _p(name, ptype, default, aliases=(), check=None, check2=None, desc=""):
    return _Param(name, ptype, default, tuple(aliases), check, check2, desc)


# One row per parameter; mirrors the surface of the reference Config struct
# (ref: include/LightGBM/config.h:139-1029).  Grouped as in Parameters.rst.
_PARAMS: List[_Param] = [
    # ---- Core parameters ----
    _p("task", str, "train", ("task_type",), desc="train, predict, convert_model, refit"),
    _p("objective", str, "regression",
       ("objective_type", "app", "application", "loss"),
       desc="objective name (regression, binary, multiclass, lambdarank, ...)"),
    _p("boosting", str, "gbdt", ("boosting_type", "boost"),
       desc="gbdt, rf, dart, goss"),
    _p("data", str, "", ("train", "train_data", "train_data_file", "data_filename"),
       desc="path of training data (CLI)"),
    _p("valid", list, [], ("test", "valid_data", "valid_data_file", "test_data",
                           "test_data_file", "valid_filenames"),
       desc="paths of validation data (CLI)"),
    _p("num_iterations", int, 100,
       ("num_iteration", "n_iter", "num_tree", "num_trees", "num_round",
        "num_rounds", "nrounds", "num_boost_round", "n_estimators", "max_iter"),
       check=(">=", 0)),
    _p("learning_rate", float, 0.1, ("shrinkage_rate", "eta"), check=(">", 0.0)),
    _p("num_leaves", int, 31, ("num_leaf", "max_leaves", "max_leaf", "max_leaf_nodes"),
       check=(">", 1), check2=("<=", 131072)),
    _p("tree_learner", str, "serial",
       ("tree", "tree_type", "tree_learner_type"),
       desc="serial, feature, data, voting"),
    _p("num_threads", int, 0, ("num_thread", "nthread", "nthreads", "n_jobs"),
       desc="unused on TPU (XLA owns threading); kept for API parity"),
    _p("device_type", str, "cuda", ("device",),
       desc="cuda (the hand-written kernels on the card) or cpu (their "
            "plain PyTorch versions)"),
    _p("seed", int, 0, ("random_seed", "random_state"),
       desc="master seed deriving data_random_seed etc."),
    _p("deterministic", bool, False),
    # ---- Learning control ----
    _p("force_col_wise", bool, False),
    _p("force_row_wise", bool, False),
    _p("histogram_pool_size", float, -1.0, ("hist_pool_size",)),
    _p("max_depth", int, -1, desc="<=0 means no limit"),
    _p("min_data_in_leaf", int, 20,
       ("min_data_per_leaf", "min_data", "min_child_samples", "min_samples_leaf"),
       check=(">=", 0)),
    _p("min_sum_hessian_in_leaf", float, 1e-3,
       ("min_sum_hessian_per_leaf", "min_sum_hessian", "min_hessian",
        "min_child_weight"), check=(">=", 0.0)),
    _p("bagging_fraction", float, 1.0, ("sub_row", "subsample", "bagging"),
       check=(">", 0.0), check2=("<=", 1.0)),
    _p("pos_bagging_fraction", float, 1.0,
       ("pos_sub_row", "pos_subsample", "pos_bagging"),
       check=(">", 0.0), check2=("<=", 1.0)),
    _p("neg_bagging_fraction", float, 1.0,
       ("neg_sub_row", "neg_subsample", "neg_bagging"),
       check=(">", 0.0), check2=("<=", 1.0)),
    _p("bagging_freq", int, 0, ("subsample_freq",)),
    _p("bagging_seed", int, 3, ("bagging_fraction_seed",)),
    _p("feature_fraction", float, 1.0,
       ("sub_feature", "colsample_bytree"), check=(">", 0.0), check2=("<=", 1.0)),
    _p("feature_fraction_bynode", float, 1.0,
       ("sub_feature_bynode", "colsample_bynode"),
       check=(">", 0.0), check2=("<=", 1.0)),
    _p("feature_fraction_seed", int, 2),
    _p("extra_trees", bool, False, ("extra_tree",)),
    _p("extra_seed", int, 6),
    _p("early_stopping_round", int, 0,
       ("early_stopping_rounds", "early_stopping", "n_iter_no_change")),
    _p("first_metric_only", bool, False),
    _p("max_delta_step", float, 0.0, ("max_tree_output", "max_leaf_output")),
    _p("lambda_l1", float, 0.0, ("reg_alpha", "l1_regularization"), check=(">=", 0.0)),
    _p("lambda_l2", float, 0.0, ("reg_lambda", "lambda", "l2_regularization"),
       check=(">=", 0.0)),
    _p("linear_lambda", float, 0.0, check=(">=", 0.0)),
    _p("min_gain_to_split", float, 0.0, ("min_split_gain",), check=(">=", 0.0)),
    _p("drop_rate", float, 0.1, ("rate_drop",), check=(">=", 0.0), check2=("<=", 1.0)),
    _p("max_drop", int, 50),
    _p("skip_drop", float, 0.5, check=(">=", 0.0), check2=("<=", 1.0)),
    _p("xgboost_dart_mode", bool, False),
    _p("uniform_drop", bool, False),
    _p("drop_seed", int, 4),
    _p("top_rate", float, 0.2, check=(">=", 0.0), check2=("<=", 1.0),
       desc="GOSS: keep-ratio of large-gradient rows"),
    _p("other_rate", float, 0.1, check=(">=", 0.0), check2=("<=", 1.0),
       desc="GOSS: sample-ratio of small-gradient rows"),
    _p("min_data_per_group", int, 100, check=(">", 0)),
    _p("max_cat_threshold", int, 32, check=(">", 0)),
    _p("cat_l2", float, 10.0, check=(">=", 0.0)),
    _p("cat_smooth", float, 10.0, check=(">=", 0.0)),
    _p("max_cat_to_onehot", int, 4, check=(">", 0)),
    _p("top_k", int, 20, ("topk",), check=(">", 0),
       desc="voting-parallel: per-shard feature proposals"),
    _p("monotone_constraints", list, [], ("mc", "monotone_constraint")),
    _p("monotone_constraints_method", str, "basic",
       ("monotone_constraining_method", "mc_method"),
       desc="basic, intermediate, advanced"),
    _p("monotone_penalty", float, 0.0, ("monotone_splits_penalty", "ms_penalty",
                                        "mc_penalty"), check=(">=", 0.0)),
    _p("feature_contri", list, [], ("feature_contrib", "fc", "fp", "feature_penalty")),
    _p("forcedsplits_filename", str, "", ("fs", "forced_splits_filename",
                                          "forced_splits_file", "forced_splits")),
    _p("refit_decay_rate", float, 0.9, check=(">=", 0.0), check2=("<=", 1.0)),
    _p("cegb_tradeoff", float, 1.0, check=(">=", 0.0)),
    _p("cegb_penalty_split", float, 0.0, check=(">=", 0.0)),
    _p("cegb_penalty_feature_lazy", list, []),
    _p("cegb_penalty_feature_coupled", list, []),
    _p("path_smooth", float, 0.0, check=(">=", 0.0)),
    _p("interaction_constraints", list, []),
    _p("verbosity", int, 1, ("verbose",)),
    _p("input_model", str, "", ("model_input", "model_in")),
    _p("output_model", str, "LightGBM_model.txt", ("model_output", "model_out")),
    _p("saved_feature_importance_type", int, 0),
    _p("snapshot_freq", int, -1, ("save_period",)),
    # ---- Linear tree ----
    _p("linear_tree", bool, False, ("linear_trees",)),
    # ---- Dataset parameters ----
    _p("max_bin", int, 255, ("max_bins",), check=(">", 1)),
    _p("max_bin_by_feature", list, []),
    _p("min_data_in_bin", int, 3, check=(">", 0)),
    _p("bin_construct_sample_cnt", int, 200000, ("subsample_for_bin",), check=(">", 0)),
    _p("data_random_seed", int, 1, ("data_seed",)),
    _p("is_enable_sparse", bool, True, ("is_sparse", "enable_sparse", "sparse")),
    _p("enable_bundle", bool, True, ("is_enable_bundle", "bundle")),
    _p("use_missing", bool, True),
    _p("zero_as_missing", bool, False),
    _p("feature_pre_filter", bool, True),
    _p("pre_partition", bool, False, ("is_pre_partition",)),
    _p("two_round", bool, False, ("two_round_loading", "use_two_round_loading"),
       desc="stream file-based dataset construction in bounded chunks "
            "(ingest/): pass 1 collects the binning sample, pass 2 "
            "parses -> bins -> packs per chunk, so peak host RSS is "
            "O(ingest_chunk_rows) instead of O(shard) — the trained "
            "model is bit-identical to the monolithic load "
            "(docs/Data.md). With save_binary, the packed chunks "
            "stream straight into the binary cache artifact and the "
            "parsed shard never exists in RAM at once"),
    _p("ingest_chunk_rows", int, 65536, ("ingest_chunk_size",),
       check=(">", 0),
       desc="rows per streaming-ingest chunk (parse/bin/pack and "
            "host->device prefetch granularity). Setting it explicitly "
            "also OPTS IN to chunked ingest for file loads, like "
            "two_round=true"),
    _p("ingest_prefetch", bool, True,
       desc="double-buffered host->device transfer of every "
            "dataset's bin matrix: the next chunk's host read "
            "overlaps the in-flight copy, at most two chunks live on "
            "host (ingest_stats max_live_chunks), host stall time in "
            "its host_wait_ms. Off = one widened copy"),
    _p("header", bool, False, ("has_header",)),
    _p("label_column", str, "", ("label",)),
    _p("weight_column", str, "", ("weight",)),
    _p("group_column", str, "", ("group", "group_id", "query_column", "query",
                                 "query_id")),
    _p("ignore_column", str, "", ("ignore_feature", "blacklist")),
    _p("categorical_feature", list, [], ("cat_feature", "categorical_column",
                                         "cat_column")),
    _p("forcedbins_filename", str, ""),
    _p("save_binary", bool, False, ("is_save_binary", "is_save_binary_file"),
       desc="maintain a binary dataset cache next to a file-based "
            "training input (<data>.bin, per-rank shards under the "
            "multiproc launcher): written after construction (or "
            "streamed during it with two_round), and LOADED instead of "
            "the text file on later constructs when the source "
            "fingerprint (size/mtime/dataset params) still matches — "
            "cache-hit startup skips parsing and binning entirely "
            "(docs/Data.md). cli.py task=save_binary writes the same "
            "artifact explicitly"),
    _p("precise_float_parser", bool, False),
    # ---- Predict parameters ----
    _p("start_iteration_predict", int, 0),
    _p("num_iteration_predict", int, -1),
    _p("predict_raw_score", bool, False, ("is_predict_raw_score", "predict_rawscore",
                                          "raw_score")),
    _p("predict_leaf_index", bool, False, ("is_predict_leaf_index", "leaf_index")),
    _p("predict_contrib", bool, False, ("is_predict_contrib", "contrib")),
    _p("predict_disable_shape_check", bool, False),
    _p("pred_device_min_work", int, 2_000_000,
       ("predict_device_min_work",), check=(">=", 0),
       desc="minimum rows x trees before Booster.predict routes a batch "
            "through the device predictor (stacked trees + jit scan) "
            "instead of the exact float64 host walk; 0 forces the device "
            "path, a huge value forces the host walk — the deterministic "
            "switch the serving/parity tests use. Serving "
            "(lightgbm_tpu.serve) always uses the device path when the "
            "model is representable"),
    _p("pred_early_stop", bool, False),
    _p("pred_early_stop_freq", int, 10),
    _p("pred_early_stop_margin", float, 10.0),
    _p("output_result", str, "LightGBM_predict_result.txt",
       ("predict_result", "prediction_result", "predict_name", "pred_name",
        "name_pred")),
    # ---- Convert parameters ----
    _p("convert_model_language", str, ""),
    _p("convert_model", str, "gbdt_prediction.cpp", ("convert_model_file",)),
    # ---- Objective parameters ----
    _p("objective_seed", int, 5),
    _p("num_class", int, 1, ("num_classes",), check=(">", 0)),
    _p("is_unbalance", bool, False, ("unbalance", "unbalanced_sets")),
    _p("scale_pos_weight", float, 1.0, check=(">", 0.0)),
    _p("sigmoid", float, 1.0, check=(">", 0.0)),
    _p("boost_from_average", bool, True),
    _p("reg_sqrt", bool, False),
    _p("alpha", float, 0.9, check=(">", 0.0)),
    _p("fair_c", float, 1.0, check=(">", 0.0)),
    _p("poisson_max_delta_step", float, 0.7, check=(">", 0.0)),
    _p("tweedie_variance_power", float, 1.5, check=(">=", 1.0), check2=("<", 2.0)),
    _p("lambdarank_truncation_level", int, 30, check=(">", 0)),
    _p("lambdarank_norm", bool, True),
    _p("label_gain", list, []),
    # ---- Metric parameters ----
    _p("metric", list, [], ("metrics", "metric_types")),
    _p("metric_freq", int, 1, ("output_freq",), check=(">", 0)),
    _p("is_provide_training_metric", bool, False,
       ("training_metric", "is_training_metric", "train_metric")),
    _p("eval_at", list, [1, 2, 3, 4, 5], ("ndcg_eval_at", "ndcg_at", "map_eval_at",
                                          "map_at")),
    _p("multi_error_top_k", int, 1, check=(">", 0)),
    _p("auc_mu_weights", list, []),
    # ---- Network (distributed) parameters ----
    # On TPU these select mesh behavior rather than socket/MPI endpoints
    # (ref: config.h:983-1006; src/network/*).
    _p("num_machines", int, 1, ("num_machine",), check=(">", 0)),
    _p("local_listen_port", int, 12400, ("local_port", "port"),
       desc="unused on TPU (XLA owns transport); kept for API parity"),
    _p("time_out", int, 120, check=(">", 0)),
    _p("machine_list_filename", str, "", ("machine_list_file", "machine_list",
                                          "mlist")),
    _p("machines", str, "", ("workers", "nodes")),
    # ---- GPU (reference) → TPU parameters ----
    _p("gpu_platform_id", int, -1),
    _p("gpu_device_id", int, -1),
    _p("gpu_use_dp", bool, False,
       desc="use float64 histogram accumulation (parity mode)"),
    _p("num_gpu", int, 1, check=(">", 0)),
    # ---- TPU-specific ----
    _p("grow_policy", str, "auto",
       desc="auto, leafwise (exact LightGBM semantics), depthwise "
            "(frontier-batched, fastest on TPU)"),
    _p("tpu_histogram_impl", str, "auto",
       desc="auto, segment (XLA segment-sum), onehot (one-hot matmul), "
            "pallas (Pallas kernel)"),
    _p("tpu_engine", str, "auto",
       desc="auto, fused (fused route+histogram level kernel, fastest), "
            "frontier (round-1 Pallas path), xla (no Pallas)"),
    _p("tpu_hist_precision", str, "bf16x2",
       desc="histogram input precision: bf16x2 (hi/lo split, fp32-grade, "
            "default) or bf16 (fastest)"),
    _p("tpu_enable_bundle", bool, True,
       desc="exclusive feature bundling (sparse mutually-exclusive "
            "features share histogram columns) on the fused and depthwise "
            "growers; engages only when it reduces the column count, and "
            "requires enable_bundle too (the reference's switch)"),
    _p("tpu_extra_levels", int, 3, check=(">=", 0),
       desc="extra fused-level passes after the pow2 frontier levels so "
            "skewed trees can spend the remaining leaf budget"),
    _p("tpu_max_bundle_bins", int, 256, check=(">", 1),
       desc="bin capacity per EFB bundle column for sparse-built "
            "datasets (columns fill toward this cap, bounding the "
            "uniform-width padding of the fused kernel layout)"),
    _p("tpu_quantized_grad", int, 0, ("tpu_quant_grad",),
       check=(">=", 0), check2=("<=", 16),
       desc="quantized gradient histograms on the fused engine: 16 or 8 "
            "= stochastic-rounded fixed-point grad/hess under a "
            "per-iteration global scale, integer MXU accumulation "
            "(int8 channels, exact int32 sums) with one f32 rescale "
            "before the split search — halves the one-hot scratch and "
            "gh stream the histogram kernel's floor is made of "
            "(docs/Performance.md 'Histogram plane'; accuracy-curve "
            "A/B-gated). 0 = off (f32-grade bf16x2 path, the default). "
            "Requires tpu_engine=fused; other engines degrade with a "
            "structured event"),
    _p("tpu_adaptive_bins", bool, False,
       desc="adaptive per-feature bin widths in the fused kernel "
            "layout: each feature's slab is sized to ITS effective bin "
            "count (pow2, packed densely into the 128-lane quantum) "
            "instead of padding every feature to the global pow2 "
            "max_bin — shrinks the one-hot scratch and histogram "
            "accumulator on heterogeneous-cardinality data. "
            "BIT-IDENTICAL models to the padded layout (A/B-tested): "
            "the packed layout is a pure re-indexing with the row tile "
            "held at the padded formula. Off under EFB bundling and "
            "voting-parallel (their layouts own the flat axis)"),
    _p("tpu_gain_screening", bool, False,
       desc="EMA-FS gain screening (arxiv 2606.26337): maintain a "
            "per-feature EMA of realized split gains (in the megastep "
            "scan carry on the fast path) and restrict each tree's "
            "split search to the top tpu_screening_keep_ratio features "
            "by EMA, composed with the feature_fraction mask; "
            "screened-out features' one-hot slabs are zeroed in the "
            "fused kernel. Warmup and periodic exploration rounds keep "
            "the mask open so late-blooming features re-enter "
            "(statistical-parity A/B-gated; EMA state rides resilience "
            "checkpoints). Requires tpu_engine=fused"),
    _p("tpu_screening_warmup", int, 10, check=(">=", 0),
       desc="iterations before gain screening narrows the mask (all "
            "features stay eligible while the gain EMA warms up)"),
    _p("tpu_screening_keep_ratio", float, 0.5,
       check=(">", 0.0), check2=("<=", 1.0),
       desc="fraction of features kept by gain screening outside "
            "exploration rounds (top-k by gain EMA, ties kept)"),
    _p("tpu_screening_explore_period", int, 8, check=(">=", 0),
       desc="every Nth iteration is an exploration round with the full "
            "feature set eligible, so screened-out features can realize "
            "gains and re-enter; 0 = never explore after warmup"),
    _p("tpu_screening_ema_alpha", float, 0.9,
       check=(">=", 0.0), check2=("<", 1.0),
       desc="gain-EMA decay: ema = alpha * ema + (1 - alpha) * "
            "realized split gains of the iteration's trees"),
    _p("tpu_fast_path", bool, True,
       desc="allow the pipelined fast path (device trees drained in "
            "batches); off = synchronous per-iteration host bookkeeping "
            "— bit-comparable across engines/modes, used by debugging "
            "and A/B tests"),
    _p("tpu_fused_epilogue", bool, True,
       desc="fuse final-level routing + score update + gradients + next "
            "root histogram into one kernel pass on the pipelined fast "
            "path (objectives with a kernel closed form: binary, l2)"),
    _p("tpu_megastep", bool, True,
       desc="chain up to tpu_megastep_iters boosting iterations inside "
            "ONE jit (lax.scan over the fused tree-growing step; "
            "gradients, bagging weights, tree growth, score and "
            "valid-score updates all stay on device) when the driver "
            "loop permits multi-iteration steps (engine.train / CLI "
            "train); off = one dispatch per iteration on the fast path. "
            "Off-TPU (interpret-mode fused) the default does not engage "
            "— set the key explicitly to opt in; there is no dispatch "
            "latency to amortize there"),
    _p("tpu_megastep_iters", int, 32, check=(">", 1),
       desc="max boosting iterations fused into one megastep dispatch "
            "(capped by the pipeline drain batch, the num_iterations "
            "horizon and the current bagging round's window)"),
    _p("tpu_mp_megastep", bool, True,
       desc="let multi-process (multi-chip pod) training ride the "
            "dispatch-amortized fast path and megastep: the shard_map-"
            "wrapped fused growers run inside the scan over the global "
            "ICI/DCN mesh, split sync and the voting exchange stay "
            "in-trace XLA collectives, and host collectives (health "
            "audit, checkpoints) fire only at drain boundaries. Off = "
            "multi-process runs evict to the synchronous per-iteration "
            "driver (pre-round-12 behavior, A/B switch)"),
    _p("tpu_traced_eval", bool, True,
       desc="evaluate the built-in metrics ON DEVICE inside the "
            "megastep scan (metric/traced.py) so lgb.train with eval "
            "sets + early_stopping/log_evaluation/record_evaluation/"
            "snapshots keeps the dispatch-amortized fast path; the "
            "drain replays those callbacks against the stacked "
            "per-iteration metric matrix, and a scan-carried early-stop "
            "flag keeps the drained model bit-identical to the "
            "synchronous driver's. Off = built-in callbacks evict to "
            "the per-iteration loop (pre-round-8 behavior, A/B switch)"),
    _p("tpu_rows_per_shard_pad", int, 8,
       desc="pad row count to a multiple of this per mesh shard"),
    _p("mesh_axis_data", str, "data", desc="mesh axis name for row sharding"),
    _p("mesh_axis_feature", str, "feature",
       desc="mesh axis name for feature sharding"),
    _p("compilation_cache_dir", str, "",
       ("jax_compilation_cache_dir", "xla_cache_dir"),
       desc="directory for JAX's persistent XLA compilation cache: "
            "repeated runs (same shapes/params) skip recompiling the "
            "fused training step — applied to jax.config at booster "
            "init, before the first trace"),
    # ---- Observability (docs/Observability.md) ----
    _p("telemetry_out", str, "", ("telemetry_output", "telemetry_file"),
       desc="path: stream structured JSONL telemetry (per-iteration "
            "section times, collective traffic, compile and degradation "
            "events); multi-process ranks write <path>.rank<r>, rank 0 "
            "the bare path. Time attribution follows "
            "telemetry_granularity — only granularity=section forces "
            "the synchronous per-iteration driver"),
    _p("telemetry_granularity", str, "batch",
       ("telemetry_level",),
       desc="time-attribution granularity when telemetry is on: 'batch' "
            "(default — training keeps the pipelined/megastep fast path; "
            "wall time and dispatch counts attributed per drained batch), "
            "'iteration' (fast path with one sync per iteration; whole-"
            "iteration wall times, no per-section split), 'section' "
            "(synchronous driver with honestly-synced per-section times "
            "— the pre-round-5 behavior; trace_out and "
            "health_check_period imply this)"),
    _p("profile_dir", str, "", ("profiler_dir", "profile_log_dir"),
       desc="directory: capture a jax.profiler trace of the training "
            "loop (TensorBoard/Perfetto viewable)"),
    _p("profile_start_iteration", int, 0, check=(">=", 0),
       desc="first boosting iteration covered by the profile_dir trace"),
    _p("profile_num_iterations", int, -1,
       desc="iterations covered by the profile_dir trace; <0 = until "
            "training ends"),
    _p("trace_out", str, "", ("trace_output", "trace_file"),
       desc="path: export a Perfetto/Chrome-trace JSON timeline of the "
            "training run — one track per rank, spans for the driver "
            "sections (boosting/histogram_split/tree_materialize/"
            "score_update), collectives, XLA compiles and health "
            "checks; loadable in chrome://tracing or ui.perfetto.dev. "
            "Implies telemetry (synchronous driver); multi-process runs "
            "merge every rank's spans into rank 0's file"),
    _p("health_check_period", int, 0, ("health_check_freq",),
       check=(">=", 0),
       desc="every N iterations hash the model state (leaf values + "
            "split params) and allgather per-rank section times, "
            "emitting rank_divergence events when ranks disagree and "
            "straggler events when section-time skew exceeds "
            "health_skew_threshold; 0 = off. Implies telemetry "
            "(synchronous driver)"),
    _p("health_skew_threshold", float, 2.0,
       ("straggler_skew_threshold",), check=(">", 1.0),
       desc="max/median per-section time ratio across ranks at or above "
            "which the health auditor emits a straggler event"),
    _p("metrics_port", int, 0, ("prometheus_port", "openmetrics_port"),
       check=(">=", 0),
       desc="serve the LIVE telemetry registry as an OpenMetrics/"
            "Prometheus endpoint on http://127.0.0.1:<port>/metrics "
            "(stdlib http.server on a daemon thread; counters, gauges, "
            "timing summaries and dist quantiles with rank/run_id "
            "labels). Multi-process ranks bind <port>+<rank>; rank 0 "
            "additionally appends the fleet counter series fed by the "
            "health auditor's existing allgather. A port in use falls "
            "back to an ephemeral port with a structured "
            "metrics_exporter event. 0 = off. Implies telemetry "
            "(batch granularity — the fast path is kept)"),
    _p("memory_watermarks", bool, True,
       ("memory_watermark", "mem_watermarks"),
       desc="when telemetry is enabled, gauge every local device's "
            "bytes_in_use / peak_bytes_in_use / bytes_limit — plus "
            "bytes_reserved / peak_bytes_reserved and a derived "
            "free-space fragmentation ratio where the backend's "
            "allocator reports them — (mem.d<id>.* gauges, the "
            "exporter's HBM-headroom series) at megastep drain and "
            "serving dispatch boundaries; backends without allocator "
            "stats (CPU) degrade to a no-op"),
    _p("run_report_out", str, "", ("run_report", "report_out"),
       desc="path: write the consolidated, schema-versioned run report "
            "(run_report.json + rendered <path>.md) at finalize — "
            "dispatch/compile counters with per-iteration derivations, "
            "every megastep_evicted / degrade reason fired, the "
            "device-time cost ledger, collective traffic, memory "
            "watermarks and checkpoint/recovery events in ONE "
            "comparable artifact (scripts/run_diff.py diffs two of "
            "them). Multi-process: rank 0 writes the report with a "
            "per-rank section aggregated over the existing finalize "
            "allgather. Implies telemetry (batch granularity); the "
            "same report is served live from GET /report when "
            "metrics_port is set"),
    _p("cost_ledger", str, "hlo", ("cost_analysis_mode",),
       desc="device-time cost ledger mode (obs/cost.py): 'hlo' "
            "(default — analyze each fresh executable signature "
            "[megastep chunks, fast step, serve buckets] with the "
            "client-side HLO cost model, no second compile), "
            "'compiled' (post-optimization compiled.cost_analysis(); "
            "pays a second backend compile unless "
            "compilation_cache_dir is armed), 'off'. Active only while "
            "telemetry is enabled; feeds cost.flops_per_iter / "
            "cost.hlo_bytes_per_iter / cost.achieved_fraction gauges "
            "and one cost_ledger record per drained batch"),
    _p("perf_db", str, "", ("perf_database", "perfdb"),
       desc="path to the append-only, shape-keyed performance database "
            "(obs/perfdb.py, JSONL). Every profile window that closes "
            "(profile_dir config window or POST /profile) is parsed by "
            "the roofline plane (obs/kernelstats.py) and its joined "
            "executables append one measured sample each — keyed by "
            "(signature, kind, shape class, backend, quant bits, "
            "packed layout, world size) — so measured device times "
            "accumulate across runs into the tuning cache "
            "scripts/perfdb_query.py and run_diff --perf-db read. "
            "Appends are atomic (single O_APPEND write); concurrent "
            "runs may share one file. Empty (default) disables the "
            "perfdb write; the roofline record and gauges are emitted "
            "either way whenever a window closes under telemetry"),
    _p("drift_profile", bool, True, ("data_profile", "drift_monitor"),
       desc="capture a compact DataProfile of the training distribution "
            "at dataset finalize (per-feature bin-occupancy histograms "
            "over the packed bins, missing rates, label/score "
            "distribution, mappers digest, row count) and embed it — "
            "with the model's provenance record — in the serialized "
            "model artifact and in resilience checkpoints, so any "
            "loaded booster carries its training distribution. Also "
            "the master switch for the ingest mapper-drift monitor and "
            "the serving drift monitor (both degrade structurally when "
            "a model has no embedded profile: one drift_unavailable "
            "event, never an exception). Default ON"),
    _p("drift_psi_threshold", float, 0.2, ("psi_threshold",),
       check=(">", 0.0),
       desc="serving drift monitor: PSI level at or below which a "
            "feature/score distribution counts as stable; evaluations "
            "with max PSI above it arm the hysteresis counter toward a "
            "drift_alert event (0.2 is the conventional "
            "investigate-shift PSI rule of thumb)"),
    _p("drift_eval_rows", int, 512, ("drift_eval_period_rows",),
       check=(">=", 1),
       desc="serving drift monitor: minimum accumulated request rows "
            "between PSI evaluations — evaluation runs on the "
            "micro-batcher's post-batch flush hook, off the request "
            "latency path and with zero extra device dispatches"),
    _p("drift_hysteresis", int, 2, ("drift_alert_hysteresis",),
       check=(">=", 1),
       desc="serving drift monitor: consecutive over-threshold "
            "evaluations required before a drift_alert fires; the "
            "alert then latches until an evaluation drops back under "
            "the threshold, so one sustained distribution shift "
            "raises exactly one alert"),
    _p("drift_mapper_threshold", float, 0.02,
       ("mapper_drift_threshold",), check=(">=", 0.0),
       desc="ingest drift monitor: per-chunk fraction of values "
            "outside the frozen mappers' training range (numeric "
            "out-of-range mass + categorical new-category rate) at or "
            "above which the chunk is flagged in the mapper_drift "
            "event — the rebuild-vs-append trigger for continuous "
            "learning"),
    # ---- SLO plane (docs/Observability.md §14) ----
    _p("slo_enabled", bool, False, ("enable_slo",),
       desc="arm the SloEngine with the built-in objective catalog "
            "(serve latency p99, shed ratio, lane/worker liveness, "
            "shadow divergence, model age, drift ceiling, training "
            "liveness, straggler skew, checkpoint age, prefetch "
            "starvation, scrape staleness). The evaluator is host-side "
            "and dispatch-neutral: it reads telemetry snapshots on a "
            "daemon ticker and never touches device arrays "
            "(counter-asserted in bench like the profile control)"),
    _p("slo_config", str, "", ("slo_objectives",),
       desc="path to a JSON objective spec file ({'objectives': "
            "[{id, target, hysteresis, ...}]}); entries matching a "
            "built-in id override it, new ids must carry a known "
            "'kind'. Setting this implies slo_enabled"),
    _p("slo_tick_period_s", float, 5.0, ("slo_period_s",),
       check=(">=", 0.0),
       desc="SLO evaluation cadence in seconds for the daemon ticker; "
            "0 disables the thread — the engine then evaluates only at "
            "the driver's drain boundaries (training) or on explicit "
            "step() calls (tests/bench)"),
    _p("slo_readyz_gating", bool, False, (),
       desc="let /readyz report 503 while a PAGE-severity serving "
            "alert is firing, so a load balancer drains a replica that "
            "is alive but violating its latency/liveness objectives. "
            "Default OFF: alerting observes, readiness gates only on "
            "structural state (warmup/rollover/wedge)"),
    # ---- Serving admission control (docs/Serving.md) ----
    _p("serve_max_queue_rows", int, 0, ("serve_queue_rows",),
       check=(">=", 0),
       desc="admission control: max TOTAL rows queued in the "
            "PredictionService micro-batcher; a submit that would "
            "overflow raises a structured ServeRejected (reason, "
            "retry_after_ms hint from the measured drain rate) "
            "synchronously instead of growing the backlog without "
            "bound. 0 = unbounded (the pre-overload-hardening "
            "behavior). PredictionService(max_queue_rows=) overrides"),
    _p("serve_max_queue_requests", int, 0, ("serve_queue_requests",),
       check=(">=", 0),
       desc="admission control: max queued REQUESTS in the "
            "micro-batcher (companion bound to serve_max_queue_rows "
            "for single-row traffic). 0 = unbounded. "
            "PredictionService(max_queue_requests=) overrides"),
    _p("serve_default_deadline_ms", float, 0.0, ("serve_deadline_ms",),
       check=(">=", 0.0),
       desc="service-level default request deadline: a queued request "
            "older than this is SHED AT DEQUEUE with "
            "ServeDeadlineExceeded — before any device work is spent "
            "on it, never after. 0 = no deadline; submit(deadline_ms=) "
            "overrides per request. "
            "PredictionService(default_deadline_ms=) overrides"),
    _p("serve_target_p99_ms", float, 0.0, ("serve_p99_target_ms",),
       check=(">=", 0.0),
       desc="arm the adaptive admission controller: drives the "
            "micro-batcher's max_delay_ms, its batch-row cap (bucket "
            "selection — smaller warmed power-of-two buckets under "
            "pressure, zero fresh compiles) and a shed watermark under "
            "the hard queue cap from the live serve.latency_ms p99 "
            "ring, with consecutive-evaluation hysteresis so it "
            "cannot flap. 0 = off (serving behavior unchanged). "
            "PredictionService(target_p99_ms=) overrides"),
    _p("serve_devices", int, 0, ("serve_n_devices",), check=(">=", 0),
       desc="serving fleet width: replicate each hot model's packed "
            "tree tensors onto this many local devices, each with its "
            "own dispatch queue + worker lane; the micro-batcher "
            "routes each micro-batch to the least-loaded replica and "
            "spills to the coldest lane before shedding. Per-device "
            "LRU/budget residency and atomic all-replica rollover "
            "apply, and predict_bulk shard-maps giant batches row-wise "
            "over the fleet. 0 = all local devices; 1 = the "
            "single-device pre-fleet serving plane (every legacy "
            "contract byte-identical). "
            "PredictionService(serve_devices=) overrides"),
    _p("serve_routing", str, "least_loaded", (),
       desc="fleet request routing across the per-device dispatch "
            "lanes: 'least_loaded' scores each lane by queued + "
            "in-flight rows weighted by its measured per-row dispatch "
            "EWMA (all-idle ties rotate round-robin so every device "
            "warms and stays measurable); 'round_robin' ignores load "
            "entirely. Only meaningful when the serving fleet has more "
            "than one device"),
    # ---- Resilience (docs/Reliability.md) ----
    _p("checkpoint_dir", str, "", ("checkpoint_path",),
       desc="directory for resumable training checkpoints "
            "(resilience/): per-rank atomic write-then-rename files "
            "under ckpt_<iteration>/ with a manifest (rank, iteration, "
            "model-state hash), written by a background thread at "
            "megastep drain boundaries / every checkpoint_period "
            "iterations; empty = checkpointing off"),
    _p("checkpoint_period", int, 0, ("checkpoint_freq",), check=(">=", 0),
       desc="checkpoint at least every N boosting iterations (0 = off). "
            "On the fast path the write lands at the next drain "
            "boundary at or past N, so checkpointing never adds a "
            "device dispatch; a crashed multi-chip run resumes from the "
            "newest rank-consistent checkpoint with at most N "
            "iterations of lost work"),
    _p("checkpoint_keep", int, 2, check=(">=", 1),
       desc="complete checkpoints retained per rank (>= 2 keeps the "
            "previous one valid while the next is being written — the "
            "double-buffer invariant)"),
    _p("resume", str, "", ("resume_from",),
       desc="resume training from a checkpoint: a concrete "
            "ckpt_<iteration> directory or a checkpoint_dir root (the "
            "newest complete hash-consistent checkpoint is selected). "
            "CLI: task=train resume=<path>; API: "
            "engine.train(resume_from=...). The resumed run's "
            "serialized model is bit-identical to an uninterrupted run "
            "with the same params/seed"),
    _p("health_auto_resync", bool, True,
       desc="on a rank_divergence health finding, re-sync the diverged "
            "rank's model state from rank 0's hash-verified "
            "serialization (score carries fixed up in place) instead of "
            "only logging; emits a structured 'recovery' event and "
            "disables itself for the run if a repair fails to converge"),
    _p("health_checkpoint_on_straggler", bool, False,
       desc="force an immediate checkpoint when the health auditor "
            "flags a straggler past health_skew_threshold (a limping "
            "rank often precedes a dead one; keeps the launcher's "
            "restart point fresh)"),
    _p("collective_timeout", float, 0.0, ("collective_timeout_s",),
       check=(">=", 0.0),
       desc="seconds before a host-plane collective (multiproc "
            "allgathers, health audits) degrades a hung peer to a "
            "structured CollectiveError instead of deadlocking the "
            "cohort; 0 = off. Set it in the params passed to the "
            "launcher so a wedged rank turns into a respawn, not a "
            "hang; size it above the worst-case first-iteration "
            "compile stall"),
    _p("collective_retries", int, 2, check=(">=", 0),
       desc="bounded retries for host collectives that raise transport "
            "errors (timeouts are never retried — the pairing is lost)"),
    _p("restart_max_retries", int, 2, check=(">=", 0),
       desc="launcher (parallel.train_distributed): cohort respawns "
            "after a rank failure before giving up"),
    _p("restart_backoff", float, 1.0, check=(">=", 0.0),
       desc="launcher: base seconds of exponential backoff between "
            "cohort respawns (base * 2^attempt)"),
]

_BY_NAME: Dict[str, _Param] = {p.name: p for p in _PARAMS}


def param_default(name: str) -> Any:
    """Registered default of one parameter — the single source of truth
    for constructor knobs that mirror config keys (PredictionService's
    serve_* admission-control defaults) without paying a full Config
    construction (and its global log-level side effect) per lookup."""
    return _BY_NAME[name].default

PARAM_ALIASES: Dict[str, str] = {}
for _param in _PARAMS:
    for _a in _param.aliases:
        PARAM_ALIASES[_a] = _param.name

_OBJECTIVE_ALIASES = {
    "regression": "regression", "regression_l2": "regression", "l2": "regression",
    "mean_squared_error": "regression", "mse": "regression",
    "l2_root": "regression", "root_mean_squared_error": "regression",
    "rmse": "regression",
    "regression_l1": "regression_l1", "l1": "regression_l1",
    "mean_absolute_error": "regression_l1", "mae": "regression_l1",
    "huber": "huber", "fair": "fair", "poisson": "poisson",
    "quantile": "quantile", "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary",
    "multiclass": "multiclass", "softmax": "multiclass",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda", "xentlambda": "cross_entropy_lambda",
    "lambdarank": "lambdarank",
    "rank_xendcg": "rank_xendcg", "xendcg": "rank_xendcg", "xe_ndcg": "rank_xendcg",
    "xe_ndcg_mart": "rank_xendcg", "xendcg_mart": "rank_xendcg",
    "none": "none", "null": "none", "custom": "none", "na": "none",
}


def _coerce(p: _Param, value: Any) -> Any:
    if p.ptype is bool:
        if isinstance(value, str):
            return value.lower() in ("true", "1", "+", "yes")
        return bool(value)
    if p.ptype is int:
        return int(float(value)) if isinstance(value, str) else int(value)
    if p.ptype is float:
        return float(value)
    if p.ptype is list:
        if isinstance(value, str):
            if not value:
                return []
            return [_auto_num(v) for v in value.split(",")]
        if isinstance(value, (list, tuple)):
            return list(value)
        return [value]
    return str(value)


def _auto_num(s: str) -> Any:
    s = s.strip()
    try:
        f = float(s)
        return int(f) if f == int(f) and "." not in s and "e" not in s.lower() else f
    except ValueError:
        return s


def _check(p: _Param, value: Any) -> None:
    for chk in (p.check, p.check2):
        if chk is None or not isinstance(value, (int, float)):
            continue
        op, bound = chk
        ok = {"<": value < bound, "<=": value <= bound,
              ">": value > bound, ">=": value >= bound}[op]
        if not ok:
            log.fatal("Parameter %s should be %s %s; got %s", p.name, op, bound, value)


class Config:
    """Resolved training configuration.

    Usage: ``cfg = Config({"num_leaves": 63, "eta": 0.05})``; attribute access
    returns resolved values (``cfg.learning_rate == 0.05``).
    """

    def __init__(self, params: Optional[Dict[str, Any]] = None):
        # copy list defaults so in-place mutation can't corrupt the registry
        self._values: Dict[str, Any] = {
            p.name: (list(p.default) if p.ptype is list else p.default)
            for p in _PARAMS}
        self.unknown: Dict[str, Any] = {}
        self._user_set: set = set()
        if params:
            self.update(params)
        else:
            self._post_process()

    # -- alias resolution (ref: config.cpp:45 KeyAliasTransform) --
    @staticmethod
    def resolve_key(key: str) -> str:
        key = key.strip().replace("-", "_")
        return PARAM_ALIASES.get(key, key)

    def update(self, params: Dict[str, Any]) -> None:
        for raw_key, value in params.items():
            key = self.resolve_key(raw_key)
            if value is None:
                continue
            p = _BY_NAME.get(key)
            if p is None:
                self.unknown[key] = value
                continue
            v = _coerce(p, value)
            _check(p, v)
            self._values[key] = v
            self._user_set.add(key)
        self._post_process()

    def _post_process(self) -> None:
        # Objective alias resolution + derived flags
        # (ref: config.cpp:193 Config::Set derived is_parallel etc.)
        obj = str(self._values["objective"]).lower()
        self._values["objective"] = _OBJECTIVE_ALIASES.get(obj, obj)
        tl = self._values["tree_learner"]
        tl_alias = {"serial": "serial", "feature": "feature",
                    "feature_parallel": "feature", "data": "data",
                    "data_parallel": "data", "voting": "voting",
                    "voting_parallel": "voting"}
        self._values["tree_learner"] = tl_alias.get(tl, tl)
        self.is_parallel = self._values["tree_learner"] != "serial"
        self.is_data_based_parallel = self._values["tree_learner"] in ("data", "voting")
        if self._values["verbosity"] < 0:
            log.set_log_level(log.LogLevel.WARNING if self._values["verbosity"] == -1
                              else log.LogLevel.FATAL)
        elif self._values["verbosity"] == 0:
            log.set_log_level(log.LogLevel.WARNING)
        elif self._values["verbosity"] == 1:
            log.set_log_level(log.LogLevel.INFO)
        else:
            log.set_log_level(log.LogLevel.DEBUG)

    def was_set(self, key: str) -> bool:
        return self.resolve_key(key) in self._user_set

    def __getattr__(self, name: str) -> Any:
        values = self.__dict__.get("_values")
        if values is not None and name in values:
            return values[name]
        raise AttributeError(name)

    def __getitem__(self, name: str) -> Any:
        return self._values[self.resolve_key(name)]

    def set(self, name: str, value: Any) -> None:
        self.update({name: value})

    def to_dict(self) -> Dict[str, Any]:
        d = dict(self._values)
        d.update(self.unknown)
        return d

    @staticmethod
    def kv2map(args: List[str]) -> Dict[str, str]:
        """Parse CLI ``k=v`` tokens (ref: config.cpp:16 KV2Map)."""
        out: Dict[str, str] = {}
        for arg in args:
            if "=" not in arg:
                continue
            k, v = arg.split("=", 1)
            out[k.strip()] = v.strip()
        return out


def param_docs() -> str:
    """Render parameter documentation (analog of generated Parameters.rst)."""
    lines = []
    for p in _PARAMS:
        alias = f" (aliases: {', '.join(p.aliases)})" if p.aliases else ""
        chk = ""
        if p.check:
            chk = f", constraint: {p.check[0]} {p.check[1]}"
        lines.append(f"- ``{p.name}``{alias}: {p.ptype.__name__}, "
                     f"default={p.default!r}{chk}. {p.desc}")
    return "\n".join(lines)


def resolve_device(device_type: str):
    """``device_type`` -> ``torch.device``. ``"cpu"`` selects the kernels'
    plain PyTorch versions; anything else names the card and raises when
    no CUDA device is present — nothing quietly carries on on the CPU."""
    import torch
    dt = str(device_type).lower()
    if dt == "cpu":
        return torch.device("cpu")
    if dt in ("cuda", "gpu"):
        dt = "cuda"
    if not dt.startswith("cuda"):
        log.fatal("device_type must be 'cuda' or 'cpu'; got %r", device_type)
    if not torch.cuda.is_available():
        log.fatal("device_type=%r needs a CUDA device and none is present; "
                  "pass device_type='cpu' to run the plain PyTorch versions "
                  "of the kernels", device_type)
    return torch.device(dt)
