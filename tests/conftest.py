import os

# Multi-device testing on a virtual CPU mesh (SURVEY.md §4 implication):
# replaces the reference's localhost-subprocess distributed mockup
# (tests/distributed/_test_distributed.py).  XLA_FLAGS must be set before
# jax initializes its backends; jax.config.update beats the JAX_PLATFORMS
# env var, which the runtime environment may pin to a TPU platform.
_flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: the learner jit varies with static shapes
# (rows, features, num_leaves, max_bins), so repeat suite runs hit the disk
# cache instead of re-tracing (~10-30 s per unique shape on CPU).
jax.config.update("jax_compilation_cache_dir", "/tmp/lgbm_tpu_jax_cache")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

import pytest  # noqa: E402

# The fused engine runs the Pallas kernels in INTERPRET mode off-TPU
# (gbdt.fused_interpret): pure-Python emulation that costs minutes per
# test on the CPU backend this suite pins above, where a real chip takes
# milliseconds. The heaviest such tests (>= ~15 s each, measured; ~1000 s
# combined) are marked `slow` so the bounded tier-1 sweep (ROADMAP.md:
# `-m 'not slow'` under a timeout) spends its window on broad coverage —
# run them explicitly with `-m slow` (or no -m filter) before touching
# kernel or engine code. test_fused_level.py (the kernel's own unit
# tests) and the fused smoke variants stay in tier-1.
_INTERPRET_HEAVY = {
    ("test_categorical.py", "test_categorical_beats_numerical_coding[fused]"),
    ("test_efb.py", "test_dense_path_bundle_count_near_ideal"),
    ("test_efb.py", "test_bundled_categorical_matches_unbundled"),
    ("test_efb.py", "test_fused_bundles_with_missing_values"),
    ("test_efb.py", "test_fused_engine_with_bundles_matches_unbundled"),
    ("test_epilogue.py", "test_binary_epilogue_identical"),
    ("test_epilogue.py", "test_binary_epilogue_deep_tree_terminal_route"),
    ("test_epilogue.py", "test_epilogue_early_stop_semantics"),
    ("test_epilogue.py", "test_epilogue_with_bagging_lookahead"),
    ("test_epilogue.py", "test_epilogue_feature_fraction"),
    ("test_epilogue.py", "test_l2_epilogue_identical"),
    ("test_fast_pipeline.py", "test_fast_matches_sync_path"),
    ("test_megastep.py", "test_megastep_bit_identical_to_fast_path"),
    ("test_megastep.py", "test_megastep_early_stop_across_boundary"),
    ("test_megastep.py", "test_megastep_valid_and_bagging"),
    ("test_megastep.py",
     "test_telemetry_iteration_granularity_keeps_fast_path"),
    ("test_megastep.py", "test_telemetry_section_granularity_forces_sync"),
    ("test_megastep.py", "test_trace_out_implies_section_granularity"),
    ("test_megastep.py", "test_update_contract_unchanged"),
    ("test_traced_eval.py", "test_multiclass_megastep_eval"),
    ("test_traced_eval.py", "test_first_metric_only_multi_eval_set"),
    ("test_traced_eval.py", "test_nan_features_megastep_eval"),
    ("test_traced_eval.py",
     "test_early_stopped_model_bit_identical_to_sync"),
    ("test_traced_eval.py",
     "test_megastep_stays_on_with_builtin_callbacks"),
    ("test_traced_eval.py", "test_snapshots_written_at_drain"),
    ("test_traced_eval.py",
     "test_megastep_evicted_event_names_feature"),
    ("test_traced_eval.py", "test_chunk_of_one_flows_through_scan"),
    ("test_traced_eval.py",
     "test_booster_trainable_after_drain_replay_stop"),
    ("test_fast_pipeline.py", "test_multiclass_fast_matches_sync"),
    ("test_fast_pipeline.py", "test_multiclass_rare_class_keeps_init_score"),
    ("test_fast_pipeline.py",
     "test_subclassed_objective_not_trained_with_base_gradients"),
    ("test_fast_valid.py", "test_valid_traces_match_unfused_path"),
    ("test_fast_valid.py", "test_fast_path_stays_on_with_valid"),
    ("test_fast_valid.py", "test_device_metrics_match_host_metrics"),
    ("test_fast_valid.py", "test_early_stopping_fires_on_fast_path"),
    ("test_fused_engine.py", "test_fused_engine_trains_binary"),
    ("test_fused_engine.py", "test_reset_parameter_callback_with_fused_engine"),
    ("test_fused_parallel.py",
     "test_fused_feature_parallel_with_interaction_constraints"),
    ("test_fused_parallel.py", "test_fused_feature_parallel_with_efb"),
    ("test_fused_parallel.py", "test_fused_feature_parallel_matches_serial"),
    ("test_fused_parallel.py", "test_fused_voting_small_topk_trains"),
    ("test_fused_parallel.py", "test_fused_voting_multiclass"),
    ("test_fused_parallel.py", "test_fused_voting_full_topk_matches_data"),
    ("test_fused_parallel.py", "test_fused_voting_matches_xla_voting_auc"),
    ("test_monotone.py", "test_intermediate_under_fused_feature_parallel"),
    ("test_monotone.py",
     "test_intermediate_mode_monotone_and_tighter_fit[fused-depthwise]"),
    ("test_monotone.py", "test_no_transitive_violation[fused-depthwise]"),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: interpret-mode fused-engine tests costing "
        "minutes on the CPU backend (run with -m slow)")
    config.addinivalue_line(
        "markers", "chaos: multi-process fault-injection acceptance "
        "tests (the CI chaos-acceptance job runs -m chaos; also part "
        "of the weekly slow pass via the paired slow marker)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where torch sees no "
        "CUDA device (run on the card with -m cuda)")


def pytest_collection_modifyitems(config, items):
    matched = set()
    for item in items:
        key = (item.fspath.basename, item.name)
        if key in _INTERPRET_HEAVY:
            item.add_marker(pytest.mark.slow)
            matched.add(key)
    # a renamed/re-parametrized test silently un-marks itself and blows
    # the bounded tier-1 window — surface the stale entry (only for
    # files that WERE collected, so single-file runs don't false-alarm;
    # a warning not an error, since -k/-m filters also shrink `items`)
    collected = {item.fspath.basename for item in items}
    stale = [k for k in _INTERPRET_HEAVY - matched if k[0] in collected]
    for basename, name in sorted(stale):
        import warnings
        warnings.warn(pytest.PytestWarning(
            f"stale _INTERPRET_HEAVY entry (no such test collected): "
            f"{basename}::{name}"))


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """The XLA CPU compiler segfaults after a few hundred compilations
    accumulate in one process (observed at ~85% of the full suite;
    every file passes in isolation). Dropping executable references
    between modules keeps the process well under that ceiling; the disk
    cache above makes any recompiles cheap."""
    yield
    jax.clear_caches()
