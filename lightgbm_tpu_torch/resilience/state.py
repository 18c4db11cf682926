"""Capture and restore of the trainer's resumable training state (a port of
``lightgbm_tpu/resilience/state.py``; its ``synthesize_es_carry`` has no
counterpart: the port's megastep evaluates inline, so the restored
callback states carry the early stop, as on the JAX package's
synchronous body).

A checkpoint holds everything the trainer needs to continue a run byte for
byte as one that was never interrupted:

- the model (every HostTree's arrays, float64, binary exact);
- the training and valid scores by value (f32; replaying the trees would
  add them in another order);
- the bagging block-LCG stream state, the live in-bag weights and the
  per-round cache of drawn masks (the epilogue body draws one round
  ahead), the feature-fraction LCG position, the gain-screening EMA, and
  the boosting extras (GOSS's MT19937, DART's drop stream and tree
  weights);
- the engine's extra state: the callbacks' states (the early-stopping
  bests, the recorded curves) and the last evaluation list.

CEGB's ``cegb_used`` is not captured, as in the JAX package: a resumed
booster starts it at zeros. The telemetry counters, the data profile and
the provenance record are written empty (``{}``, ``None``, ``None``), as
the JAX package writes them with telemetry and profiles off, until
ROADMAP Queue A item 10e.

``capture`` runs on the training thread at an iteration edge, where the
device to host copies synchronize anyway; the writer thread gets numpy
arrays only. Under ranks each rank captures and restores its own rows of
the scores and its in-bag weights (the JAX package keeps the full host
weights there: a JAX checkpoint of several processes does not resume in
the port); the checkpoints are per-rank files, selected as a
hash-consistent set.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.tree import HostTree
from ..obs.health import model_state_hash
from ..parallel import mesh
from ..utils import log

# per-tree numeric arrays saved verbatim (HostTree field -> npz entry)
_TREE_FIELDS = ("split_feature", "threshold", "threshold_bin",
                "decision_type", "left_child", "right_child", "split_gain",
                "internal_value", "internal_weight", "internal_count",
                "leaf_value", "leaf_weight", "leaf_count", "leaf_depth")

_SANITY_KEYS = ("objective", "num_class", "tree_learner", "num_leaves",
                "learning_rate", "max_bin", "bagging_seed", "bagging_freq",
                "bagging_fraction", "feature_fraction",
                "feature_fraction_seed", "seed")


def _host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` that no later in-place update reaches."""
    return t.detach().to("cpu", copy=True).numpy()


def trees_to_arrays(models: List[HostTree]) -> Tuple[List[Dict], Dict]:
    """(per-tree JSON meta, npz arrays) of a model list, for the
    checkpoint and the resync blob."""
    meta: List[Dict] = []
    arrays: Dict[str, np.ndarray] = {}
    for i, ht in enumerate(models):
        m: Dict[str, Any] = {
            "num_leaves": int(ht.num_leaves),
            "shrinkage": float(ht.shrinkage),
            "cat_boundaries": [int(x) for x in ht.cat_boundaries],
            "cat_threshold": [int(x) for x in ht.cat_threshold],
        }
        if ht.is_linear:
            m["is_linear"] = True
            m["leaf_const"] = [float(x) for x in np.asarray(ht.leaf_const)]
            m["leaf_features"] = [[int(f) for f in fs]
                                  for fs in ht.leaf_features]
            m["leaf_coeff"] = [[float(c) for c in cs]
                               for cs in ht.leaf_coeff]
        meta.append(m)
        for f in _TREE_FIELDS:
            arrays[f"t{i}_{f}"] = np.array(getattr(ht, f))
    return meta, arrays


def trees_from_arrays(meta: List[Dict], arrays) -> List[HostTree]:
    models: List[HostTree] = []
    for i, m in enumerate(meta):
        ht = HostTree(int(m["num_leaves"]),
                      shrinkage=float(m.get("shrinkage", 1.0)))
        for f in _TREE_FIELDS:
            setattr(ht, f, np.array(arrays[f"t{i}_{f}"]))
        ht.cat_boundaries = [int(x) for x in m.get("cat_boundaries", [0])]
        ht.cat_threshold = [int(x) for x in m.get("cat_threshold", [])]
        if m.get("is_linear"):
            ht.is_linear = True
            ht.leaf_const = np.asarray(m.get("leaf_const", []), np.float64)
            ht.leaf_features = [list(fs) for fs in m.get("leaf_features",
                                                         [])]
            ht.leaf_coeff = [list(cs) for cs in m.get("leaf_coeff", [])]
        models.append(ht)
    return models


# ------------------------------------------------------------- capture
def capture(gbdt, extra: Optional[Callable[[], Dict[str, Any]]] = None
            ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """Snapshot the trainer's resumable state as (JSON payload, numpy
    arrays), at an iteration edge. ``extra`` returns the engine's
    JSON-able state (the callbacks' states, the last evaluation list)."""
    cfg = gbdt.config
    meta, arrays = trees_to_arrays(gbdt.models)
    arrays["scores"] = _host(gbdt.scores)
    for vi, vs in enumerate(gbdt.valid_scores):
        arrays[f"vscore{vi}"] = _host(vs)
    arrays["bag_stream_state"] = np.array(gbdt.bag_streams.state)
    bag = {"is_bagging": bool(gbdt.is_bagging),
           "bag_cnt": int(gbdt.bag_cnt)}
    if gbdt.is_bagging:
        arrays["bag_weight"] = _host(gbdt.bag_weight)
    cache = gbdt._bag_round_cache
    bag["cache_keys"] = sorted(int(key) for key in cache)
    for j, key in enumerate(bag["cache_keys"]):
        arrays[f"bag_cache{j}"] = np.array(cache[key], bool)
    if gbdt.use_screening:
        # without the EMA a resumed run would re-warm the screening mask
        arrays["gain_ema"] = _host(gbdt._gain_ema)
    extra_payload, extra_arrays = gbdt._capture_boosting_extra()
    arrays.update(extra_arrays)
    engine_extra: Dict[str, Any] = {}
    if extra is not None:
        try:
            engine_extra = extra() or {}
        except Exception as e:
            log.warning("checkpoint extra-state capture failed: %s", e)
    payload = {
        "schema": 1,
        "iteration": int(gbdt.iter),
        "num_init_iteration": int(gbdt.num_init_iteration),
        "boosting": gbdt.name,
        "rank": mesh.rank(),
        "world": mesh.world(),
        "k": int(gbdt.num_tree_per_iteration),
        "n_trees": len(gbdt.models),
        "n_valid": len(gbdt.valid_scores),
        # rank=-1: the manifest describes the real model, never salted
        "model_hash": model_state_hash(gbdt.models, rank=-1),
        "shrinkage_rate": float(gbdt.shrinkage_rate),
        "trees_meta": meta,
        "bag": bag,
        "feat_rng_x": int(gbdt.feat_rng.x),
        "best": [[ds, name, float(gbdt.best_score[(ds, name)]),
                  int(gbdt.best_iter.get((ds, name), 0))]
                 for (ds, name) in sorted(gbdt.best_score)],
        "boosting_extra": extra_payload,
        "engine_extra": engine_extra,
        "telemetry_counters": {},
        "sanity": {key: getattr(cfg, key, None) for key in _SANITY_KEYS},
        "data_profile": None,
        "provenance": None,
    }
    return payload, arrays


# ------------------------------------------------------------- restore
def restore(gbdt, payload: Dict[str, Any], arrays) -> int:
    """Rebuild the trainer's training state from a checkpoint; returns the
    restored iteration. The booster was just built on the same dataset
    and parameters, with every valid set added (``engine.train`` keeps
    that order)."""
    world = mesh.world()
    if payload.get("schema") != 1:
        log.fatal("unsupported checkpoint schema %r",
                  payload.get("schema"))
    if payload.get("boosting") != gbdt.name:
        log.fatal("checkpoint was written by boosting=%s; this run is %s",
                  payload.get("boosting"), gbdt.name)
    if int(payload.get("k", 0)) != gbdt.num_tree_per_iteration:
        log.fatal("checkpoint has %s trees/iteration, run has %d",
                  payload.get("k"), gbdt.num_tree_per_iteration)
    if int(payload.get("world", 1)) != world:
        log.fatal("checkpoint was written by a %s-process run; this run "
                  "spans %d processes (score shards are rank-local)",
                  payload.get("world"), world)
    if int(payload.get("n_valid", 0)) != len(gbdt.valid_scores):
        log.fatal("checkpoint carries %s valid sets, run has %d — add "
                  "the same valid sets before resuming",
                  payload.get("n_valid"), len(gbdt.valid_scores))
    rows = {"scores": int(np.shape(arrays["scores"])[-1])}
    if "bag_weight" in arrays:
        rows["bag_weight"] = int(np.size(arrays["bag_weight"]))
    if any(v != gbdt.num_data for v in rows.values()):
        # a JAX checkpoint of several processes keeps the full host bag
        # weights: its layout is not this rank's rows
        log.fatal("checkpoint rows %s do not match this rank's %d rows — "
                  "a checkpoint from another data layout (a JAX "
                  "multi-process run, or other data)", rows, gbdt.num_data)
    sanity = payload.get("sanity") or {}
    cfg = gbdt.config
    drift = {key: (sanity.get(key), getattr(cfg, key, None))
             for key in _SANITY_KEYS
             if key in sanity and sanity[key] != getattr(cfg, key, None)}
    if drift:
        log.warning("resume with changed parameters (bit-identity to an "
                    "uninterrupted run is off): %s",
                    {key: f"{a!r}->{b!r}" for key, (a, b) in drift.items()})

    models = trees_from_arrays(payload["trees_meta"], arrays)
    want = payload.get("model_hash", "")
    got = model_state_hash(models, rank=-1)
    if want and got != want:
        log.fatal("restored model hash %s does not match the manifest's "
                  "%s — torn or mismatched checkpoint", got[:16],
                  want[:16])
    gbdt.models[:] = models
    gbdt.iter = int(payload["iteration"])
    gbdt.num_init_iteration = int(payload.get("num_init_iteration", 0))
    gbdt.shrinkage_rate = float(payload.get("shrinkage_rate",
                                            gbdt.shrinkage_rate))

    def dev(a):
        return torch.tensor(np.asarray(a, np.float32), device=gbdt.device)
    gbdt.scores = dev(arrays["scores"])
    for vi in range(len(gbdt.valid_scores)):
        gbdt.valid_scores[vi] = dev(arrays[f"vscore{vi}"])

    gbdt.bag_streams.state = np.asarray(arrays["bag_stream_state"],
                                        np.uint32)
    bag = payload.get("bag") or {}
    if bag.get("is_bagging") and "bag_weight" in arrays:
        gbdt._set_bag(np.asarray(arrays["bag_weight"]) != 0)
    gbdt.bag_cnt = int(bag.get("bag_cnt", gbdt.bag_cnt))
    gbdt._bag_round_cache = {
        int(key): np.asarray(arrays[f"bag_cache{j}"], bool)
        for j, key in enumerate(bag.get("cache_keys", []))}
    gbdt.feat_rng.x = int(payload.get("feat_rng_x", gbdt.feat_rng.x))
    if "gain_ema" in arrays and gbdt.use_screening:
        gbdt._gain_ema = dev(arrays["gain_ema"])

    gbdt.best_score.clear()
    gbdt.best_iter.clear()
    for ds, name, score, it in payload.get("best", []):
        gbdt.best_score[(ds, name)] = float(score)
        gbdt.best_iter[(ds, name)] = int(it)

    gbdt._restore_boosting_extra(payload.get("boosting_extra") or {},
                                 arrays)
    # transient trainer state: the next iteration primes the epilogue
    # carry from the restored scores
    gbdt._epi_carry = None
    gbdt._last_ckpt_iter = gbdt.iter
    log.info("resumed training at iteration %d (%d trees, hash %s)",
             gbdt.iter, len(models), got[:16])
    return gbdt.iter


# -------------------------------------------------- booster-level entry
def resolve_checkpoint(path: str, world: int) -> str:
    """A concrete ``ckpt_*`` directory, or the newest complete and
    hash-consistent one under a checkpoint root."""
    from .checkpoint import checkpoint_manifests, select_checkpoint
    if not os.path.isdir(path):
        log.fatal("resume path %r is not a directory", path)
    if checkpoint_manifests(path, world) is not None:
        return path
    sel = select_checkpoint(path, world)
    if sel is None:
        log.fatal("no complete %d-rank checkpoint under %r "
                  "(torn or missing manifests)", world, path)
    return sel


def restore_into_booster(booster, path: str) -> Dict[str, Any]:
    """Load this rank's part of a checkpoint and restore the booster's
    trainer; returns the payload (the engine restores the callback states
    from ``payload['engine_extra']``)."""
    from .checkpoint import load_rank
    gbdt = booster._gbdt
    if gbdt is None:
        log.fatal("resume requires a booster constructed with a train_set")
    cdir = resolve_checkpoint(str(path), mesh.world())
    payload, arrays = load_rank(cdir, mesh.rank())
    restore(gbdt, payload, arrays)
    booster.best_iteration = -1
    booster._model_version += 1
    return payload


def booster_from_checkpoint(path: str, rank: int = 0,
                            params: Optional[Dict[str, Any]] = None):
    """A prediction-only ``Booster`` from a checkpoint (a concrete
    ``ckpt_<n>`` directory, or the newest under a root with a valid
    ``rank{rank}`` manifest; the model is the same on every rank). The
    trees are hash-checked against the manifest; the objective, the
    classes and RF's averaging come from the checkpoint. ``params`` are
    the Booster's (``device_type``)."""
    from ..basic import Booster
    from ..objective import create_objective_from_string
    from .checkpoint import _read_manifest, list_checkpoints, load_rank

    cdir = str(path)

    def _has_rank(d: str) -> bool:
        return _read_manifest(
            os.path.join(d, f"rank{rank}.json")) is not None

    if not (os.path.isdir(cdir) and _has_rank(cdir)):
        sel = next((p for _, p in list_checkpoints(cdir)
                    if _has_rank(p)), None) if os.path.isdir(cdir) \
            else None
        if sel is None:
            raise FileNotFoundError(
                f"no checkpoint with a valid rank{rank} manifest under "
                f"{path!r}")
        cdir = sel
    payload, arrays = load_rank(cdir, rank)
    models = trees_from_arrays(payload["trees_meta"], arrays)
    want = payload.get("model_hash", "")
    got = model_state_hash(models, rank=-1)
    if want and got != want:
        raise ValueError(
            f"checkpoint {cdir!r}: restored model hash {got[:16]} does "
            f"not match the manifest's {want[:16]} — torn or mismatched "
            "checkpoint")
    sanity = payload.get("sanity") or {}
    b = Booster(params=params)
    b.models = models
    b.num_tree_per_iteration = max(1, int(payload.get("k", 1)))
    b.num_class = max(1, int(sanity.get("num_class") or 1))
    # rf averages its trees; every other boosting mode sums
    b.average_output = payload.get("boosting") == "rf"
    b.max_feature_idx = max([int(np.asarray(ht.split_feature).max())
                             for ht in models
                             if np.asarray(ht.split_feature).size] + [0])
    obj = str(sanity.get("objective") or "none")
    if b.num_class > 1 and "num_class" not in obj:
        obj = f"{obj} num_class:{b.num_class}"
    b._objective_str = obj
    b.objective = create_objective_from_string(obj)
    b.best_iteration = -1
    b._model_version += 1
    log.info("checkpoint %s as a booster (iteration %s, %d trees, hash "
             "%s)", cdir, payload.get("iteration"), len(models), got[:16])
    return b


def callback_states(callbacks: List) -> List[Dict[str, Any]]:
    """The serializable state of every stateful callback (those with
    ``_cb_state``), tagged by kind and position."""
    out = []
    for pos, cb in enumerate(callbacks):
        state_fn = getattr(cb, "_cb_state", None)
        if state_fn is None:
            continue
        try:
            st = state_fn()
        except Exception as e:
            log.warning("callback state capture failed: %s", e)
            continue
        out.append({"kind": getattr(cb, "_megastep_replay",
                                    type(cb).__name__),
                    "pos": pos, "state": st})
    return out


def restore_callback_states(callbacks: List, saved: List[Dict[str, Any]],
                            env) -> None:
    """Feed saved states back into the matching callbacks (by kind, in
    order)."""
    by_kind: Dict[str, List[Dict]] = {}
    for ent in saved or []:
        by_kind.setdefault(ent.get("kind", ""), []).append(ent)
    for cb in callbacks:
        kind = getattr(cb, "_megastep_replay", None)
        restore_fn = getattr(cb, "_cb_restore", None)
        if restore_fn is None or kind is None:
            continue
        pool = by_kind.get(kind)
        if not pool:
            continue
        ent = pool.pop(0)
        try:
            restore_fn(ent["state"], env)
        except Exception as e:
            if kind == "early_stopping":
                # a broken restore would silently change the stopping
                # decision, the one thing a resume promises not to do
                log.fatal("early-stopping state restore failed: %s — "
                          "resume with the same valid sets/metrics the "
                          "interrupted run used, or drop the "
                          "early_stopping callback", e)
            log.warning("callback state restore failed (%s): %s", kind, e)


def eval_list_from_payload(payload: Dict[str, Any]) -> List[tuple]:
    ev = (payload.get("engine_extra") or {}).get("eval_list") or []
    return [tuple(t) for t in ev]
