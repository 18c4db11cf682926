"""Repair of a rank whose model diverged, from rank 0's model (a port of
``lightgbm_tpu/resilience/recovery.py``; the health auditor that calls it
is ROADMAP Queue A item 10e).

Every rank takes part, so the ranks make the same host-plane gathers in
the same order: rank 0 serializes its trees, every rank verifies them
against rank 0's digest, and a rank whose trees differ swaps them in.
The training and valid scores follow: each tree in the gathered union of
the ranks' differing indices is subtracted (the rank's own old tree, the
one its score rows were trained with) and added back (the repaired tree),
through the trainer's host-tree replay (``_add_host_tree``) in f32. The
union keeps the replays the same on every rank. Afterwards the digests
are gathered again: equal means repaired.
"""
from __future__ import annotations

import base64
import io
import json
from typing import Dict, List

import numpy as np

from ..obs.health import model_state_hash
from ..parallel import mesh
from ..utils import log
from .state import trees_from_arrays, trees_to_arrays


def serialize_models_blob(models) -> str:
    """Model list -> an ascii blob (npz arrays and JSON meta, base64) that
    rides the JSON host-plane gather."""
    meta, arrays = trees_to_arrays(models)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return json.dumps({"meta": meta,
                       "npz": base64.b64encode(buf.getvalue())
                       .decode("ascii")})


def deserialize_models_blob(blob: str):
    obj = json.loads(blob)
    arrays = np.load(io.BytesIO(base64.b64decode(obj["npz"])),
                     allow_pickle=False)
    return trees_from_arrays(obj["meta"], arrays)


def _trees_differ(a, b) -> bool:
    """The fields the model-state hash covers: a digest mismatch maps to
    at least one differing tree."""
    for field, dt in (("leaf_value", np.float64),
                      ("split_feature", np.int32),
                      ("threshold", np.float64),
                      ("threshold_bin", np.int32),
                      ("decision_type", np.int32)):
        av = np.asarray(getattr(a, field), dtype=dt)
        bv = np.asarray(getattr(b, field), dtype=dt)
        if av.shape != bv.shape or not np.array_equal(av, bv):
            return True
    return False


def _replay_tree(gbdt, idx: int, ht, scale: float) -> None:
    """``scale`` times host tree ``ht`` (model ``idx``'s slot) onto the
    training and valid scores of its class."""
    tid = idx % gbdt.num_tree_per_iteration
    td = gbdt.train_data
    gbdt.scores[tid] = gbdt._add_host_tree(
        gbdt.scores[tid], td.bins_dev, ht, scale, gbdt._bundle_of(td))
    for vd, vs in zip(gbdt.valid_data, gbdt.valid_scores):
        vs[tid] = gbdt._add_host_tree(vs[tid], vd.bins_dev, ht, scale,
                                      gbdt._bundle_of(vd))


def resync_from_rank0(gbdt, it: int, per_rank: List[Dict]) -> bool:
    """Repair a divergence from rank 0's hash-verified model. Every rank
    calls it at the same point, with every rank's ``{"rank", "hash"}``;
    True when the digests agree afterwards."""
    from ..obs.registry import allgather_json
    if len(per_rank) <= 1:
        return True
    rank = mesh.rank()
    gbdt._epi_carry = None      # the scores change outside the carry
    ref_hash = next((r["hash"] for r in per_rank
                     if int(r["rank"]) == 0), None)
    # rank 0 ships its serialization, the others a placeholder: the
    # gather is the broadcast
    blob = serialize_models_blob(gbdt.models) if rank == 0 else None
    payloads = allgather_json({"blob": blob})
    src = payloads[0].get("blob") if payloads else None
    replaced = 0
    union: List[int] = []
    if src is None:
        log.warning("divergence resync aborted: rank 0 sent no model")
    else:
        new_models = deserialize_models_blob(src)
        verified = model_state_hash(new_models, rank=-1) == ref_hash
        if not verified:
            log.warning("divergence resync: rank 0's serialization does "
                        "not reproduce its reported hash; model left "
                        "untouched")
        usable = verified and len(new_models) == len(gbdt.models)
        local_diff = ([i for i in range(len(new_models))
                       if _trees_differ(gbdt.models[i], new_models[i])]
                      if usable else [])
        gathered = allgather_json({"diff": local_diff, "usable": usable})
        if all(g.get("usable") for g in gathered):
            union = sorted({i for g in gathered for i in g["diff"]})
        for idx in union:
            _replay_tree(gbdt, idx, gbdt.models[idx], -1.0)
            if idx in local_diff:
                gbdt.models[idx] = new_models[idx]
                replaced += 1
            _replay_tree(gbdt, idx, gbdt.models[idx], 1.0)
    post = allgather_json(
        {"hash": model_state_hash(gbdt.models, rank=rank)})
    ok = len({p["hash"] for p in post}) == 1
    if ok:
        log.warning("rank divergence at iteration %d repaired from rank 0 "
                    "(%d trees replaced on rank %d, %d replayed)", it,
                    replaced, rank, len(union))
    return ok


def inject_divergence(gbdt, it: int) -> None:
    """Chaos hook (the ``diverge`` fault): perturb the newest grown tree on
    this rank, its model and this rank's scores together, the state
    :func:`resync_from_rank0` repairs."""
    target = None
    for idx in range(len(gbdt.models) - 1, -1, -1):
        if gbdt.models[idx].num_leaves > 1:
            target = idx
            break
    if target is None:
        log.warning("diverge fault: no grown tree to corrupt yet")
        return
    ht = gbdt.models[target]
    gbdt._epi_carry = None
    _replay_tree(gbdt, target, ht, -1.0)
    ht.leaf_value = np.asarray(ht.leaf_value, np.float64) + 1e-3
    _replay_tree(gbdt, target, ht, 1.0)
    log.warning("fault injection: diverged rank %d at iteration %d (tree "
                "%d leaf values perturbed)", mesh.rank(), it, target)
