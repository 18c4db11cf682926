"""The model-state digest of the cross-rank health auditor (a copy of
``model_state_hash`` from ``lightgbm_tpu/obs/health.py``; the auditor
itself is ROADMAP Queue A item 10e).

Under the SPMD contract every rank grows the same trees, so the digests
of two ranks agree bit for bit exactly when their models do. The
checkpoint manifests carry it (``resilience/checkpoint.py``), a restore
verifies it, and the rank-0 resync (``resilience/recovery.py``) compares
it across ranks. Setting ``LIGHTGBM_TPU_HEALTH_FAULT_RANK=<r>`` salts
rank r's digest, the JAX package's fault injection for a divergence that
mistrains nothing.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np

FAULT_RANK_ENV = "LIGHTGBM_TPU_HEALTH_FAULT_RANK"


def model_state_hash(models, rank: int = 0) -> str:
    """SHA-256 over every tree's leaf values and split parameters
    (feature, bin and real threshold, decision type) in model order, with
    the JAX package's dtypes, so both packages give one digest for the
    same trees. A full re-hash per call: DART normalization, RF renewal
    and rollback change trees already made."""
    h = hashlib.sha256()
    for t in models:
        for arr, dt in ((t.leaf_value, np.float64),
                        (t.split_feature, np.int32),
                        (t.threshold, np.float64),
                        (t.threshold_bin, np.int32),
                        (t.decision_type, np.int32)):
            h.update(np.ascontiguousarray(
                np.asarray(arr, dtype=dt)).tobytes())
    fault = os.environ.get(FAULT_RANK_ENV, "")
    if fault:
        try:
            if int(fault) == int(rank):
                h.update(b"injected-fault")
        except ValueError:
            pass
    return h.hexdigest()
