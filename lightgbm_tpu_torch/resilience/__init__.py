"""Fault tolerance for long runs (a port of ``lightgbm_tpu/resilience/``).

- :mod:`atomicio` — write-then-rename helpers: a crash mid-write never
  leaves a truncated model, checkpoint or cache;
- :mod:`checkpoint` — asynchronous per-rank checkpoints: the trainer
  captures the resumable state every ``checkpoint_period`` iterations, a
  writer thread commits it with a per-rank manifest (rank, iteration,
  model-state hash), keeping ``checkpoint_keep`` of them;
- :mod:`state` — capture and restore of the trainer's training state
  (trees, scores, random streams, early-stop and callback state), so
  ``train(resume_from=...)`` gives the uninterrupted model byte for byte;
- :mod:`recovery` — a diverged rank re-synced from rank 0's
  hash-verified model over the host plane;
- :mod:`faults` — deterministic fault injection (crash, hang, diverge,
  torn checkpoint at a fixed iteration and rank) for chaos tests;
- :mod:`comms` — the timeout and bounded-retry guard of the host-plane
  collectives (``collective_timeout``, ``collective_retries``).
"""
from __future__ import annotations

from .atomicio import atomic_write_bytes, atomic_write_json, atomic_write_text
from .checkpoint import (CheckpointManager, list_checkpoints, load_rank,
                         select_checkpoint)
from .comms import CollectiveError, guarded_call, set_collective_policy
from .faults import FaultRegistry, registry_from_env

__all__ = [
    "atomic_write_bytes", "atomic_write_json", "atomic_write_text",
    "CheckpointManager", "list_checkpoints", "load_rank",
    "select_checkpoint",
    "CollectiveError", "guarded_call", "set_collective_policy",
    "FaultRegistry", "registry_from_env",
]
