"""Device-resident prediction serving on the card.

PyTorch counterpart of ``lightgbm_tpu/serve/``: trees packed once into
the stacked tensors ``models/predictor.py`` builds, scored by one
``predict_pass`` launch (``csrc/predict_pass.cu``) per micro-batch with
power-of-two row buckets (after warmup every request size reuses a
warmed bucket: no new dispatch signature), request micro-batching with
deadline coalescing, and multi-model residency under a bytes budget.

Layers:

- :class:`ServingEngine` (engine.py) — one packed model: bucketed
  dispatches on the lane's CUDA stream with deterministic
  compile/dispatch counters, and degradation to the float64 walk for
  models the stack cannot hold;
- :class:`MicroBatcher` (batcher.py) — thread-safe request queue with
  ``max_batch_rows`` / ``max_delay_ms`` coalescing, one device call per
  micro-batch, future-based responses, admission control, deadlines and
  wedged-worker detection;
- :class:`ResidencyManager` (residency.py) — N models on the card under
  a bytes budget with LRU eviction and pin/unpin, one replica table per
  lane in a fleet;
- :class:`BulkScorer` (bulk.py) — offline scoring split across the
  fleet's lanes, one ``predict_pass`` a lane per chunk
  (``PredictionService.predict_bulk``);
- :class:`PredictionService` (service.py) — the public facade:
  ``PredictionService(boosters_or_paths).predict(model_id, X)``.

Serving fleet: with ``serve_devices > 1`` (or ``devices=[...]``, repeats
allowed) each model is replicated onto every lane's device, one dispatch
lane (queue, worker thread, CUDA stream) per replica; the micro-batcher
routes to the least-loaded lane (or round-robin), spills to the coldest
lane before shedding, and keeps the per-lane contract — 1.0 dispatch per
request, 0 steady-state compiles. Rollover swaps every replica at once.
"""
from .admission import AdmissionController
from .batcher import MicroBatcher
from .bulk import BulkScorer
from .engine import ServingEngine
from .errors import (RetryPolicy, ServeClosed, ServeDeadlineExceeded,
                     ServeError, ServeRejected, ServeWorkerWedged)
from .residency import ResidencyManager
from .service import PredictionService

__all__ = ["PredictionService", "ServingEngine", "MicroBatcher",
           "ResidencyManager", "BulkScorer", "AdmissionController",
           "RetryPolicy", "ServeError", "ServeRejected",
           "ServeDeadlineExceeded", "ServeClosed", "ServeWorkerWedged"]
