"""lightgbm_tpu_torch: the PyTorch / CUDA port of lightgbm_tpu.

Trains, evaluates and predicts the GBDT of the JAX package's fused and
frontier-v1 engines on an NVIDIA H100 (sm_90a) through six hand-written
CUDA kernel sources (``csrc/``: the level, route, epilogue, leaf-lookup,
frontier histogram and stacked-tree predict passes), and everything around
them in plain PyTorch:
the binary, regression, multiclass and cross-entropy objectives, GOSS,
bagging, per-tree and per-node feature sampling, interaction constraints,
valid sets, metrics, callbacks and ``cv``. Prediction at scale and serving
(``lightgbm_tpu_torch.serve``) score a model packed once on the card
through ``predict_pass``.
The JAX package ``lightgbm_tpu`` stays the reference; this package
imports nothing of it and no JAX.

    import lightgbm_tpu_torch as lgb
    ds = lgb.Dataset(X, label=y)
    dv = lgb.Dataset(Xv, label=yv, reference=ds)
    bst = lgb.train({"objective": "binary", "metric": ["auc"]}, ds,
                    num_boost_round=100, valid_sets=[dv],
                    callbacks=[lgb.early_stopping(10),
                               lgb.log_evaluation(1)])
    bst.predict(X)
    lgb.cv({"objective": "binary"}, ds, num_boost_round=10, nfold=3)
    lgb.train({"objective": "multiclass", "num_class": 3}, ds3).predict(X)
    # -> [n, 3]
    svc = lgb.serve.PredictionService({"m": bst}, max_batch_rows=1024)
    svc.warmup(); svc.predict("m", X[:10]); svc.close()
    # data files: CSV, TSV, LibSVM (sidecars .weight/.query/.init),
    # streamed with two_round, cached with save_binary
    lgb.Dataset("train.csv", params={"two_round": True,
                                     "save_binary": True})

``device_type`` defaults to ``"cuda"``; ``"cpu"`` runs the kernels' plain
PyTorch versions (the CPU tests use it).
"""
from .basic import Booster, Dataset, Sequence
from .callback import (EarlyStopException, early_stopping, log_evaluation,
                       record_evaluation, reset_parameter)
from .config import Config
from .engine import CVBooster, cv, train
from .utils.log import LightGBMError
from . import serve
from .serve import PredictionService

__all__ = ["Booster", "CVBooster", "Config", "Dataset", "EarlyStopException",
           "LightGBMError", "PredictionService", "Sequence", "cv",
           "early_stopping", "log_evaluation", "record_evaluation",
           "reset_parameter", "serve", "train"]
__version__ = "0.1.0"
