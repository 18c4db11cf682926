"""lightgbm_tpu_torch: the PyTorch / CUDA port of lightgbm_tpu.

Trains and predicts the fused-engine GBDT on an NVIDIA H100 (sm_90a) with
hand-written CUDA kernels for the level, route and leaf-lookup passes
(``csrc/``), and everything around them in plain PyTorch. The JAX package
``lightgbm_tpu`` stays the reference; this package imports nothing of it
and no JAX.

    import lightgbm_tpu_torch as lgb
    ds = lgb.Dataset(X, label=y)
    bst = lgb.train({"objective": "binary"}, ds, num_boost_round=10)
    bst.predict(X)

``device_type`` defaults to ``"cuda"``; ``"cpu"`` runs the kernels' plain
PyTorch versions (the CPU tests use it).
"""
from .basic import Booster, Dataset
from .config import Config
from .engine import train
from .utils.log import LightGBMError

__all__ = ["Booster", "Config", "Dataset", "LightGBMError", "train"]
__version__ = "0.1.0"
