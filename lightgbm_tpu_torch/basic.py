"""User-facing Dataset and Booster.

PyTorch counterpart of ``lightgbm_tpu/basic.py`` on the main path:
``Dataset(X, label=...)`` -> ``train`` or ``Booster(params, train_set)``
with ``update()`` / ``rollback_one_iter()`` -> ``Booster.predict(X)`` /
``Booster.model_to_string()``, plus loading a model text
(``Booster(model_str=...)``). Training and prediction run on
``device_type`` (default ``"cuda"``; ``"cpu"`` runs the kernels' plain
PyTorch versions).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .boosting.gbdt import GBDT
from .config import Config, resolve_device
from .dataset import BinnedDataset
from .io import model_io
from .models.tree import HostTree
from .objective import create_objective, create_objective_from_string
from .ops.predict import predict_raw
from .utils.log import LightGBMError  # noqa: F401  (re-exported)


def _to_2d_numpy(data) -> np.ndarray:
    if hasattr(data, "values") and not isinstance(data, np.ndarray):
        data = data.values  # pandas
    arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    if arr.dtype == object:
        arr = arr.astype(np.float64)
    return arr


class Dataset:
    """Training dataset with lazy construction (ref: basic.py:1122)."""

    def __init__(self, data, label=None, weight=None, feature_name="auto",
                 params: Optional[Dict[str, Any]] = None):
        self.data = data
        self.label = label
        self.weight = weight
        self.feature_name = feature_name
        self.params = dict(params) if params else {}
        self._inner: Optional[BinnedDataset] = None

    def construct(self) -> "Dataset":
        if self._inner is not None:
            return self
        cfg = Config(self.params)
        names = (list(self.feature_name)
                 if self.feature_name not in ("auto", None) else None)
        inner = BinnedDataset.from_data(
            _to_2d_numpy(self.data), cfg, resolve_device(cfg.device_type),
            feature_names=names)
        if self.label is not None:
            inner.metadata.set_label(np.asarray(self.label))
        if self.weight is not None:
            inner.metadata.set_weight(np.asarray(self.weight))
        self._inner = inner
        return self


class Booster:
    """Training + prediction handle (ref: basic.py:2512)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_str: Optional[str] = None):
        self.params = dict(params) if params else {}
        self.best_iteration = -1
        self._gbdt: Optional[GBDT] = None
        self.models: List[HostTree] = []
        self.objective = None
        self.config: Optional[Config] = None
        self.train_set: Optional[Dataset] = None
        self.loaded_parameter = ""
        self.num_class = 1
        self.num_tree_per_iteration = 1
        self.max_feature_idx = 0
        self.feature_names: List[str] = []
        self.feature_infos: List[str] = []
        self.label_index = 0
        self.average_output = False
        self.device = None
        if train_set is not None:
            self._init_train(train_set)
        elif model_str is not None:
            self._load_model_string(model_str)

    def _init_train(self, train_set: Dataset) -> None:
        if not isinstance(train_set, Dataset):
            raise TypeError("Training data should be Dataset instance")
        merged = dict(train_set.params)
        merged.update(self.params)
        self.config = Config(merged)
        train_set.params = merged
        train_set.construct()
        self.train_set = train_set
        inner = train_set._inner
        self.device = inner.device
        self.objective = create_objective(self.config)
        if self.objective is not None:
            if inner.metadata.label is None:
                raise ValueError("Label should not be None")
            self.objective.init(inner.metadata, inner.num_data, self.device)
        self._gbdt = GBDT()
        self._gbdt.init(self.config, inner, self.objective)
        self.models = self._gbdt.models
        self.max_feature_idx = inner.num_total_features - 1
        self.feature_names = inner.feature_names
        self.feature_infos = inner.feature_infos()

    def update(self) -> bool:
        """One boosting iteration; True when training stopped (ref:
        basic.py:2936 Booster.update). Takes the epilogue body wherever it
        applies (binary or L2 with ``tpu_fused_epilogue``; see
        ``boosting/gbdt.py``)."""
        return self._gbdt.train_one_iter()

    def rollback_one_iter(self) -> "Booster":
        """Remove the last iteration's tree and its training-score
        contribution."""
        self._gbdt.rollback_one_iter()
        return self

    def num_trees(self) -> int:
        return len(self.models)

    def train_scores(self) -> torch.Tensor:
        """The trainer's accumulated raw scores [n] (float32, device)."""
        return self._gbdt.scores[0]

    # ------------------------------------------------------------------
    def predict(self, data, num_iteration: Optional[int] = None,
                raw_score: bool = False) -> np.ndarray:
        """Predictions on raw features, routed in float64 on the device
        (ref: basic.py:3449 Booster.predict)."""
        X = torch.as_tensor(_to_2d_numpy(data).astype(np.float64),
                            device=self._predict_device())
        k = self.num_tree_per_iteration
        if k != 1 or self.average_output:
            raise NotImplementedError("multiclass and averaged-output "
                                      "models are not ported yet")
        total = len(self.models) // k
        if num_iteration is None or num_iteration <= 0:
            num_iteration = total
        hi = min(num_iteration, total) * k
        raw = predict_raw(self.models[:hi], X, k).cpu().numpy()
        if not raw_score and self.objective is not None:
            return np.asarray(self.objective.convert_output(raw[0]))
        return raw[0]

    def _predict_device(self):
        if self.device is None:
            self.device = resolve_device(
                Config(self.params).device_type)
        return self.device

    # ------------------------------------------------------------------
    def model_to_string(self, num_iteration: Optional[int] = None) -> str:
        return model_io.save_model_to_string(
            self, 0, -1 if num_iteration is None else num_iteration)

    def _load_model_string(self, model_str: str) -> None:
        header, trees, params = model_io.parse_model_string(model_str)
        self.models = trees
        self.loaded_parameter = params
        self.num_class = int(header.get("num_class", 1))
        self.num_tree_per_iteration = int(
            header.get("num_tree_per_iteration", 1))
        self.max_feature_idx = int(header.get("max_feature_idx", 0))
        self.label_index = int(header.get("label_index", 0))
        self.average_output = header.get("average_output", "0") == "1"
        self.feature_names = header.get("feature_names", "").split()
        self.feature_infos = header.get("feature_infos", "").split()
        self.objective = create_objective_from_string(
            header.get("objective", "none"))
