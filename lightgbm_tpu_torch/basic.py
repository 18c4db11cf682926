"""User-facing Dataset and Booster.

PyTorch counterpart of ``lightgbm_tpu/basic.py``: ``Dataset(X, label=...,
reference=..., group=..., init_score=..., categorical_feature=...)`` (valid
sets bin with their reference's mappers; ``create_valid``, ``subset``, the
field accessors; ``group`` holds per-query sizes for the ranking
objectives, ``categorical_feature`` column indices or names) -> ``train``
or ``Booster(params, train_set)`` with ``add_valid``, ``update()`` /
``update(fobj=...)``, ``rollback_one_iter()``, ``eval_train`` /
``eval_valid`` / ``eval`` and ``reset_parameter`` -> ``Booster.predict(X)``
/ ``model_to_string()`` / ``save_model``, plus loading a model text
(``Booster(model_str=...)`` or ``model_file=``). Training, evaluation and
prediction run on ``device_type`` (default ``"cuda"``; ``"cpu"`` runs the
kernels' plain PyTorch versions). A model with k trees per iteration
(multiclass, multiclassova) predicts ``[n, k]``.

A scipy CSR/CSC matrix is taken as it is: ``Dataset`` bins it without
densifying (``BinnedDataset.from_sparse``: bundled at ingestion), a row
subset slices its rows, and ``Booster.predict`` densifies it in chunks
(``_HOST_SPARSE_CHUNK_ROWS`` rows on the float64 walk, 262,144 on the
device predictor), each routed on the device. As in the JAX package,
sparse input takes no categorical feature and no linear tree.

``Booster.predict`` at or above ``pred_device_min_work`` rows x trees
scores through the stacked-tree device predictor (``models/predictor.py``,
the ``predict_pass`` kernel) by the JAX package's rules; below it, the
float64 walk (:func:`host_walk_raw`). The serving plane (``serve/``)
shares :func:`host_walk_raw` and :func:`finalize_raw_predictions`.

The rest of the JAX package's ``Booster`` and ``Dataset`` API: ``predict``
with ``pred_leaf``, ``pred_early_stop`` and ``pred_contrib`` (TreeSHAP,
``io/shap.py``; all on the device), ``dump_model``, ``feature_importance``,
``feature_name``, ``num_feature``, ``refit``, ``reset_training_data`` and
``refit_by_leaf_preds``; ``Dataset.add_features_from``,
``get_feature_name``, ``save_binary``, and ``Dataset(path)`` on a binary
cache that either package wrote (``io/cache.py``).

Averaged-output models (RF, ``average_output``) evaluate and predict on
their summed scores divided by the iterations trained or used. With
``linear_tree`` a dense Dataset keeps its raw columns as float32 on its
device (``BinnedDataset.raw_data``), which the linear leaves fit on.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .boosting import create_boosting
from .boosting.gbdt import GBDT
from .binning import mappers_digest
from .config import Config, resolve_device
from .dataset import BinnedDataset
from .io import model_io
from .io.shap import predict_contrib
from .metric import create_metric, default_metric_for_objective
from .models.tree import HostTree
from .objective import create_objective, create_objective_from_string
from .ops.predict import predict_leaf, predict_raw, predict_raw_early_stop
from .utils.log import LightGBMError  # noqa: F401  (re-exported)

# rows of a sparse matrix densified at once by the float64 walk
_HOST_SPARSE_CHUNK_ROWS = 65_536


def _is_scipy_sparse(data) -> bool:
    try:
        import scipy.sparse as sp
    except ImportError:  # pragma: no cover
        return False
    return sp.issparse(data)


def _to_2d_numpy(data) -> np.ndarray:
    if hasattr(data, "values") and not isinstance(data, np.ndarray):
        data = data.values  # pandas
    arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    if arr.dtype == object:
        arr = arr.astype(np.float64)
    return arr


def _row_chunks(data, device):
    """(row slice, float64 rows on ``device``): the whole matrix, or a
    sparse matrix's rows ``_HOST_SPARSE_CHUNK_ROWS`` at a time."""
    if not _is_scipy_sparse(data):
        X = _to_2d_numpy(data).astype(np.float64)
        yield slice(0, X.shape[0]), torch.as_tensor(X, device=device)
        return
    csr = data.tocsr()
    for c0 in range(0, csr.shape[0], _HOST_SPARSE_CHUNK_ROWS):
        rows = slice(c0, c0 + _HOST_SPARSE_CHUNK_ROWS)
        yield rows, torch.as_tensor(
            csr[rows].toarray().astype(np.float64), device=device)


def host_walk_raw(models, X, lo: int, hi: int, k: int,
                  device) -> np.ndarray:
    """Exact float64 walk over trees [lo, hi) (``lo`` a multiple of ``k``)
    on ``device``: raw scores [k, n] (the JAX package's ``host_walk_raw``).
    The one implementation of the walk: ``Booster.predict`` below
    ``pred_device_min_work`` or on a model the stacked predictor cannot
    hold, and the serving engine's degraded path, with the same bounded
    per-chunk densify of sparse input."""
    n = X.shape[0]
    raw = np.zeros((k, n), np.float64)
    for rows, Xd in _row_chunks(X, device):
        raw[:, rows] = predict_raw(models[lo:hi], Xd, k).cpu().numpy()
    return raw


def finalize_raw_predictions(raw: np.ndarray, k: int, objective,
                             average_output: bool, num_iteration: int,
                             raw_score: bool) -> np.ndarray:
    """Raw [k, n] scores -> the user-facing prediction: RF averaging, the
    objective's output transform, the multiclass transpose. The one
    implementation of the output contract: ``Booster.predict`` and the
    serving engine both end here."""
    if average_output and num_iteration > 0:
        raw = raw / num_iteration
    if not raw_score and objective is not None:
        if k > 1:
            return objective.convert_output(raw.T)
        return np.asarray(objective.convert_output(raw[0]))
    return raw[0] if k == 1 else raw.T


class Dataset:
    """Training or validation dataset with lazy construction (ref:
    basic.py:1122). With ``reference`` (the training Dataset) the rows bin
    with the reference's mappers."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name="auto", categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params) if params else {}
        self._inner: Optional[BinnedDataset] = None
        self.used_indices: Optional[np.ndarray] = None

    def construct(self) -> "Dataset":
        if self._inner is not None:
            return self
        cfg = Config(self.params)
        cats, names = self._resolve_cats_names()
        ref_inner = (self.reference.construct()._inner
                     if self.reference is not None else None)
        # rows binned against a reference live on the reference's device
        device = (ref_inner.device if ref_inner is not None
                  else resolve_device(cfg.device_type))
        if isinstance(self.data, (str, os.PathLike)):
            self._inner = BinnedDataset.load_binary(str(self.data), device)
            self._apply_loaded(ref_inner)
            return self
        if _is_scipy_sparse(self.data):
            # CSR/CSC ingestion without densifying (lightgbm_tpu/basic.py:
            # 211-233)
            if cats:
                raise LightGBMError(
                    "categorical features are not supported for sparse "
                    "input yet; densify those columns")
            if bool(cfg.linear_tree):
                raise LightGBMError(
                    "linear_tree needs retained raw data and is not "
                    "supported for sparse input")
            inner = BinnedDataset.from_sparse(
                self.data, cfg, device, feature_names=names,
                reference=ref_inner)
        else:
            data = _to_2d_numpy(self.data)
            inner = BinnedDataset.from_data(
                data, cfg, device, feature_names=names,
                reference=ref_inner, categorical_feature=cats)
            if bool(cfg.linear_tree):
                # linear leaves fit on raw values (lightgbm_tpu/basic.py:
                # 236-239)
                inner.raw_data = torch.as_tensor(
                    np.asarray(data, np.float32), device=device)
        if self.label is not None:
            inner.metadata.set_label(np.asarray(self.label))
        if self.weight is not None:
            inner.metadata.set_weight(np.asarray(self.weight))
        if self.group is not None:
            inner.metadata.set_group(np.asarray(self.group))
        if self.init_score is not None:
            inner.metadata.set_init_score(np.asarray(self.init_score))
        self._inner = inner
        return self

    def _apply_loaded(self, ref_inner) -> None:
        """A binary cache's dataset (the JAX package's
        ``_apply_explicit_metadata``): a valid set's cache must hold its
        reference's mappers, and a reference-binned cache needs one; the
        cached binning parameters fill the ones not given; metadata given
        here overrides the cached."""
        inner = self._inner
        if ref_inner is not None:
            if mappers_digest(ref_inner.mappers) \
                    != mappers_digest(inner.mappers):
                raise LightGBMError(
                    "cached dataset was binned with different mappers "
                    "than its reference dataset; rebuild the cache from "
                    "text with reference= the training data")
        elif inner.reference_binned:
            raise LightGBMError(
                "this dataset cache was binned against a reference "
                "(validation) dataset; pass reference= the training "
                "data, or rebuild the cache from text standalone")
        for k, v in inner.dataset_params.items():
            self.params.setdefault(k, v)
        md = inner.metadata
        if self.label is not None:
            md.set_label(np.asarray(self.label))
        if self.weight is not None:
            md.set_weight(np.asarray(self.weight))
        if self.group is not None:
            md.set_group(np.asarray(self.group))
        if self.init_score is not None:
            md.set_init_score(np.asarray(self.init_score))

    def _resolve_cats_names(self):
        """(categorical column indices, feature names or None): names in
        ``categorical_feature`` resolve through ``feature_name`` or a
        pandas frame's columns (the JAX package's
        ``Dataset._resolve_cats_names``)."""
        names = None
        if self.feature_name not in ("auto", None):
            names = list(self.feature_name)
        elif hasattr(self.data, "columns"):
            names = [str(c) for c in self.data.columns]
        cats = []
        if self.categorical_feature not in ("auto", None):
            for c in self.categorical_feature:
                if isinstance(c, str):
                    if names and c in names:
                        cats.append(names.index(c))
                else:
                    cats.append(int(c))
        return cats, names

    # ------------------------------------------------------------------
    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._inner is not None and label is not None:
            self._inner.metadata.set_label(np.asarray(label))
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._inner is not None:
            self._inner.metadata.set_weight(
                None if weight is None else np.asarray(weight))
        return self

    def set_group(self, group) -> "Dataset":
        """Per-query sizes, in row order (ref: basic.py
        Dataset.set_group)."""
        self.group = group
        if self._inner is not None and group is not None:
            self._inner.metadata.set_group(np.asarray(group))
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._inner is not None:
            self._inner.metadata.set_init_score(
                None if init_score is None else np.asarray(init_score))
        return self

    def set_field(self, field_name: str, data) -> "Dataset":
        """(ref: basic.py Dataset.set_field)"""
        setter = {"label": self.set_label, "weight": self.set_weight,
                  "group": self.set_group,
                  "init_score": self.set_init_score}.get(field_name)
        if setter is None:
            raise ValueError(f"Unknown field name: {field_name}")
        return setter(data)

    def get_field(self, field_name: str):
        """``group`` returns the cumulative query boundaries [Q+1], as
        the JAX package's does (``get_group`` gives the sizes)."""
        md = self.construct()._inner.metadata
        if field_name == "group":
            return md.query_boundaries
        if field_name not in ("label", "weight", "init_score"):
            raise ValueError(f"Unknown field name: {field_name}")
        return getattr(md, field_name)

    def get_label(self):
        return self.get_field("label")

    def get_weight(self):
        return self.get_field("weight")

    def get_init_score(self):
        return self.get_field("init_score")

    def get_group(self):
        """Per-query sizes (ref: basic.py get_group diffs the
        boundaries)."""
        boundaries = self.get_field("group")
        return None if boundaries is None else np.diff(boundaries)

    def num_data(self) -> int:
        return self.construct()._inner.num_data

    def num_feature(self) -> int:
        return self.construct()._inner.num_total_features

    def get_feature_name(self) -> List[str]:
        return self.construct()._inner.feature_names

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """Append ``other``'s columns, mappers and constraints (ref:
        basic.py Dataset.add_features_from); both constructed, with the
        same rows."""
        self.construct()
        other.construct()
        self._inner.add_features_from(other._inner)
        return self

    def save_binary(self, filename: str) -> "Dataset":
        """Write the binned dataset as the JAX package's ``LGBMTPU2``
        binary cache (``io/cache.py``); ``Dataset(filename)`` loads it."""
        self.construct()._inner.save_binary(filename)
        return self

    def subset(self, used_indices, params=None) -> "Dataset":
        """Row subset sharing the bin mappers: the binned rows are sliced,
        not rebinned (ref: basic.py Dataset.subset)."""
        self.construct()
        sub = Dataset.__new__(Dataset)
        sub.used_indices = np.asarray(used_indices)
        if self.data is None:
            sub.data = None
        elif _is_scipy_sparse(self.data):
            sub.data = self.data.tocsr()[sub.used_indices]
        else:
            sub.data = _to_2d_numpy(self.data)[sub.used_indices]
        sub.label = sub.weight = sub.group = sub.init_score = None
        sub.reference = self
        sub.feature_name = self.feature_name
        sub.categorical_feature = self.categorical_feature
        sub.params = dict(self.params)
        if params:
            sub.params.update(params)
        sub._inner = self._inner.subset(sub.used_indices)
        return sub

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """A validation Dataset binned with this one's mappers (ref:
        basic.py Dataset.create_valid)."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params)


class Booster:
    """Training + prediction handle (ref: basic.py:2512)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params = dict(params) if params else {}
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._gbdt: Optional[GBDT] = None
        self.models: List[HostTree] = []
        self.objective = None
        self.config: Optional[Config] = None
        self.train_set: Optional[Dataset] = None
        self.valid_sets: List[Dataset] = []
        self.name_valid_sets: List[str] = []
        self.loaded_parameter = ""
        self.num_class = 1
        self.num_tree_per_iteration = 1
        self.max_feature_idx = 0
        self.feature_names: List[str] = []
        self.feature_infos: List[str] = []
        self.monotone_constraints = None
        self._objective_str = None
        self.label_index = 0
        self.average_output = False
        self.device = None
        # bumped on every change to the trees: a cached device predictor
        # of another version is stale
        self._model_version = 0
        self._device_predictor = None
        self._pred_min_work_cache = None
        if train_set is not None:
            self._init_train(train_set)
        elif model_file is not None:
            with open(model_file, "r") as fh:
                self._load_model_string(fh.read())
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
        # a dataset loaded from a binary cache brings the binning
        # parameters it was built with: they fill the ones not given
        restored = {k: v for k, v in inner.dataset_params.items()
                    if not self.config.was_set(k)}
        if restored:
            self.config.update(restored)
            train_set.params.update(restored)
        self.device = inner.device
        self.objective = create_objective(self.config)
        if self.objective is not None:
            if inner.metadata.label is None:
                raise ValueError("Label should not be None")
            self.objective.init(inner.metadata, inner.num_data, self.device)
        train_metrics = []
        if self.config.is_provide_training_metric:
            train_metrics = self._make_metrics(inner)
        self._gbdt = create_boosting(self.config)
        self._gbdt.init(self.config, inner, self.objective, train_metrics)
        self.models = self._gbdt.models
        self.num_class = max(1, int(self.config.num_class))
        self.num_tree_per_iteration = self._gbdt.num_tree_per_iteration
        self.average_output = getattr(self._gbdt, "average_output", False)
        self.max_feature_idx = inner.num_total_features - 1
        self.feature_names = inner.feature_names
        self.feature_infos = inner.feature_infos()
        if inner.monotone_constraints is not None:
            self.monotone_constraints = inner.monotone_constraints

    def _make_metrics(self, inner: BinnedDataset) -> List:
        """The configured metrics (the objective's own by default), bound
        to ``inner``'s labels and weights."""
        names = [str(m) for m in self.config.metric]
        if not names:
            default = default_metric_for_objective(self.config.objective)
            names = [default] if default else []
        metrics = []
        for name in names:
            m = create_metric(name, self.config)
            if m is not None:
                m.init(inner.metadata, inner.num_data)
                metrics.append(m)
        return metrics

    # ------------------------------------------------------------------
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Evaluate ``data`` (binned with the training set's mappers) after
        every iteration (ref: basic.py Booster.add_valid)."""
        if self._gbdt is None:
            raise LightGBMError("Booster was not trained with a train_set")
        if data.reference is not self.train_set:
            data.reference = self.train_set
        data.construct()
        self._gbdt.add_valid_data(data._inner, name,
                                  self._make_metrics(data._inner))
        self.valid_sets.append(data)
        self.name_valid_sets.append(name)
        return self

    def update(self, train_set: Optional[Dataset] = None, fobj=None) -> bool:
        """One boosting iteration; True when training stopped (ref:
        basic.py:2936 Booster.update). Without ``fobj`` it takes the
        epilogue body wherever it applies (binary or L2 with
        ``tpu_fused_epilogue``; see ``boosting/gbdt.py``); ``fobj(scores,
        train_set) -> (grad, hess)`` needs ``objective="none"`` and takes
        and returns ``k * n`` values, class-major."""
        if train_set is not None and train_set is not self.train_set:
            raise LightGBMError("Replacing train_set is not supported yet")
        self._model_version += 1
        if fobj is None:
            return self._gbdt.train_one_iter()
        if self.objective is not None:
            raise LightGBMError(
                "Cannot use custom objective when the booster was created "
                "with a built-in objective; set objective='none'")
        grad, hess = fobj(self._gbdt.scores.double().cpu().numpy()
                          .reshape(-1), self.train_set)
        return self._gbdt.train_one_iter(np.asarray(grad, np.float32),
                                         np.asarray(hess, np.float32))

    def rollback_one_iter(self) -> "Booster":
        """Remove the last iteration's tree and its training- and
        valid-score contributions."""
        self._gbdt.rollback_one_iter()
        self._model_version += 1
        return self

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """(ref: basic.py Booster.reset_parameter -> gbdt.cpp ResetConfig)"""
        self.params.update(params)
        self._pred_min_work_cache = None
        if self._gbdt is not None:
            self.config.update(params)
            self._gbdt.reset_config(self.config)
        return self

    def current_iteration(self) -> int:
        return (self._gbdt.iter if self._gbdt is not None
                else len(self.models) // max(1, self.num_tree_per_iteration))

    def num_trees(self) -> int:
        return len(self.models)

    def num_model_per_iteration(self) -> int:
        return self.num_tree_per_iteration

    def train_scores(self) -> torch.Tensor:
        """The trainer's accumulated raw scores (float32, device): [n], or
        [k, n] with k trees per iteration."""
        s = self._gbdt.scores
        return s[0] if s.shape[0] == 1 else s

    def valid_scores(self, i: int = 0) -> torch.Tensor:
        """Valid set ``i``'s accumulated raw scores (float32, device): [n],
        or [k, n] with k trees per iteration."""
        s = self._gbdt.valid_scores[i]
        return s[0] if s.shape[0] == 1 else s

    # ------------------------------------------------------------------
    def eval_train(self, feval=None) -> List:
        """[(name, metric, value, is_higher_better)] on the training set."""
        return self._eval_set("training", None, feval)

    def eval_valid(self, feval=None) -> List:
        out = []
        for i, name in enumerate(self.name_valid_sets):
            out.extend(self._eval_set(name, i, feval))
        return out

    def eval(self, data: Dataset, name: str, feval=None) -> List:
        if data is self.train_set:
            return self.eval_train(feval)
        for i, vs in enumerate(self.valid_sets):
            if vs is data:
                return self._eval_set(self.name_valid_sets[i], i, feval)
        raise LightGBMError("Data should be added with add_valid first")

    def _eval_set(self, name: str, valid_idx: Optional[int], feval) -> List:
        """The metrics' device forms on the live device scores, host forms
        and ``feval`` on one float64 host copy, and one batched fetch of
        every device scalar at the end. An averaged-output model's scores
        are divided by the iterations trained first."""
        g = self._gbdt
        if valid_idx is None:
            # under a rank layout the metrics hold the global rows
            score_dev = (g.train_scores_global() if g.mp is not None
                         else g.scores)
            metrics, dataset = g.training_metrics, self.train_set
        else:
            score_dev = g.valid_scores[valid_idx]
            metrics = g.valid_metrics[valid_idx]
            dataset = self.valid_sets[valid_idx]
        if self.average_output:
            score_dev = score_dev / max(
                1, len(g.models) // g.num_tree_per_iteration)
        out = g.eval_metric_set(name, metrics, score_dev)
        if feval is not None:
            host_score = score_dev.double().cpu().numpy().reshape(-1)
            for f in (feval if isinstance(feval, list) else [feval]):
                ret = f(host_score, dataset)
                for mn, v, hb in (ret if isinstance(ret, list) else [ret]):
                    out.append((name, mn, v, hb))
        dev = [v for (_, _, v, _) in out if isinstance(v, torch.Tensor)]
        fetched = iter(torch.stack(dev).cpu().tolist() if dev else [])
        return [(d, n, next(fetched) if isinstance(v, torch.Tensor)
                 else float(v), b) for (d, n, v, b) in out]

    # ------------------------------------------------------------------
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False,
                pred_early_stop: bool = False,
                pred_early_stop_freq: int = 10,
                pred_early_stop_margin: float = 10.0,
                **kwargs) -> np.ndarray:
        """Predictions on raw features (ref: basic.py:3449
        Booster.predict). ``num_iteration=None`` means the early-stopped
        best iteration where there is one, an explicit value <= 0 every
        iteration. [n], or [n, k] with k trees per iteration (the
        objective's softmax or per-class sigmoid applied unless
        ``raw_score``).

        At or above ``pred_device_min_work`` rows x trees the model is
        packed once into stacked tensors on the device
        (``models/predictor.py``, cached until the trees change) and
        scored in one ``predict_pass`` launch per chunk, in float32:
        routed on the training bins when a training set is attached, else
        on raw values in float32, which only float32 input or a
        user-set ``pred_device_min_work`` engages. Below it, or for a
        model the stack cannot hold (linear trees, ...), the exact
        float64 walk on the device (:func:`host_walk_raw`).

        ``pred_leaf``: the int32 [n, trees] leaf of every row in every
        tree. ``pred_early_stop``: a row stops taking trees once its
        margin passes ``pred_early_stop_margin`` at a check every
        ``pred_early_stop_freq`` iterations
        (``ops.predict.predict_raw_early_stop``; not for averaged-output
        models). ``pred_contrib``: the [n, k * (F + 1)] TreeSHAP
        contributions, the expected value in column F of each class block
        (``io.shap.predict_contrib``). These three walk in float64. An
        averaged-output model divides the raw scores by the iterations
        used. A scipy sparse matrix is densified in chunks."""
        k = self.num_tree_per_iteration
        # float32 sources are exactly representable in the raw-value
        # device predictor's compares; remember before the float64 cast
        f32_input = getattr(data, "dtype", None) == np.float32
        if num_iteration is None:
            num_iteration = (self.best_iteration
                             if self.best_iteration > 0 else -1)
        total = len(self.models) // k
        if num_iteration <= 0:
            num_iteration = total - start_iteration
        num_iteration = min(num_iteration, total - start_iteration)
        lo = start_iteration * k
        hi = (start_iteration + num_iteration) * k
        models = self.models[lo:hi]
        dev = self._predict_device()
        sparse = _is_scipy_sparse(data)
        X = data.tocsr() if sparse else _to_2d_numpy(data).astype(np.float64)
        n = X.shape[0]
        if pred_leaf:
            out = np.zeros((n, len(models)), np.int32)
            for rows, Xd in _row_chunks(X, dev):
                out[rows] = predict_leaf(models, Xd).cpu().numpy()
            return out
        if pred_contrib:
            out = np.zeros((n, k * (self.max_feature_idx + 2)), np.float64)
            for rows, Xd in _row_chunks(X, dev):
                out[rows] = predict_contrib(
                    models, Xd, k, self.max_feature_idx + 1).cpu().numpy()
            return out
        if pred_early_stop and not self.average_output:
            raw = np.zeros((k, n), np.float64)
            for rows, Xd in _row_chunks(X, dev):
                raw[:, rows] = predict_raw_early_stop(
                    models, Xd, k, int(pred_early_stop_freq),
                    float(pred_early_stop_margin))[0].cpu().numpy()
        else:
            raw = self._predict_raw(X, lo, hi, f32_input)
        return finalize_raw_predictions(raw, k, self.objective,
                                        self.average_output, num_iteration,
                                        raw_score)

    def _pred_device_min_work(self) -> int:
        """The resolved ``pred_device_min_work`` (rows x trees at or above
        which predict takes the device predictor): the training config's
        where there is one, else the booster params' (model files)."""
        if self.config is not None:
            return int(self.config.pred_device_min_work)
        if self._pred_min_work_cache is None:
            # resolve the one key by hand: a full Config would re-run its
            # side effects (the global log level) on every first predict
            cached = 2_000_000
            for key, value in self.params.items():
                if Config.resolve_key(str(key)) == "pred_device_min_work" \
                        and value is not None:
                    cached = int(float(value))
            self._pred_min_work_cache = cached
        return self._pred_min_work_cache

    def _pred_min_work_user_set(self) -> bool:
        """Did the user set ``pred_device_min_work``? That is the opt-in
        that lets float64 input take the float32 raw-routing device
        path."""
        if self.config is not None:
            return self.config.was_set("pred_device_min_work")
        return any(Config.resolve_key(str(key)) == "pred_device_min_work"
                   for key in self.params)

    def _predict_raw(self, X, lo: int, hi: int,
                     f32_input: bool = False) -> np.ndarray:
        """Raw scores [k, n] float64 (the JAX package's ``_predict_raw``):
        the device predictor at or above ``pred_device_min_work`` rows x
        trees (binned routing with a training set; raw routing only for
        float32 input or a user-set threshold), else the float64 walk."""
        n = X.shape[0]
        k = self.num_tree_per_iteration
        dev = self._predict_device()
        if n * max(hi - lo, 1) >= self._pred_device_min_work():
            has_train = (self.train_set is not None
                         and self.train_set._inner is not None)
            if not has_train and not f32_input \
                    and not self._pred_min_work_user_set():
                return host_walk_raw(self.models, X, lo, hi, k, dev)
            pred = self._device_predictor
            if pred is None or pred.model_version != self._model_version:
                from .models.predictor import (DevicePredictor,
                                               RawDevicePredictor)
                if has_train:
                    pred = DevicePredictor(self.models,
                                           self.train_set._inner, k)
                else:
                    pred = RawDevicePredictor(self.models,
                                              self.max_feature_idx + 1, k,
                                              device=dev)
                # failed packs are cached too: the decision is per model
                # state, and a rescan per call would tax repeated predicts
                pred.model_version = self._model_version
                self._device_predictor = pred
            if pred.ok:
                return pred.predict_raw(X, lo, hi)
        return host_walk_raw(self.models, X, lo, hi, k, dev)

    def _predict_device(self):
        if self.device is None:
            self.device = resolve_device(
                Config(self.params).device_type)
        return self.device

    # ------------------------------------------------------------------
    def model_to_string(self, start_iteration: int = 0,
                        num_iteration: Optional[int] = None) -> str:
        """The model text; ``num_iteration=None`` keeps the early-stopped
        best iteration where there is one, <= 0 every iteration."""
        if num_iteration is None:
            num_iteration = (self.best_iteration
                             if self.best_iteration > 0 else -1)
        return model_io.save_model_to_string(self, start_iteration,
                                             num_iteration)

    def save_model(self, filename: str, start_iteration: int = 0,
                   num_iteration: Optional[int] = None) -> "Booster":
        """Write ``model_to_string`` to ``filename`` through a temporary
        file and a rename, so a crash never leaves a truncated model."""
        text = self.model_to_string(start_iteration, num_iteration)
        tmp = f"{filename}.tmp{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(text)
        os.replace(tmp, filename)
        return self

    def dump_model(self, start_iteration: int = 0,
                   num_iteration: Optional[int] = None) -> dict:
        """The model as a dict (the JAX package's ``dump_model``; ref:
        gbdt_model_text.cpp DumpModel)."""
        if num_iteration is None:
            num_iteration = (self.best_iteration
                             if self.best_iteration > 0 else -1)
        return json.loads(model_io.dump_model_json(self, start_iteration,
                                                   num_iteration))

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        """[num_feature] split counts (``split``) or total gains
        (``gain``) of the first ``iteration`` iterations' trees (all by
        default)."""
        models = self.models
        if iteration is not None and iteration > 0:
            models = models[:iteration * self.num_tree_per_iteration]
        return model_io.feature_importance(
            models, self.max_feature_idx + 1,
            0 if importance_type == "split" else 1)

    def feature_name(self) -> List[str]:
        return self.feature_names

    def num_feature(self) -> int:
        return self.max_feature_idx + 1

    def __copy__(self):
        return self.__deepcopy__(None)

    def __deepcopy__(self, memo):
        booster = Booster(model_str=self.model_to_string(num_iteration=-1))
        booster.params = dict(self.params)
        return booster

    def set_network(self, machines: str, local_listen_port: int = 12400,
                    listen_time_out: int = 120,
                    num_machines: int = 1) -> "Booster":
        """Multi-host setup shim (ref: basic.py:2687 Booster.set_network):
        the reference's machine-list parameters onto
        ``torch.distributed.init_process_group`` — see
        ``parallel/distributed.py``."""
        from .parallel import distributed
        distributed.set_network(machines, local_listen_port, num_machines,
                                listen_time_out)
        return self

    def free_network(self) -> "Booster":
        """(ref: basic.py:2721) Destroy the process group."""
        from .parallel import distributed
        distributed.free_network()
        return self

    def refit(self, data, label, decay_rate: float = 0.9, **kwargs):
        """A copy whose leaf values are refitted on ``data`` (ref:
        basic.py:3506 Booster.refit; the JAX package's ``refit``): tree by
        tree, every leaf's value becomes ``decay_rate * old + (1 -
        decay_rate) * -sum_g / (sum_h + lambda_l2) * shrinkage`` from the
        objective's gradients at the float64 scores of the trees before it
        (taken in f32), and the refitted tree's outputs join the scores.
        Leaves are routed on the device."""
        import copy
        new = copy.deepcopy(self)
        X = torch.as_tensor(_to_2d_numpy(data).astype(np.float64),
                            device=new._predict_device())
        label = np.asarray(label, np.float64).reshape(-1)
        lambda_l2 = float(Config(self.params).lambda_l2)
        obj = new.objective
        k = self.num_tree_per_iteration
        n = X.shape[0]
        if obj is not None:
            from .dataset import Metadata
            md = Metadata(n)
            md.set_label(label)
            obj.init(md, n, X.device)
        scores = torch.zeros((k, n), dtype=torch.float64, device=X.device)
        for i, t in enumerate(new.models):
            tid = i % k
            leaves = predict_leaf([t], X)[:, 0].long()
            if obj is not None:
                g, h = obj.get_gradients(scores.to(torch.float32))
                g, h = g[tid].double(), h[tid].double()
            else:
                g = scores[tid] - torch.as_tensor(label, device=X.device)
                h = torch.ones_like(g)
            L = t.num_leaves
            z = torch.zeros(L, dtype=torch.float64, device=X.device)
            sum_g = z.index_add(0, leaves, g).cpu().numpy()
            sum_h = z.index_add(0, leaves, h).cpu().numpy()
            hit = np.bincount(leaves.cpu().numpy(), minlength=L) > 0
            new_out = np.where(sum_h > 0, -sum_g / np.where(
                sum_h > 0, sum_h + lambda_l2, 1.0) * t.shrinkage, 0.0)
            t.leaf_value[:L] = np.where(
                hit, decay_rate * t.leaf_value[:L]
                + (1.0 - decay_rate) * new_out, t.leaf_value[:L])
            scores[tid] += torch.as_tensor(
                t.leaf_value, dtype=torch.float64, device=X.device)[leaves]
        new._model_version += 1
        return new

    def reset_training_data(self, train_set: "Dataset") -> "Booster":
        """Attach (or replace) the training data of a model (ref:
        c_api.cpp:1631 LGBM_BoosterResetTrainingData, gbdt.cpp:686; the
        JAX package's ``reset_training_data``): trees loaded or adopted
        before become the init segment, whose scores are not replayed;
        trees this booster trained stay trainable and their scores are
        replayed on the new data through the bin router. The new data
        must share the old one's bin mappers."""
        old_g = self._gbdt
        post = []
        init_models = list(self.models)
        if old_g is not None:
            k = old_g.num_tree_per_iteration
            n_init = old_g.num_init_iteration * k
            init_models = init_models[:n_init]
            post = old_g.models[n_init:]
            train_set.construct()
            if self.train_set is not None \
                    and train_set is not self.train_set \
                    and train_set._inner.feature_infos() \
                    != self.train_set._inner.feature_infos():
                raise ValueError(
                    "Cannot reset training data, since new training data "
                    "has different bin mappers")
        # a loaded model carries its objective in the header: restore its
        # name and sub-parameters ("binary sigmoid:2")
        if "objective" not in self.params and self._objective_str:
            toks = self._objective_str.split()
            self.params["objective"] = toks[0]
            for tok in toks[1:]:
                if ":" in tok:
                    key, v = tok.split(":", 1)
                    self.params.setdefault(key, v)
        if self.num_class > 1:
            self.params.setdefault("num_class", self.num_class)
        self._init_train(train_set)
        g = self._gbdt
        if init_models:
            g.adopt_init_models(init_models)
        k = g.num_tree_per_iteration
        bundle = g._bundle_of(g.train_data)
        for idx, ht in enumerate(post):
            g.models.append(ht)
            g.scores[idx % k] = g._add_host_tree(
                g.scores[idx % k], g.train_data.bins_dev, ht, bundle=bundle)
        g.iter = len(post) // k
        self.models = g.models
        self._model_version += 1
        return self

    def refit_by_leaf_preds(self, leaf_preds: np.ndarray) -> "Booster":
        """Refit every leaf value in place from a leaf-assignment matrix
        [num_data, num_trees] (ref: c_api.cpp:1665 LGBM_BoosterRefit,
        gbdt.cpp:287 RefitTree); needs training data
        (``reset_training_data``)."""
        if self._gbdt is None:
            raise ValueError(
                "BoosterRefit needs training data; call "
                "reset_training_data()/LGBM_BoosterResetTrainingData first")
        self._gbdt.refit_by_leaf_preds(np.asarray(leaf_preds, np.int32)
                                       .reshape(self._gbdt.num_data, -1))
        self._model_version += 1
        return self

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
        self._objective_str = header.get("objective", "none")
        self.objective = create_objective_from_string(self._objective_str)
