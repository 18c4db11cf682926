"""Training entry points: ``train`` and ``cv`` (PyTorch counterpart of
``lightgbm_tpu/engine.py``; ref: python-package/lightgbm/engine.py train
:25, cv :399, CVBooster :285, _make_n_folds :323).

``train`` runs the boosting loop on the device the params name
(``device_type``, default ``"cuda"``) with valid sets, ``fobj``, ``feval``,
``init_model``, callbacks, early stopping (the callback or the
``early_stopping_round`` parameter) and ``snapshot_freq``.

Which iteration body runs (``boosting/gbdt.py``) is decided as the JAX
package's ``engine.train`` decides it, so both packages grow the same
trees through the same kernels for each call: the megastep body when
there is no callback, ``feval``, ``fobj`` or snapshot, or when every
callback is one the JAX package's megastep replays (``log_evaluation``,
``record_evaluation``, one ``early_stopping`` with no ``min_delta``), no
``feval`` or ``fobj``, and every metric has a device form
(``GBDT.megastep_eval_precheck``); otherwise the body a bare
``Booster.update()`` takes, the epilogue body wherever it applies.
``tpu_megastep=False`` never arms the megastep. Metrics evaluate inline
after every iteration on either body.

``categorical_feature`` (column indices or names) is set on the training
Dataset, as the JAX package's ``train`` sets it. ``cv`` folds a Dataset
with query groups by whole queries (``folds.split(groups=...)`` gets each
row's query id).

``resume_from`` (or the ``resume`` key) restores a run from a resilience
checkpoint (a ``ckpt_<iteration>`` directory, or a ``checkpoint_dir``
root, whose newest complete checkpoint is taken) after the valid sets are
added, with the callbacks' states, and continues it to the model the
uninterrupted run gives, byte for byte (``resilience/state.py``); pass the
same parameters, dataset, valid sets and callbacks. With
``checkpoint_dir`` and ``checkpoint_period`` every settled iteration is a
cadence point (``GBDT.maybe_checkpoint``), and ``train`` joins the writer
before it returns.
"""
from __future__ import annotations

import collections
import os
from typing import Any, Dict, List, Optional, Union

import numpy as np

from . import callback as callback_mod
from .basic import Booster, Dataset
from .config import Config
from .utils import log

__all__ = ["train", "cv", "CVBooster"]

_ROUND_ALIASES = ("num_iterations", "num_iteration", "n_iter", "num_tree",
                  "num_trees", "num_round", "num_rounds", "nrounds",
                  "num_boost_round", "n_estimators", "max_iter")
_ES_ALIASES = ("early_stopping_round", "early_stopping_rounds",
               "early_stopping", "n_iter_no_change")


def _predictor(init_model, device_type: str) -> Optional[Booster]:
    """The model whose raw predictions become the init scores: a model
    file's path, or a Booster of this package (every tree, the ones after
    an early stop included). A model that the JAX package or LightGBM
    wrote loads the same way, or through ``convert``."""
    params = {"device_type": device_type}
    if isinstance(init_model, (str, os.PathLike)):
        return Booster(params=params, model_file=str(init_model))
    if isinstance(init_model, Booster):
        return Booster(params=params, model_str=init_model.model_to_string(
            num_iteration=-1))
    if init_model is not None:
        raise TypeError("init_model should be a model file path or a "
                        "Booster")
    return None


def _set_init_score(predictor: Optional[Booster], ds: Dataset) -> None:
    if predictor is not None and ds.init_score is None:
        raw = predictor.predict(ds.data, raw_score=True)
        ds.set_init_score(np.asarray(raw).reshape(-1, order="F"))


def _split_callbacks(callbacks):
    before = [cb for cb in callbacks
              if getattr(cb, "before_iteration", False)]
    after = [cb for cb in callbacks
             if not getattr(cb, "before_iteration", False)]
    before.sort(key=lambda cb: getattr(cb, "order", 0))
    after.sort(key=lambda cb: getattr(cb, "order", 0))
    return before, after


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          fobj=None, feval=None,
          init_model: Optional[Union[str, Booster]] = None,
          feature_name="auto", categorical_feature="auto",
          keep_training_booster: bool = False,
          callbacks: Optional[List] = None,
          resume_from: Optional[str] = None) -> Booster:
    """Train a booster (ref: engine.py:25); ``resume_from`` continues a
    checkpointed run (the module docstring)."""
    params = dict(params) if params else {}
    # both keys popped: a resume path left in params would be echoed into
    # the model text and part it from the uninterrupted run's
    p_resume = params.pop("resume", "") or params.pop("resume_from", "")
    params.pop("resume_from", None)
    if resume_from and p_resume and str(p_resume) != str(resume_from):
        log.warning("resume_from=%s overrides params resume=%s",
                    resume_from, p_resume)
    resume_from = resume_from or p_resume or None
    for key in ("resume", "resume_from"):
        train_set.params.pop(key, None)
    if resume_from and init_model is not None:
        log.warning("resume_from and init_model both given; resume wins "
                    "(the checkpoint already contains the full model)")
        init_model = None
    # round-count aliases in params win, as in the JAX package
    for alias in _ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
    params["num_iterations"] = num_boost_round
    snapshot_freq = int(params.get("snapshot_freq",
                                   params.get("save_period", -1) or -1))
    snapshot_base = str(params.get("output_model", "LightGBM_model.txt"))
    first_metric_only = bool(params.get("first_metric_only", False))
    early_stopping_round = None
    for alias in _ES_ALIASES:
        if alias in params:
            early_stopping_round = int(params[alias])
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature

    # continued training: the init model's raw predictions are init scores
    device_type = Config(dict(train_set.params, **params)).device_type
    predictor = _predictor(init_model, device_type)
    _set_init_score(predictor, train_set)

    if valid_sets is not None and not isinstance(valid_sets, list):
        valid_sets = [valid_sets]
    train_in_valid = valid_sets is not None and any(
        vs is train_set for vs in valid_sets)
    if train_in_valid:
        params.setdefault("is_provide_training_metric", True)

    booster = Booster(params=params, train_set=train_set)
    for i, vs in enumerate(valid_sets or []):
        if vs is train_set:
            continue
        name = (valid_names[i] if valid_names is not None
                and i < len(valid_names) else f"valid_{i}")
        _set_init_score(predictor, vs)
        booster.add_valid(vs, name)

    callbacks = list(callbacks) if callbacks else []
    if early_stopping_round is not None and early_stopping_round > 0:
        callbacks.append(callback_mod.early_stopping(
            early_stopping_round, first_metric_only, verbose=True))
    callbacks_before, callbacks_after = _split_callbacks(callbacks)

    # the body: the megastep where the JAX package's engine arms it (with
    # or without its drain-replay consumer), else a bare update()'s
    gbdt = booster._gbdt
    custom = feval is not None or fobj is not None
    if callbacks or snapshot_freq > 0:
        blocker = ("feval" if feval is not None else
                   "fobj" if fobj is not None else
                   callback_mod.drain_replay_blocker(callbacks))
        if blocker is None:
            _, blocker = gbdt.megastep_eval_precheck(train_in_valid)
        armed = blocker is None
        if not armed:
            log.debug("the megastep body is not armed: %s", blocker)
    else:
        armed = not custom
    gbdt.arm_megastep(armed and bool(booster.config.tpu_megastep))

    evaluation_result_list: List = []
    start_iteration = 0
    if resume_from:
        # after the valid sets were added: their scores are restored too
        from .resilience import state as rstate
        payload = rstate.restore_into_booster(booster, str(resume_from))
        start_iteration = gbdt.iter
        evaluation_result_list = rstate.eval_list_from_payload(payload)
        rstate.restore_callback_states(
            callbacks_before + callbacks_after,
            (payload.get("engine_extra") or {}).get("callbacks") or [],
            callback_mod.CallbackEnv(
                model=booster, params=params,
                iteration=max(0, start_iteration - 1), begin_iteration=0,
                end_iteration=num_boost_round,
                evaluation_result_list=list(evaluation_result_list)))

    def ckpt_extra():
        # the callbacks' states and the last evaluation list ride every
        # checkpoint, for the restore above
        from .resilience import state as rstate
        return {"callbacks": rstate.callback_states(
                    callbacks_before + callbacks_after),
                "eval_list": [list(t) for t in evaluation_result_list]}
    try:
        for i in range(start_iteration, num_boost_round):
            for cb in callbacks_before:
                cb(callback_mod.CallbackEnv(
                    model=booster, params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=None))
            finished = booster.update(fobj=fobj)
            if snapshot_freq > 0 and (i + 1) % snapshot_freq == 0:
                # periodic snapshot of the full model (ref: gbdt.cpp:279)
                booster.save_model(f"{snapshot_base}.snapshot_iter_{i + 1}",
                                   num_iteration=-1)
            evaluation_result_list = []
            if valid_sets is not None or feval is not None:
                if train_in_valid or (feval is not None
                                      and gbdt.training_metrics):
                    evaluation_result_list.extend(booster.eval_train(feval))
                evaluation_result_list.extend(booster.eval_valid(feval))
            try:
                for cb in callbacks_after:
                    cb(callback_mod.CallbackEnv(
                        model=booster, params=params, iteration=i,
                        begin_iteration=0, end_iteration=num_boost_round,
                        evaluation_result_list=evaluation_result_list))
            except callback_mod.EarlyStopException as es:
                booster.best_iteration = es.best_iteration + 1
                evaluation_result_list = es.best_score
                break
            # the iteration has settled (update, snapshot, eval,
            # callbacks): the checkpoint's callback states match its model
            gbdt.maybe_checkpoint(ckpt_extra)
            if finished:
                break
    finally:
        # a kept booster returns to one body per bare update()
        gbdt.arm_megastep(False)
        gbdt.wait_checkpoints()

    booster.best_score = collections.defaultdict(collections.OrderedDict)
    for name, metric, value, _ in (evaluation_result_list or []):
        booster.best_score[name][metric] = value
    return booster


class CVBooster:
    """The boosters of the folds (ref: engine.py:285); any other attribute
    is a method called on every fold's booster."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def _append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler_function(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler_function


def _make_n_folds(full_data: Dataset, folds, nfold: int, params: Dict,
                  seed: int, stratified: bool, shuffle: bool):
    """(train_idx, test_idx) per fold (ref: engine.py:323): a splitter
    gets each row's query id as ``groups``; without ``folds``, a Dataset
    with query groups folds by whole queries
    (lightgbm_tpu/engine.py:339-380)."""
    full_data = full_data.construct()
    num_data = full_data.num_data()
    if folds is not None:
        if not hasattr(folds, "__iter__") and not hasattr(folds, "split"):
            raise AttributeError(
                "folds should be a generator or iterator of (train_idx, "
                "test_idx) tuples or scikit-learn splitter object")
        if hasattr(folds, "split"):
            group_info = full_data.get_field("group")
            flattened = (None if group_info is None else np.repeat(
                np.arange(len(group_info) - 1), np.diff(group_info)))
            folds = folds.split(X=np.empty(num_data),
                                y=full_data.get_label(), groups=flattened)
        return list(folds)
    rng = np.random.RandomState(seed)
    if stratified:
        label = np.asarray(full_data.get_label())
        test_folds = np.zeros(num_data, np.int32)
        for c in np.unique(label):
            idx = np.nonzero(label == c)[0]
            if shuffle:
                rng.shuffle(idx)
            test_folds[idx] = np.arange(len(idx)) % nfold
        return [(np.nonzero(test_folds != f)[0],
                 np.nonzero(test_folds == f)[0]) for f in range(nfold)]
    group_info = full_data.get_field("group")
    if group_info is not None:
        # whole queries per fold (ref: engine.py group-aware kfold)
        gidx = np.arange(len(group_info) - 1)
        if shuffle:
            rng.shuffle(gidx)
        bounds = np.asarray(group_info)
        out = []
        for split in np.array_split(gidx, nfold):
            test_mask = np.zeros(num_data, bool)
            for g in split:
                test_mask[bounds[g]:bounds[g + 1]] = True
            out.append((np.nonzero(~test_mask)[0], np.nonzero(test_mask)[0]))
        return out
    idx = np.arange(num_data)
    if shuffle:
        rng.shuffle(idx)
    splits = np.array_split(idx, nfold)
    return [(np.concatenate([splits[j] for j in range(nfold) if j != f]),
             splits[f]) for f in range(nfold)]


def cv(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True, metrics=None, feval=None, init_model=None,
       feature_name="auto", categorical_feature="auto",
       fpreproc=None, seed: int = 0, callbacks=None,
       eval_train_metric: bool = False,
       return_cvbooster: bool = False) -> Dict[str, List[float]]:
    """Cross-validation (ref: engine.py:399): one booster per fold on row
    subsets that share the training set's bins, each ``update()``d once
    per round; the result holds each metric's mean and standard deviation
    over the folds per round. Query groups fold by whole queries;
    categorical features come from ``train_set``'s own
    ``categorical_feature`` (the argument is not read, as in the JAX
    package's ``cv``). As there, ``resume`` is not read (every fold
    trains from the start) and ``checkpoint_dir`` makes its directory but
    writes no checkpoint (only ``train`` has a cadence point)."""
    params = dict(params) if params else {}
    if init_model is not None:
        log.warning("cv ignores init_model, as the JAX package's cv does")
    for alias in _ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
    if metrics is not None:
        params["metric"] = metrics
    obj = str(params.get("objective", "regression"))
    if stratified and not obj.startswith(("binary", "multiclass")):
        stratified = False
    if feature_name != "auto":
        train_set.feature_name = feature_name

    # the folds share train_set's bins, binned with its own parameters as
    # the JAX package's cv bins them; only where they lie comes from the
    # cv parameters when train_set names no device
    if not Config(train_set.params).was_set("device_type"):
        train_set.params = dict(train_set.params,
                                device_type=Config(params).device_type)
    train_set.construct()
    fold_splits = _make_n_folds(train_set, folds, nfold, params, seed,
                                stratified, shuffle)
    cvbooster = CVBooster()
    for train_idx, test_idx in fold_splits:
        tr = train_set.subset(train_idx)
        te = train_set.subset(test_idx)
        if fpreproc is not None:
            tr, te, params = fpreproc(tr, te, dict(params))
        booster = Booster(params=dict(params), train_set=tr)
        booster.add_valid(te, "valid")
        if eval_train_metric:
            booster._gbdt.training_metrics = booster._make_metrics(tr._inner)
        cvbooster._append(booster)

    callbacks = list(callbacks) if callbacks else []
    es_round = None
    for alias in _ES_ALIASES:
        if alias in params:
            es_round = int(params[alias])
    if es_round is not None and es_round > 0:
        callbacks.append(callback_mod.early_stopping(
            es_round, bool(params.get("first_metric_only", False)),
            verbose=False))
    callbacks_before, callbacks_after = _split_callbacks(callbacks)

    results = collections.defaultdict(list)
    for i in range(num_boost_round):
        for cb in callbacks_before:
            cb(callback_mod.CallbackEnv(
                model=cvbooster, params=params, iteration=i,
                begin_iteration=0, end_iteration=num_boost_round,
                evaluation_result_list=None))
        agg: Dict[str, List[float]] = collections.defaultdict(list)
        bigger: Dict[str, bool] = {}
        for booster in cvbooster.boosters:
            booster.update()
            for name, metric, value, hb in (booster.eval_train(feval)
                                            if eval_train_metric else []) \
                    + booster.eval_valid(feval):
                agg[f"{name} {metric}"].append(value)
                bigger[f"{name} {metric}"] = hb
        res_list = []
        for key, vals in agg.items():
            mean, std = float(np.mean(vals)), float(np.std(vals))
            results[key + "-mean"].append(mean)
            results[key + "-stdv"].append(std)
            res_list.append(("cv_agg", key, mean, bigger[key]))
        try:
            for cb in callbacks_after:
                cb(callback_mod.CallbackEnv(
                    model=cvbooster, params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=res_list))
        except callback_mod.EarlyStopException as es:
            cvbooster.best_iteration = es.best_iteration + 1
            for key in list(results):
                results[key] = results[key][:cvbooster.best_iteration]
            break
    out = dict(results)
    if return_cvbooster:
        out["cvbooster"] = cvbooster
    return out
