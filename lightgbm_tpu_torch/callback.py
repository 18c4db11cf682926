"""Training callbacks.

PyTorch counterpart of ``lightgbm_tpu/callback.py`` (ref:
python-package/lightgbm/callback.py: log_evaluation :65, record_evaluation
:96, reset_parameter :147, early_stopping :187).

``engine.train`` picks the iteration body from the callbacks, as the JAX
package's does: a callback its megastep could replay after the fact is
marked ``_megastep_replay`` (``log_evaluation``, ``record_evaluation``,
``early_stopping``), and :func:`drain_replay_blocker` names the first one
that is not. The JAX package's megastep is one ``lax.scan`` over
iterations, so it evaluates the metrics inside the scan and replays these
callbacks when it drains; the port's megastep is a Python loop over
iterations and runs them inline after each one, on the same values.
``record_evaluation`` and ``early_stopping`` keep their state across a
checkpoint and resume (``_cb_state``/``_cb_restore``, the JAX package's
JSON state).
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Union

from .utils import log


class EarlyStopException(Exception):
    """(ref: callback.py:14)"""

    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def log_evaluation(period: int = 1, show_stdv: bool = True):
    """(ref: callback.py:65)"""
    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            result = "\t".join(
                f"{name}'s {metric}: {value:g}"
                for name, metric, value, _ in env.evaluation_result_list)
            log.info("[%d]\t%s", env.iteration + 1, result)
    _callback.order = 10
    _callback._megastep_replay = "log_evaluation"
    return _callback


def record_evaluation(eval_result: Dict[str, Dict[str, List[float]]]):
    """(ref: callback.py:96)"""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")

    def _init(env: CallbackEnv) -> None:
        eval_result.clear()
        for name, metric, _, _ in env.evaluation_result_list:
            eval_result.setdefault(name, collections.OrderedDict()) \
                .setdefault(metric, [])

    def _callback(env: CallbackEnv) -> None:
        if not eval_result:
            _init(env)
        for name, metric, value, _ in env.evaluation_result_list:
            eval_result[name][metric].append(value)
    _callback.order = 20
    _callback._megastep_replay = "record_evaluation"

    # checkpoint and resume (resilience/state.py): the recorded curve
    # continues across a resume instead of restarting there
    def _cb_state():
        return {name: {m: [float(v) for v in vals]
                       for m, vals in metrics.items()}
                for name, metrics in eval_result.items()}

    def _cb_restore(st, env) -> None:
        eval_result.clear()
        for name, metrics in (st or {}).items():
            eval_result[name] = collections.OrderedDict(
                (m, list(vals)) for m, vals in metrics.items())
    _callback._cb_state = _cb_state
    _callback._cb_restore = _cb_restore
    return _callback


def reset_parameter(**kwargs: Union[list, Callable[[int], Any]]):
    """Reset parameters on schedule, e.g.
    ``reset_parameter(learning_rate=lambda i: 0.1 * 0.99 ** i)``
    (ref: callback.py:147)."""
    def _callback(env: CallbackEnv) -> None:
        it = env.iteration - env.begin_iteration
        n_rounds = env.end_iteration - env.begin_iteration
        updates = {}
        for name, schedule in kwargs.items():
            if isinstance(schedule, list):
                if len(schedule) != n_rounds:
                    raise ValueError(
                        f"the schedule list for {name!r} needs one entry "
                        f"per boosting round ({n_rounds})")
                target = schedule[it]
            else:
                target = schedule(it)
            if env.params.get(name) != target:
                updates[name] = target
        if updates:
            env.model.reset_parameter(updates)
            env.params.update(updates)
    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True, min_delta: Union[float, list] = 0.0):
    """(ref: callback.py:187)"""
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List[list] = []
    cmp_op: List[Callable] = []
    enabled = [True]
    first_metric = [""]

    def _init(env: CallbackEnv) -> None:
        enabled[0] = not any(
            env.params.get(alias, "") == "dart"
            for alias in ("boosting", "boosting_type", "boost"))
        if not enabled[0]:
            log.warning("Early stopping is not available in dart mode")
            return
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one dataset and eval metric is "
                "required for evaluation")
        if stopping_rounds <= 0:
            raise ValueError("stopping_rounds should be greater than zero.")
        if verbose:
            log.info("Training until validation scores don't improve for %d "
                     "rounds", stopping_rounds)

        # min_delta: a scalar applies everywhere; a list gives one
        # threshold per metric, tiled across datasets
        n_metrics = len({m[1] for m in env.evaluation_result_list})
        n_datasets = len(env.evaluation_result_list) // max(1, n_metrics)
        n_slots = n_datasets * n_metrics
        if isinstance(min_delta, list):
            if any(t < 0 for t in min_delta):
                raise ValueError("early stopping min_delta entries must "
                                 "be >= 0")
            if len(min_delta) == 0:
                deltas = [0.0] * n_slots
            elif len(min_delta) == 1:
                deltas = list(min_delta) * n_slots
            elif len(min_delta) == n_metrics:
                if first_metric_only and verbose:
                    log.info("Using only %s for early stopping",
                             min_delta[0])
                deltas = list(min_delta) * n_datasets
            else:
                raise ValueError("min_delta takes a scalar, a 1-element "
                                 "list, or one value per metric")
        else:
            if min_delta < 0:
                raise ValueError("early stopping min_delta must be >= 0")
            deltas = [min_delta] * n_slots

        first_metric[0] = env.evaluation_result_list[0][1].split(" ")[-1]
        for eval_ret, delta in zip(env.evaluation_result_list, deltas):
            best_iter.append(0)
            best_score_list.append(None)
            if eval_ret[3]:  # is_higher_better
                best_score.append(float("-inf"))
                cmp_op.append(
                    lambda new, best, d=delta: new > best + d)
            else:
                best_score.append(float("inf"))
                cmp_op.append(
                    lambda new, best, d=delta: new < best - d)

    def _final_iteration_check(env, eval_name_splitted, i):
        if env.iteration == env.end_iteration - 1:
            if verbose:
                best = "\t".join(
                    f"{n}'s {m}: {v:g}" for n, m, v, _ in best_score_list[i])
                log.info("Did not meet early stopping. Best iteration is:"
                         "\n[%d]\t%s", best_iter[i] + 1, best)
                if first_metric_only:
                    log.info("Evaluated only: %s", eval_name_splitted[-1])
            raise EarlyStopException(best_iter[i], best_score_list[i])

    def _callback(env: CallbackEnv) -> None:
        if not cmp_op:
            _init(env)
        if not enabled[0]:
            return
        for i, (name, metric, value, _) in \
                enumerate(env.evaluation_result_list):
            if best_score_list[i] is None or cmp_op[i](value, best_score[i]):
                best_score[i] = value
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            eval_name_splitted = metric.split(" ")
            if first_metric_only and first_metric[0] != eval_name_splitted[-1]:
                continue
            if name == "training":
                _final_iteration_check(env, eval_name_splitted, i)
                continue
            if env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    best = "\t".join(
                        f"{n}'s {m}: {v:g}"
                        for n, m, v, _ in best_score_list[i])
                    log.info("Early stopping, best iteration is:\n[%d]\t%s",
                             best_iter[i] + 1, best)
                    if first_metric_only:
                        log.info("Evaluated only: %s",
                                 eval_name_splitted[-1])
                raise EarlyStopException(best_iter[i], best_score_list[i])
            _final_iteration_check(env, eval_name_splitted, i)
    _callback.order = 30
    _callback._megastep_replay = "early_stopping"
    # the spec the JAX package's scan-carried early stop mirrors
    _callback._es_spec = (int(stopping_rounds), bool(first_metric_only),
                          min_delta)

    # checkpoint and resume (resilience/state.py): the closure's best
    # lists are the early-stop state, and restoring them keeps a resumed
    # run's stopping decision the uninterrupted run's
    def _cb_state():
        return {
            "inited": bool(cmp_op),
            "enabled": bool(enabled[0]),
            "first_metric": first_metric[0],
            "seen": [e is not None for e in best_score_list],
            "best_score": [float(s) if e is not None else 0.0
                           for s, e in zip(best_score, best_score_list)],
            "best_iter": [int(i) for i in best_iter],
            "best_score_list": [
                None if e is None
                else [[n, m, float(v), bool(b)] for n, m, v, b in e]
                for e in best_score_list],
        }

    def _cb_restore(st, env) -> None:
        if not st or not st.get("inited"):
            return
        if not cmp_op:
            # _init builds the per-slot comparators from an evaluation
            # list (the checkpoint carries the last one)
            _init(env)
        if len(best_iter) != len(st["best_iter"]):
            raise ValueError(
                f"early-stopping slots changed across resume "
                f"({len(st['best_iter'])} saved, {len(best_iter)} now)")
        enabled[0] = bool(st.get("enabled", True))
        first_metric[0] = st.get("first_metric", first_metric[0])
        for i in range(len(best_iter)):
            best_iter[i] = int(st["best_iter"][i])
            if st["seen"][i]:
                best_score[i] = float(st["best_score"][i])
                lst = st["best_score_list"][i]
                best_score_list[i] = ([tuple(t) for t in lst]
                                      if lst is not None else None)
    _callback._cb_state = _cb_state
    _callback._cb_restore = _cb_restore
    return _callback


def drain_replay_blocker(callbacks: List) -> Optional[str]:
    """None when every callback is one the JAX package's megastep replays,
    else the first that keeps training on the classic per-iteration loop
    (callback.py:359-382 of the JAX package)."""
    n_es = 0
    for cb in callbacks:
        kind = getattr(cb, "_megastep_replay", None)
        if kind is None:
            name = getattr(cb, "__qualname__",
                           getattr(cb, "__name__", type(cb).__name__))
            return f"callback:{name}"
        if kind == "early_stopping":
            n_es += 1
            _, _, delta = cb._es_spec
            deltas = delta if isinstance(delta, list) else [delta]
            if any(float(d) != 0.0 for d in deltas):
                # a nonzero min_delta compares best + delta in float64,
                # which the JAX package's f32 scan could not reproduce
                return "callback:early_stopping(min_delta)"
            if n_es > 1:
                return "callback:early_stopping(duplicate)"
    return None
