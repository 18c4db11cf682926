"""Timeout and bounded-retry guards for host-plane collectives (a copy of
``lightgbm_tpu/resilience/comms.py``; its telemetry counters wait for
ROADMAP Queue A item 10e).

The host plane's gloo ``all_gather`` calls (``parallel/multiproc.py``
``_allgather``, and with it ``obs/registry.allgather_json``) block in
native code: a peer that hangs leaves every other rank wedged inside the
collective until the group's own timeout. With ``collective_timeout``
set (seconds; 0, the default, is off) the blocking call runs on a
watchdog thread, and a hung peer becomes a :class:`CollectiveError` on
the waiting ranks, from which a run restarts at its newest checkpoint.

Errors raised by the collective itself (transport hiccups) are retried
``collective_retries`` times; a timeout is never retried, since the
peers' pairing of collectives is lost by then and a retry would pair
with the wrong round. The growers' all-reduces (``ops/collectives.py``)
are not guarded, as the JAX package's device psums are not.
"""
from __future__ import annotations

import threading
import time
from typing import Callable

from ..utils import log

# process-wide policy, set from the trainer's config (_setup_resilience)
_TIMEOUT_S = 0.0
_RETRIES = 2


class CollectiveError(RuntimeError):
    """A host-plane collective timed out or kept failing."""


def set_collective_policy(timeout_s: float, retries: int = 2) -> None:
    global _TIMEOUT_S, _RETRIES
    _TIMEOUT_S = max(0.0, float(timeout_s or 0.0))
    _RETRIES = max(0, int(retries))


def _run_with_timeout(fn: Callable, what: str, timeout_s: float):
    box = {}
    done = threading.Event()

    def worker():
        try:
            box["result"] = fn()
        except BaseException as e:     # noqa: BLE001 — re-raised below
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=worker, daemon=True,
                         name=f"collective-{what}")
    t.start()
    if not done.wait(timeout_s):
        # the worker thread is abandoned (the native call cannot be
        # interrupted); the caller is expected to end the process
        raise CollectiveError(
            f"host collective '{what}' timed out after {timeout_s:.1f}s "
            "(hung or dead peer); resume from the newest checkpoint")
    if "error" in box:
        raise box["error"]
    return box.get("result")


def guarded_call(fn: Callable, what: str = "allgather"):
    """Run a blocking host collective under the configured policy: a
    direct call with no timeout set; otherwise errors retry up to the
    configured count with a short backoff and a timeout raises at once."""
    timeout_s = _TIMEOUT_S
    if timeout_s <= 0.0:
        return fn()
    last = None
    for attempt in range(_RETRIES + 1):
        try:
            return _run_with_timeout(fn, what, timeout_s)
        except CollectiveError:
            raise
        except Exception as e:          # transport error: bounded retry
            last = e
            if attempt < _RETRIES:
                log.warning("host collective '%s' failed (%s: %s); "
                            "retry %d/%d", what, type(e).__name__,
                            str(e)[:200], attempt + 1, _RETRIES)
                time.sleep(0.5 * (attempt + 1))
    raise CollectiveError(
        f"host collective '{what}' failed after {_RETRIES + 1} attempts: "
        f"{type(last).__name__}: {str(last)[:300]}") from last
