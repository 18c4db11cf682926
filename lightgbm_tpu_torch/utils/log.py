"""Logging for lightgbm_tpu_torch (a copy of ``lightgbm_tpu/utils/log.py``).

Analog of the reference logger (ref: include/LightGBM/utils/log.h:71-170):
leveled logging (Fatal/Warning/Info/Debug) with a pluggable callback so host
applications (and the Python `register_logger` API, ref: python-package
lightgbm/basic.py:48) can redirect output.
"""
from __future__ import annotations

import sys
from enum import IntEnum
from typing import Callable, Optional


class LogLevel(IntEnum):
    FATAL = -1
    WARNING = 0
    INFO = 1
    DEBUG = 2


class LightGBMError(Exception):
    """Raised on fatal errors (analog of the reference's Log::Fatal throw)."""


_log_level: LogLevel = LogLevel.INFO
_log_callback: Optional[Callable[[str], None]] = None


def set_log_level(level: LogLevel) -> None:
    global _log_level
    _log_level = LogLevel(level)


def get_log_level() -> LogLevel:
    return _log_level


def register_logger(callback: Optional[Callable[[str], None]]) -> None:
    """Redirect log output through ``callback`` (None restores stderr)."""
    global _log_callback
    _log_callback = callback


def _emit(msg: str) -> None:
    if _log_callback is not None:
        _log_callback(msg)
    else:
        print(msg, file=sys.stderr, flush=True)


def debug(fmt: str, *args) -> None:
    if _log_level >= LogLevel.DEBUG:
        _emit("[LightGBM-Torch] [Debug] " + (fmt % args if args else fmt))


def info(fmt: str, *args) -> None:
    if _log_level >= LogLevel.INFO:
        _emit("[LightGBM-Torch] [Info] " + (fmt % args if args else fmt))


def warning(fmt: str, *args) -> None:
    if _log_level >= LogLevel.WARNING:
        _emit("[LightGBM-Torch] [Warning] " + (fmt % args if args else fmt))


def fatal(fmt: str, *args) -> None:
    msg = fmt % args if args else fmt
    raise LightGBMError(msg)


def check(cond: bool, msg: str = "check failed") -> None:
    """Analog of the reference CHECK_* macros (ref: utils/log.h:30-68)."""
    if not cond:
        fatal(msg)
