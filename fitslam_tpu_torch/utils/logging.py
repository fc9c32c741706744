"""Leveled logging (the ``warn`` part of ``fitslam_tpu/utils/logging.py``,
which the exploration server's retry ladder uses). Same format, same
``FITSLAM_LOG_LEVEL`` environment switch."""

from __future__ import annotations

import os
import sys
import time

TRACE, DEBUG, INFO, WARN, ERROR, FATAL = 0, 1, 2, 3, 4, 5
_NAMES = ["TRACE", "DEBUG", "INFO", "WARN", "ERROR", "FATAL"]
_COLORS = ["\033[90m", "\033[36m", "\033[32m", "\033[33m", "\033[31m", "\033[41m"]
_RESET = "\033[0m"

_level = {"TRACE": 0, "DEBUG": 1, "INFO": 2, "WARN": 3, "ERROR": 4, "FATAL": 5}.get(
    os.environ.get("FITSLAM_LOG_LEVEL", "INFO").upper(), INFO
)
_t0 = time.monotonic()
_use_color = sys.stderr.isatty()


def set_level(level: int):
    global _level
    _level = level


def _log(level: int, msg: str):
    if level < _level:
        return
    stamp = f"{time.monotonic() - _t0:9.3f}"
    tag = _NAMES[level]
    if _use_color:
        print(f"{_COLORS[level]}[{tag:<5} {stamp}] {msg}{_RESET}", file=sys.stderr)
    else:
        print(f"[{tag:<5} {stamp}] {msg}", file=sys.stderr)


def warn(msg: str):
    _log(WARN, msg)
