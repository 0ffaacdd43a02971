"""Verbosity levels and the error-message buffer (port of
grtcode_tpu/utils/verbosity.py).

The reference's logging subsystem (utilities/src/verbosity.c:28-83,
debug.h:39-83): a global three-level verbosity switch (NONE/WARN/INFO),
set by the apps' ``-v``, and a bounded error buffer that accumulates
messages with file:line context, read back by ``errstr()`` (the C ABI's
``grt_errstr``).
"""
from __future__ import annotations

import inspect
import sys

GRTCODE_NONE = 0
GRTCODE_WARN = 1
GRTCODE_INFO = 2

_BUF_SIZE = 4096  # bytes, like the reference's 4 KB ring (verbosity.c:28)

_level = GRTCODE_NONE
_error_buffer = ""


def set_verbosity(level: int) -> None:
    """Set the global verbosity level (grtcode_set_verbosity)."""
    global _level
    if level not in (GRTCODE_NONE, GRTCODE_WARN, GRTCODE_INFO):
        raise ValueError(f"unknown verbosity level {level}")
    _level = level


def verbosity() -> int:
    return _level


def log_info(msg: str, *args) -> None:
    """Informational message (debug.h log_info), INFO level only."""
    if _level >= GRTCODE_INFO:
        print("[INFO] " + (msg % args if args else msg), file=sys.stderr)


def log_warn(msg: str, *args) -> None:
    if _level >= GRTCODE_WARN:
        print("[WARN] " + (msg % args if args else msg), file=sys.stderr)


def append_to_error_buffer(msg: str) -> None:
    """Accumulate an error message with caller file:line context
    (debug.h:39-70 backtrace accumulation), bounded to the buffer size."""
    global _error_buffer
    frame = inspect.currentframe()
    caller = frame.f_back if frame is not None else None
    where = ""
    if caller is not None:
        where = f"[{caller.f_code.co_filename}:{caller.f_lineno}] "
    entry = where + msg + "\n"
    _error_buffer = (_error_buffer + entry)[-_BUF_SIZE:]


def errstr() -> str:
    """The accumulated error backtrace (grtcode_errstr)."""
    return _error_buffer


def clear_error_buffer() -> None:
    global _error_buffer
    _error_buffer = ""
