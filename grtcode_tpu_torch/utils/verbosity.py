"""The verbosity level (the level switch of grtcode_tpu/utils/verbosity.py).

The reference's global three-level switch (utilities/src/verbosity.c:28-83):
NONE/WARN/INFO, set by the apps' ``-v``.  The error buffer behind the C
ABI's ``grt_errstr`` comes with the port of the bindings.
"""
from __future__ import annotations

GRTCODE_NONE = 0
GRTCODE_WARN = 1
GRTCODE_INFO = 2

_level = GRTCODE_NONE


def set_verbosity(level: int) -> None:
    """Set the global verbosity level (grtcode_set_verbosity)."""
    global _level
    if level not in (GRTCODE_NONE, GRTCODE_WARN, GRTCODE_INFO):
        raise ValueError(f"unknown verbosity level {level}")
    _level = level


def verbosity() -> int:
    return _level
