"""ctypes loader for the native HITRAN ``.par`` scanner (port of
grtcode_tpu/native.py).

The fixed-width record scan of ``native/hitran_parser.cpp`` (the source
the JAX package builds, read in place) is compiled with ``g++ -O2 -shared
-fPIC`` at first use into ``build/grtcode_tpu_torch/``
(:func:`grtcode_tpu_torch.cuda_build.build_shared`); nothing is written
into ``native/``.  When no library can be built, :func:`parse_par_native`
returns None and the parser takes its Python loop; the first such failure
logs one warning with the compiler's error.
"""
from __future__ import annotations

import ctypes
import logging
import os
import shutil

import numpy as np

from .cuda_build import REPO, build_shared

SOURCE = os.path.join(REPO, "native", "hitran_parser.cpp")
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

log = logging.getLogger("grtcode_tpu_torch")

_lib = None
_tried = False


def _load():
    """The scanner library, built on the first call; None (after one
    warning naming the error) when it cannot be built or loaded."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found")
        path, _ = build_shared("hitran_parser", [cxx, *CXX_FLAGS], SOURCE)
        lib = ctypes.CDLL(path)
    except (RuntimeError, OSError) as e:
        log.warning("native HITRAN scanner unavailable, .par files parse "
                    "in Python: %s", e)
        return None
    lib.grt_parse_par.restype = ctypes.c_int64
    lib.grt_parse_par.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_int64] + [ctypes.c_void_p] * 8
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def parse_par_native(path: str, mol_id: int, w0: float = -1.0,
                     wn: float = -1.0):
    """Parse raw per-line fields with the native scanner.

    Returns (iso, vnn, s0, yair, yself, en, n, d) numpy arrays, or None
    when the native library is unavailable.  Raises OSError when the file
    cannot be opened and ValueError on a bad record (the Python parser's
    error).
    """
    lib = _load()
    if lib is None:
        return None
    size = os.path.getsize(path)
    capacity = max(size // 161 + 2, 16)
    iso = np.empty(capacity, np.int32)
    arrs = [np.empty(capacity, np.float64) for _ in range(7)]
    # Window disabled when w0 > wn (the Python parser's negative default).
    lo, hi = (w0, wn) if not (w0 < 0 and wn < 0) else (1.0, 0.0)
    n = lib.grt_parse_par(
        path.encode(), int(mol_id), float(lo), float(hi),
        ctypes.c_int64(capacity),
        iso.ctypes.data_as(ctypes.c_void_p),
        *[a.ctypes.data_as(ctypes.c_void_p) for a in arrs])
    if n == -1:
        raise OSError(f"cannot open {path}")
    if n < 0:
        raise ValueError(f"bad record in {path} (native rc {n})")
    vnn, s0, yair, yself, en, nexp, d = arrs
    return (iso[:n], vnn[:n], s0[:n], yair[:n], yself[:n], en[:n],
            nexp[:n], d[:n])
