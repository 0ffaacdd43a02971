"""Language bindings of the port: the C ABI of ``native/grtcode_tpu_c.h``
(and through it the Fortran module ``native/grtcode_tpu.F90``) over the
PyTorch pipeline.

The C++ shim is the JAX package's ``native/grtcode_tpu_c.cpp``, read in
place: it embeds CPython and dispatches every ``grt_*`` call into one
Python module, and :func:`build` swaps that module's name for
:mod:`.capi_impl`'s, writes the result into ``build/grtcode_tpu_torch/``
and compiles it there at first use with ``g++`` and ``python3-config
--includes`` / ``--ldflags --embed``.  It is linked with
``-Wl,-Bsymbolic``, so its own ``grt_*`` symbols bind inside it even when
the JAX package's shim is loaded into the same process; :func:`load`
opens it with ``RTLD_LOCAL``.  Importing this package builds nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

from ..cuda_build import BUILD_DIR, REPO, build_shared

SOURCE = os.path.join(REPO, "native", "grtcode_tpu_c.cpp")
HEADER = os.path.join(REPO, "native", "grtcode_tpu_c.h")
_JAX_MODULE = '"grtcode_tpu.bindings.capi_impl"'
_PORT_MODULE = '"grtcode_tpu_torch.bindings.capi_impl"'


def port_source() -> str:
    """``SOURCE`` with the port's module name in place of the JAX
    package's, written (once per content hash) into ``BUILD_DIR``;
    returns its path."""
    with open(SOURCE) as f:
        text = f.read()
    if text.count(_JAX_MODULE) != 1:
        raise RuntimeError(f"{SOURCE}: expected one import of {_JAX_MODULE}")
    text = text.replace(_JAX_MODULE, _PORT_MODULE)
    digest = hashlib.sha256(text.encode()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"grtcode_tpu_c_{digest}.cpp")
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    return path


def build() -> str:
    """Compile the shim (once per content hash); returns its path."""
    cxx = shutil.which("g++")
    config = shutil.which("python3-config")
    if cxx is None or config is None:
        raise RuntimeError("building the C ABI needs g++ and "
                           "python3-config")

    def flags(*args):
        return subprocess.run([config, *args], check=True,
                              capture_output=True, text=True).stdout.split()

    path, _ = build_shared(
        "grtcode_tpu_c",
        [cxx, "-O2", "-Wall", "-fPIC", "-std=c++17", "-shared",
         "-Wl,-Bsymbolic", "-I", os.path.dirname(HEADER),
         *flags("--includes")],
        port_source(), headers=[HEADER], link=flags("--ldflags", "--embed"))
    return path


def load() -> ctypes.CDLL:
    """The built shim, opened with RTLD_LOCAL, ``grt_errstr`` typed."""
    lib = ctypes.CDLL(build(), mode=ctypes.RTLD_LOCAL)
    lib.grt_errstr.restype = ctypes.c_char_p
    return lib
