"""Build the port's native libraries at first use and load them with
``ctypes``.

Each CUDA kernel source in ``csrc/`` has a plain C entry point and no
PyTorch headers.  It is compiled for ``sm_90a`` by ``nvcc``; the two host
libraries (the HITRAN ``.par`` scanner, ``native/hitran_parser.cpp``, and
the C ABI shim, ``native/grtcode_tpu_c.cpp`` with the port's module
name, :mod:`.bindings`) by ``g++``.  Every library goes into
``build/grtcode_tpu_torch/`` beside the package, under a name keyed on a
hash of the command, the source and its headers, so a changed header never
leaves a stale library in use; a build writes a temporary file and renames
it into place, so concurrent first uses never load a half-written one.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_PACKAGE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(_PACKAGE)
CSRC = os.path.join(_PACKAGE, "csrc")
BUILD_DIR = os.path.join(REPO, "build", "grtcode_tpu_torch")
# No fast-math; -fmad=false rounds every multiply and add on its own, as
# the plain versions' separate tensor ops do (with contraction on, the
# line_sample kernel misses its 2e-6 parity bar; see csrc/humlicek.cuh).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def build_shared(name: str, command, source: str, headers=(),
                 link=()) -> tuple[str, str]:
    """Compile ``source`` with ``command`` (compiler and flags) and
    ``link`` (flags after the source) into ``BUILD_DIR/<name>_<hash>.so``
    unless that file exists.  Returns its path and the compiler's output
    of this build (empty when it was already built).  Raises
    RuntimeError with the compiler's output when the build fails."""
    command, link = list(command), list(link)
    digest = hashlib.sha256(" ".join(command + link).encode())
    for path in [source, *headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    lib_path = os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:16]}.so")
    log = ""
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        proc = subprocess.run([*command, "-o", tmp, source, *link],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"{command[0]} failed on "
                               f"{os.path.basename(source)} "
                               f"({proc.returncode}):\n{log}")
        os.replace(tmp, lib_path)
    return lib_path, log


def build_library(name: str) -> tuple[ctypes.CDLL, str]:
    """Compile ``csrc/<name>.cu`` (once per content hash) and load it.

    Returns the loaded library and the nvcc / ptxas output of this build
    (registers, shared memory, spills; empty when the library was already
    built).
    """
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found: the CUDA toolkit is needed to "
                           f"build the {name} kernel")
    path, log = build_shared(
        name, [nvcc, *NVCC_FLAGS], os.path.join(CSRC, f"{name}.cu"),
        sorted(glob.glob(os.path.join(CSRC, "*.cuh"))))
    return ctypes.CDLL(path), log
