"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel source in ``csrc/`` has a plain C entry point and no PyTorch
headers.  It is compiled for ``sm_90a`` at first use into
``build/grtcode_tpu_torch/`` beside the package, under a name keyed on a
hash of the flags, the source and every header in ``csrc/``, so a changed
header never leaves a stale library in use.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_PACKAGE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PACKAGE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE), "build",
                         "grtcode_tpu_torch")
# No fast-math; -fmad=false rounds every multiply and add on its own, as
# the plain versions' separate tensor ops do (with contraction on, the
# line_sample kernel misses its 2e-6 parity bar; see csrc/humlicek.cuh).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


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
    source = os.path.join(CSRC, f"{name}.cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    lib_path = os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:16]}.so")
    log = ""
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, source],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu "
                               f"({proc.returncode}):\n{log}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(lib_path), log
