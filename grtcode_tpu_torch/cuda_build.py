"""Build the port's native libraries at first use and load them with
``ctypes``, and launch its hand-written kernels.

Each CUDA kernel source ``csrc/<name>.cu`` has a plain C entry point
``int <name>(..., cudaStream_t)`` and no PyTorch headers.  It is one entry
of :data:`KERNELS`; its dispatcher picks it or its plain version by device
(:func:`on_card`), checks the tensors it passes (:func:`check_tensors`)
and its own invariants, and launches it through :meth:`Kernel.launch`, so
that every kernel is built, launched and counted by the same rules.

A kernel is compiled for ``sm_90a`` by ``nvcc``; the two host
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
import dataclasses
import glob
import hashlib
import os
import shutil
import subprocess

import torch

from .utils import debug

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


@dataclasses.dataclass
class Kernel:
    """A hand-written kernel, ``csrc/<name>.cu``: ``argtypes`` are the
    ctypes types of its entry point's arguments before the stream, which
    comes last; it returns 0 or a CUDA error code."""

    name: str
    argtypes: tuple
    build_log: str = ""   # nvcc / ptxas output of this process's build
    fn: object = dataclasses.field(default=None, repr=False)

    def load(self):
        """The entry point, built (once per source hash) and loaded at the
        first call of a process."""
        if self.fn is None:
            lib, self.build_log = build_library(self.name)
            fn = getattr(lib, self.name)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self.fn = fn
        return self.fn

    def launch(self, dispatcher, device, outputs, *args):
        """Launch the kernel with ``args`` on the current stream of
        ``device``.  A nonzero return raises RuntimeError; a launch that
        succeeded adds one to ``dispatcher.launches`` and, inside
        :func:`.utils.debug.debug_mode`, has its ``outputs`` checked.
        Returns ``outputs``."""
        err = self.load()(*args, _stream(device))
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        dispatcher.launches += 1
        debug.check_kernel_output(self.name, outputs)
        return outputs


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
# Every hand-written kernel, by name; a new kernel is one entry here, its
# dispatcher and its plain version.
KERNELS = {k.name: k for k in (
    # K1, line_sample Voigt: gas_optics/voigt_kernel.py::accumulate_voigt.
    Kernel("voigt_line_sample", (_P,) * 8 + (_I64,) * 2 + (_I32,) * 7
           + (_F32,)),
    # K2, the bin methods' Voigt: gas_optics/bins_kernel.py.
    Kernel("voigt_bins", (_P,) * 10 + (_I64,) * 2 + (_I32,) * 4
           + (_I64, _F32)),
    # K3, DISORT's layer doubling: solvers/disort.py::layer_operators.
    Kernel("disort_doubling", (_I32,) + (_P,) * 17 + (_I64,) * 2 + (_F32,)),
)}


def on_card(device: torch.device, dispatcher: str) -> bool:
    """Whether ``dispatcher`` launches its kernel on ``device``: False on
    the CPU (its plain version runs), True on a CUDA device (the kernel
    runs or the launch raises; nothing falls back), and ValueError on any
    other device."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{dispatcher}: unsupported device {device}")
    return True


def check_tensors(device: torch.device, named: dict) -> None:
    """Raise ValueError unless every ``name: (tensor, shape, dtype)`` of
    ``named`` is a contiguous tensor of that shape and dtype on
    ``device``: what a kernel reads through a raw pointer."""
    for name, (t, shape, dtype) in named.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
