"""line_sample Voigt optical depth: the CUDA kernel, its plain PyTorch
version, and the dispatcher (counterpart of
grtcode_tpu/gas_optics/pallas_kernels.py).

The kernel, ``csrc/voigt_line_sample.cu``, replaces the Pallas TPU kernel
``pallas_kernels.py::_voigt_kernel``.  It is compiled with ``nvcc`` for
``sm_90a`` at first use into ``build/grtcode_tpu_torch/`` (keyed on a
hash of the flags, the source and the shared ``csrc/humlicek.cuh``; see
:mod:`grtcode_tpu_torch.cuda_build`) and called through a plain C entry
point with ``ctypes``.

What bounds it on the card is f32 arithmetic and IEEE division: each
(row, line) pair's ~20 input bytes are reused across up to 2*fsteps+1
points (501 at 0.1 cm-1), so device memory is not the limit.  The simple
design does three things about it: each thread owns one (row, point)
output and keeps its sum in a register; the point-independent per-line
factors are computed once per block into shared memory; and the
~300-operation five-region Humlicek evaluation runs only where a thread's
point lies in a line's near core, while the far wing is one rational with
one division.

:func:`accumulate_voigt` dispatches on the device of its tensors: CPU
tensors take :func:`voigt_line_sample_reference`; CUDA tensors launch the
kernel or raise.  It never tries the kernel and falls back.  Each function
counts its own launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..cuda_build import build_library
from .hitran import STRENGTH_SCALE
from .lines import PreparedLines
from .voigt import voigt_far_wing, voigt_line_shape

_lib = None
build_log = ""   # nvcc / ptxas output of the last build (registers, smem)


@dataclasses.dataclass
class ChunkRanges:
    """Per-tile contiguous line ranges (host tables, (ntiles,) int32).

    Tile t covers grid points [t*tile, (t+1)*tile); its lines are
    ``[lo[t], lo[t] + ch * nchunks[t])`` of the center-sorted catalog,
    ``lo`` aligned down to ``ch``.
    """

    lo: np.ndarray
    nchunks: np.ndarray
    tile: int
    ch: int
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    def tables(self, device):
        """(lo, hi) int32 tensors on ``device`` (copied once)."""
        key = str(torch.device(device))
        if key not in self._on_device:
            hi = self.lo.astype(np.int64) + self.ch * self.nchunks
            self._on_device[key] = (
                torch.as_tensor(self.lo, device=device),
                torch.as_tensor(hi.astype(np.int32), device=device))
        return self._on_device[key]


def build_chunk_ranges(c0_sorted: np.ndarray, num_wpoints: int, fsteps: int,
                       tile: int, ch: int, shift_margin: int = 2
                       ) -> ChunkRanges:
    """Lines whose unshifted center ``c0`` lies within ``fsteps +
    shift_margin`` of each tile, as ch-aligned contiguous ranges (the
    ``lo`` / ``nchunks`` of the JAX package's build_chunk_ranges)."""
    ntiles = -(-num_wpoints // tile)
    reach = fsteps + shift_margin
    first = np.arange(ntiles) * tile
    lo = np.searchsorted(c0_sorted, first - reach, side="left")
    hi = np.searchsorted(c0_sorted, first + (tile - 1) + reach, side="right")
    lo_al = (lo // ch) * ch
    nchunks = np.maximum(-(-(hi - lo_al) // ch), 0)
    return ChunkRanges(lo_al.astype(np.int32), nchunks.astype(np.int32),
                       tile=tile, ch=ch)


def build():
    """Compile the kernel (once per source hash) and load it."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    lib, build_log = build_library("voigt_line_sample")
    fn = lib.voigt_line_sample
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int64] * 2
                   + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def voigt_line_sample_reference(prep: PreparedLines, ns, *, num_wpoints: int,
                                dw: float, fsteps: int, near: int,
                                num_global: int, tau0=None, start: int = 0,
                                chunk: int = 64):
    """The plain PyTorch version: the port of the JAX package's
    ``optical_depth.accumulate_line_sample``.  Lines stream in chunks; each
    line's window of ``2*fsteps + 1`` points is evaluated and added with
    ``index_add_``.  The window's near core (``|offset| <= near``) takes
    the full five-region ``voigt_line_shape`` and the rest the
    regions-0/1 ``voigt_far_wing``, which is the same function there.

    Adds into ``tau0`` (rows, num_wpoints) in place and returns it.
    """
    voigt_line_sample_reference.launches += 1
    rows, L = prep.strength.shape
    device = prep.strength.device
    if tau0 is None:
        tau0 = torch.zeros((rows, num_wpoints), dtype=torch.float32,
                           device=device)
    offsets = torch.arange(-fsteps, fsteps + 1, dtype=torch.int64,
                           device=device)
    offs_f = offsets.to(torch.float32)
    dw_f = torch.tensor(dw, dtype=torch.float32, device=device)
    ns_scaled = (ns.to(torch.float32) / STRENGTH_SCALE)[:, None, None]
    core = slice(fsteps - near, fsteps + near + 1)
    row_base = (torch.arange(rows, dtype=torch.int64, device=device)
                * num_wpoints)[:, None, None]
    acc = torch.zeros(rows * num_wpoints, dtype=torch.float32, device=device)
    for c in range(0, L, chunk):
        cidx = prep.center_idx[:, c:c + chunk].to(torch.int64)
        cfrac = prep.center_frac[:, c:c + chunk, None]
        lor = prep.lorentz[:, c:c + chunk, None]
        dop = prep.doppler[:, c:c + chunk, None]
        s = prep.strength[:, c:c + chunk, None]
        g = cidx[..., None] + offsets                 # (rows, C, G) global
        f = g - start                                 # block-local index
        dv = (offs_f - cfrac) * dw_f
        k = voigt_far_wing(dv, lor, dop)
        k[..., core] = voigt_line_shape(dv[..., core], lor, dop)
        valid = ((cidx >= 0) & (cidx < num_global))[..., None] & \
            (f >= 0) & (f < num_wpoints) & (g < num_global)
        vals = torch.where(valid, s * ns_scaled * k, 0.0)
        idx = row_base + f.clamp(0, num_wpoints - 1)
        acc.index_add_(0, idx.reshape(-1), vals.reshape(-1))
    tau0 += acc.view(rows, num_wpoints)
    return tau0


voigt_line_sample_reference.launches = 0


def _check_cuda_args(prep: PreparedLines, ns, tau0, ranges: ChunkRanges,
                     start: int, num_wpoints: int):
    device = tau0.device
    rows, L = prep.strength.shape
    named = dict(center_idx=prep.center_idx, center_frac=prep.center_frac,
                 strength=prep.strength, lorentz=prep.lorentz,
                 doppler=prep.doppler, ns=ns, tau0=tau0)
    for name, t in named.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, tau0 on {device}")
        want = torch.int32 if name == "center_idx" else torch.float32
        if t.dtype != want:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        shape = {"ns": (rows,), "tau0": (rows, num_wpoints)}.get(name,
                                                                (rows, L))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if start % ranges.tile:
        raise ValueError(f"block start {start} is not a multiple of the "
                         f"tile {ranges.tile}")
    if L >= 2 ** 31 or num_wpoints >= 2 ** 31:
        raise ValueError("line or point count exceeds int32 indexing")


def accumulate_voigt(prep: PreparedLines, ns, ranges: ChunkRanges, *,
                     num_wpoints: int, dw: float, fsteps: int, near: int,
                     num_global: int, tau0=None, start: int = 0):
    """line_sample optical depth of one molecule on the spectral block
    ``[start, start + num_wpoints)``, added into ``tau0`` in place.

    Args:
      prep: PreparedLines with contiguous (rows, L) tensors.
      ns: (rows,) species column density [cm-2].
      ranges: per-tile line ranges from :func:`build_chunk_ranges` (the
        kernel's tile is ``ranges.tile``; ``start`` must be a multiple).
      num_wpoints, dw: block width and grid spacing.
      fsteps: half-window in grid points (ceil(cutoff/dw)).
      near: near-core half-width (full five-region scheme inside).
      num_global: grid size for the center / point validity tests.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.  Returns ``tau0`` (rows, num_wpoints).
    """
    rows = prep.strength.shape[0]
    device = prep.strength.device
    if tau0 is None:
        tau0 = torch.zeros((rows, num_wpoints), dtype=torch.float32,
                           device=device)
    if device.type == "cpu":
        return voigt_line_sample_reference(
            prep, ns, num_wpoints=num_wpoints, dw=dw, fsteps=fsteps,
            near=near, num_global=num_global, tau0=tau0, start=start)
    if device.type != "cuda":
        raise ValueError(f"accumulate_voigt: unsupported device {device}")
    _check_cuda_args(prep, ns, tau0, ranges, start, num_wpoints)
    lib = build()
    lo, hi = ranges.tables(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.voigt_line_sample(
        prep.center_idx.data_ptr(), prep.center_frac.data_ptr(),
        prep.strength.data_ptr(), prep.lorentz.data_ptr(),
        prep.doppler.data_ptr(), ns.data_ptr(), lo.data_ptr(),
        hi.data_ptr(), tau0.data_ptr(), rows, prep.strength.shape[1],
        start, num_wpoints, num_global, fsteps, near, ranges.tile,
        lo.shape[0], dw, stream)
    if err != 0:
        raise RuntimeError(f"voigt_line_sample launch failed: CUDA error "
                           f"{err}")
    accumulate_voigt.launches += 1
    return tau0


accumulate_voigt.launches = 0
