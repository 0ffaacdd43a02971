"""The scatter line_sample method: each line's Voigt window added into tau
(port of grtcode_tpu/gas_optics/optical_depth.py's
``accumulate_line_sample`` and ``optical_depth_line_sample``).

This is ``GasOptics(method="scatter")``, the JAX package's portable ground
truth for the line_sample sum.  Every line evaluates the full five-region
``voigt_line_shape`` over its whole window of ``2*fsteps + 1`` grid points
and the windows are added into tau with ``index_add_``.  It needs none of
K1's tables (near core, zones, shift margins), so it holds for any layer
temperature and pressure; K1 (:mod:`.voigt_kernel`) is held against it.

Lines stream in chunks of ``chunk``, in line order, as JAX's ``lax.scan``
takes them.  A chunk's (rows, chunk, 2*fsteps + 1) samples are evaluated
``SAMPLES_PER_STEP`` samples at a time (whole lines, in order): at the
production LW width (1,728 rows x 501 offsets) one line alone is 0.87 M
samples, and the Voigt evaluation keeps tens of bytes of temporaries per
sample.  On the CPU ``index_add_`` adds one element after another, so the
result is the same, bit for bit, whatever the chunk or the step; on CUDA
tensors it adds with atomics in no fixed order, so reruns may differ in
the last bits.

Plain PyTorch on any device: the JAX function is jnp, with no Pallas
kernel behind it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import constants
from .hitran import STRENGTH_SCALE
from ..utils.graphs import device_constant
from .lines import PreparedLines
from .voigt import voigt_line_shape

# Most (row, line, offset) samples evaluated at once: the LW band at 0.1
# cm-1 on 216 rows peaked at 3.21 GiB with it (NVIDIA H100 80GB HBM3,
# 700 W; chip_smoke.py phase 16).
SAMPLES_PER_STEP = 1 << 25


def lines_per_step(rows: int, fsteps: int, chunk: int) -> int:
    """Lines of a chunk evaluated at once: at most ``SAMPLES_PER_STEP``
    samples, at least one line."""
    return max(1, min(chunk, SAMPLES_PER_STEP // (rows * (2 * fsteps + 1))))


def accumulate_line_sample(center_idx, center_frac, strength, lorentz, doppler,
                           ns, *, num_wpoints: int, dw: float, fsteps: int,
                           chunk: int = 1024, tau0=None, start: int = 0,
                           num_global: int | None = None):
    """Accumulate per-line Voigt contributions into tau.

    Args:
      center_idx: (rows, L) int32 nearest grid index of shifted center.
      center_frac: (rows, L) f32 fractional grid offset of center.
      strength: (rows, L) f32, scaled by STRENGTH_SCALE.
      lorentz, doppler: (rows, L) f32 half-widths [cm-1].
      ns: (rows,) species column density [cm-2].
      num_wpoints, dw: spectral grid (block) size / resolution.
      fsteps: half-window in grid points (= ceil(cutoff/dw)).
      chunk: lines per step; the lines are padded to a multiple of it
        (centers -10**9, widths 1e-3), as in JAX.
      tau0: optional contiguous (rows, num_wpoints) tensor to add into, in
        place: f32, or f64 to sum the f32 samples in float64 (no sample
        is then lost to the rounding of a large partial sum).
      start: first (global) grid index of the output block.
      num_global: total grid size for the center-validity test
        (kernels.c:433 checks the *full*-grid bounds); defaults to
        ``num_wpoints``.  Points are tested against the block only, so a
        block past the grid end receives lines there, as in JAX.

    Returns ``tau0`` (rows, num_wpoints): the optical depth of grid points
    ``[start, start + num_wpoints)``.
    """
    if num_global is None:
        num_global = num_wpoints
    rows, L = strength.shape
    device = strength.device
    pad = -(-max(L, 1) // chunk) * chunk - L
    if pad:
        def padded(a, value):
            return F.pad(a, (0, pad), value=value)

        center_idx = padded(center_idx, -(10 ** 9))
        center_frac = padded(center_frac, 0.0)
        strength = padded(strength, 0.0)
        lorentz = padded(lorentz, 1e-3)
        doppler = padded(doppler, 1e-3)

    if tau0 is None:
        tau0 = torch.zeros((rows, num_wpoints), dtype=torch.float32,
                           device=device)
    flat = tau0.view(rows * num_wpoints)
    offsets = torch.arange(-fsteps, fsteps + 1, dtype=torch.int64,
                           device=device)
    offs_f = offsets.to(torch.float32)
    dw_f = device_constant(dw, device)
    ns_scaled = (ns.to(torch.float32)
                 / device_constant(STRENGTH_SCALE, device))[:, None, None]
    row_base = (torch.arange(rows, dtype=torch.int64, device=device)
                * num_wpoints)[:, None, None]
    step = lines_per_step(rows, fsteps, chunk)
    for c0 in range(0, L + pad, chunk):
        for c in range(c0, c0 + chunk, step):
            sl = slice(c, min(c + step, c0 + chunk))
            cidx = center_idx[:, sl]
            f = (cidx.to(torch.int64) - start)[..., None] + offsets
            dv = (offs_f - center_frac[:, sl, None]) * dw_f
            k = voigt_line_shape(dv, lorentz[:, sl, None],
                                 doppler[:, sl, None])
            valid_center = (cidx >= 0) & (cidx < num_global)
            in_bounds = (f >= 0) & (f < num_wpoints)
            vals = torch.where(valid_center[..., None] & in_bounds,
                               strength[:, sl, None] * ns_scaled * k, 0.0)
            idx = row_base + f.clamp(0, num_wpoints - 1)
            flat.index_add_(0, idx.reshape(-1),
                            vals.reshape(-1).to(flat.dtype))
    return tau0


def optical_depth_line_sample(prep: PreparedLines, ns, grid, *,
                              cutoff: float = constants.DEFAULT_LINE_CUTOFF,
                              chunk: int = 1024, tau0=None, start: int = 0,
                              block: int | None = None):
    """Convenience wrapper taking PreparedLines + SpectralGrid.

    ``start``/``block`` select a spectral sub-window (for sharded grids):
    the result covers grid points [start, start + block)."""
    fsteps = int(math.ceil(cutoff / grid.dw))
    return accumulate_line_sample(
        prep.center_idx, prep.center_frac, prep.strength, prep.lorentz,
        prep.doppler, ns, num_wpoints=grid.n if block is None else block,
        dw=float(grid.dw), fsteps=fsteps, chunk=chunk, tau0=tau0,
        start=start, num_global=grid.n)
