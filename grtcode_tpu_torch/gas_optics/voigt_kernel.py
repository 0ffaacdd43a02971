"""line_sample Voigt optical depth: the CUDA kernel, its plain PyTorch
version, and the dispatcher (counterpart of
grtcode_tpu/gas_optics/pallas_kernels.py).

The kernel, ``csrc/voigt_line_sample.cu``, replaces the Pallas TPU kernel
``pallas_kernels.py::_voigt_kernel``.  It is built, loaded and launched
through its entry in :data:`grtcode_tpu_torch.cuda_build.KERNELS`.

What bounds it on the card is f32 arithmetic and the IEEE division of
every term: each (row, line) pair's ~20 input bytes are reused across up
to 2*fsteps+1 points (501 at 0.1 cm-1), so device memory is not the limit.
The design (described at the top of the ``.cu`` file) keeps each term to
as few instructions as its rounding allows: each thread sums a few
consecutive points of one row in registers; the per-(row, line) factors
are computed once per block into shared memory; the host tables of
:func:`build_chunk_ranges` split a tile's lines into zones so the interior
lines, most of them at 0.1 cm-1, take the division with no test at all;
and the block evaluates the near-core samples of its tile first, a warp
at a time over the same offset of 32 lines, so the point loop never
branches into the five-region Humlicek for one lane.

:func:`accumulate_voigt` dispatches on the device of its tensors: CPU
tensors take :func:`voigt_line_sample_reference`; CUDA tensors launch the
kernel or raise (:func:`..cuda_build.on_card`).  Each function counts its
own launches in ``.launches``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..cuda_build import KERNELS, check_tensors, on_card
from ..utils.graphs import count_launches, device_constant
from .hitran import STRENGTH_SCALE
from .lines import PreparedLines
from .voigt import voigt_far_wing, voigt_line_shape


@dataclasses.dataclass
class ChunkRanges:
    """Per-tile line ranges and zones (host tables, (ntiles,) int32; the
    JAX package's ``pallas_kernels.ChunkRanges`` without ``lpad``).

    Tile t covers grid points [t*tile, (t+1)*tile); its lines are
    ``[lo[t], lo[t] + ch * nchunks[t])`` of the center-sorted catalog,
    ``lo`` aligned down to ``ch``.  The other tables are ranges of chunk
    indices relative to ``lo[t]`` (in ``ch``-line units):

      * ``[cnl, cnh)``: chunks whose lines can have a near-core sample in
        the tile (centers within ``hw`` of it);
      * ``[m0l, m0h)``: core-adjacent chunks, with some line within the
        region-0 half-width (and ``hw``) of the tile: every test kept;
      * ``[fll, flh)`` and ``[frl, frh)``: interior chunks, whose every
        line covers the whole tile, lies beyond the region-0 half-width and
        cannot shift off the grid: pure region 0, no test.

    The other chunks are edge chunks: pure region 0 with the window test.
    ``hw`` is the near-core half-width the tables were built for (the
    kernel's ``near`` plus ``shift_margin`` must not exceed it).
    """

    lo: np.ndarray
    nchunks: np.ndarray
    cnl: np.ndarray
    cnh: np.ndarray
    m0l: np.ndarray
    m0h: np.ndarray
    fll: np.ndarray
    flh: np.ndarray
    frl: np.ndarray
    frh: np.ndarray
    tile: int
    ch: int
    hw: int
    shift_margin: int
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    def zones(self) -> np.ndarray:
        """The kernel's (ntiles, 10) int32 table of line-index bounds per
        tile: lo, hi, then the near-core, core-adjacent, interior-left and
        interior-right ranges, each [start, end)."""
        base = self.lo.astype(np.int64)
        cols = [base] + [base + self.ch * c.astype(np.int64) for c in (
            self.nchunks, self.cnl, self.cnh, self.m0l, self.m0h, self.fll,
            self.flh, self.frl, self.frh)]
        return np.stack(cols, axis=1).astype(np.int32)

    def tables(self, device):
        """:meth:`zones` as a tensor on ``device`` (copied once)."""
        key = str(torch.device(device))
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(self.zones(),
                                                   device=device)
        return self._on_device[key]


def build_chunk_ranges(c0_sorted: np.ndarray, num_wpoints: int, fsteps: int,
                       tile: int, ch: int, shift_margin: int = 2,
                       near_hw: int | None = None,
                       region0_hw: int | None = None) -> ChunkRanges:
    """Per-tile chunk tables, a numpy copy of the JAX package's
    ``pallas_kernels.build_chunk_ranges`` (byte-identical tables).

    Lines whose unshifted center ``c0`` lies within ``fsteps +
    shift_margin`` of tile t are ``ch``-aligned chunks from ``lo[t]``;
    ``near_hw`` (default ``fsteps``) sizes the near-core range and
    ``region0_hw`` (from :func:`lines.region0_halfwidth`) the zones; when
    it is None every chunk is core-adjacent and none interior.
    """
    ntiles = -(-num_wpoints // tile)
    reach = fsteps + shift_margin
    first = np.arange(ntiles) * tile
    lo = np.searchsorted(c0_sorted, first - reach, side="left")
    hi = np.searchsorted(c0_sorted, first + (tile - 1) + reach, side="right")
    lo_al = (lo // ch) * ch
    nchunks = np.maximum(-(-(hi - lo_al) // ch), 0)
    # Near-core chunk sub-range: lines whose c0 +- hw window overlaps the
    # tile, i.e. c0 in [first - hw, first + tile - 1 + hw].
    hw = fsteps if near_hw is None else near_hw
    nlo = np.searchsorted(c0_sorted, first - hw, side="left")
    nhi = np.searchsorted(c0_sorted, first + (tile - 1) + hw, side="right")
    cnl = np.clip((nlo - lo_al) // ch, 0, nchunks)
    cnh = np.clip(-(-(nhi - lo_al) // ch), 0, nchunks)

    zeros = np.zeros(ntiles, np.int64)
    if region0_hw is None:
        m0l, m0h = zeros, nchunks.astype(np.int64)
        fll = flh = frl = frh = zeros
    else:
        # Edge and interior chunks skip the near-core test, which is only
        # sound when every line beyond the core zone is also beyond the
        # near window: region0_hw is raised to the near reach.
        reach0 = max(region0_hw, hw) + shift_margin
        # Core-adjacent (ANY line within reach0 of the tile): floor start,
        # ceil end.
        il = np.searchsorted(c0_sorted, first - reach0, side="left")
        ih = np.searchsorted(c0_sorted, first + (tile - 1) + reach0,
                             side="right")
        m0l = np.clip((il - lo_al) // ch, 0, nchunks)
        m0h = np.clip(-(-(ih - lo_al) // ch), 0, nchunks)

        # Interior (EVERY line of the chunk qualifies): ceil start, floor
        # end.  Left: the window covers the whole tile (c0 >= first + tile
        # - 1 - fsteps + margin), strictly beyond reach0 (c0 <= first -
        # reach0 - 1), and the shifted center stays on the grid (c0 >=
        # margin); the right range mirrors it.
        def all_sub(vmin, vmax):
            a = np.searchsorted(c0_sorted, vmin, side="left")
            b = np.searchsorted(c0_sorted, vmax, side="right")
            cl = np.clip(-(-(a - lo_al) // ch), 0, nchunks)
            chh = np.clip((b - lo_al) // ch, 0, nchunks)
            return cl, np.maximum(chh, cl)

        fll, flh = all_sub(
            np.maximum(first + (tile - 1) - fsteps + shift_margin,
                       shift_margin),
            first - reach0 - 1)
        frl, frh = all_sub(
            first + tile + reach0,
            np.minimum(first + fsteps - shift_margin,
                       num_wpoints - 1 - shift_margin))

    i32 = np.int32
    return ChunkRanges(lo_al.astype(i32), nchunks.astype(i32),
                       cnl.astype(i32), cnh.astype(i32), m0l.astype(i32),
                       m0h.astype(i32), fll.astype(i32), flh.astype(i32),
                       frl.astype(i32), frh.astype(i32), tile=tile, ch=ch,
                       hw=int(hw), shift_margin=int(shift_margin))


def voigt_line_sample_reference(prep: PreparedLines, ns, *, num_wpoints: int,
                                dw: float, fsteps: int, near: int,
                                num_global: int, tau0=None, start: int = 0,
                                chunk: int = 64):
    """The plain PyTorch version of K1, with K1's near-core split: the
    JAX package's tiled path (``accumulate_tiled`` with ``far_kernel`` plus
    ``accumulate_near_pointwise``), not its scatter sum
    (:mod:`.optical_depth`).  Lines stream in chunks; each line's window
    of ``2*fsteps + 1`` points is evaluated and added with ``index_add_``.
    The window's near core (``|offset| <= near``) takes the full
    five-region ``voigt_line_shape`` and the rest the regions-0/1
    ``voigt_far_wing``, which is the same function there only inside the
    tables' limits (``lines.TMAX_K``, ``lines.PMAX_ATM``).  Points past
    ``num_global`` receive nothing.

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
    dw_f = device_constant(dw, device)
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
                     start: int, num_wpoints: int, near: int):
    rows, L = prep.strength.shape
    check_tensors(prep.strength.device, dict(
        prep.kernel_layout(), ns=(ns, (rows,), torch.float32),
        tau0=(tau0, (rows, num_wpoints), torch.float32)))
    if start % ranges.tile:
        raise ValueError(f"block start {start} is not a multiple of the "
                         f"tile {ranges.tile}")
    if near + ranges.shift_margin > ranges.hw:
        raise ValueError(f"near {near} plus the shift margin "
                         f"{ranges.shift_margin} exceeds the tables' "
                         f"near-core half-width {ranges.hw}")
    if L >= 2 ** 31 or num_wpoints >= 2 ** 31:
        raise ValueError("line or point count exceeds int32 indexing")


@count_launches
def accumulate_voigt(prep: PreparedLines, ns, ranges: ChunkRanges, *,
                     num_wpoints: int, dw: float, fsteps: int, near: int,
                     num_global: int, tau0=None, start: int = 0):
    """line_sample optical depth of one molecule on the spectral block
    ``[start, start + num_wpoints)``, added into ``tau0`` in place.

    Args:
      prep: PreparedLines with contiguous (rows, L) tensors.
      ns: (rows,) species column density [cm-2].
      ranges: per-tile line ranges and zones from :func:`build_chunk_ranges`
        (the kernel's tile is ``ranges.tile``; ``start`` must be a
        multiple; ``near + ranges.shift_margin <= ranges.hw``).
      num_wpoints, dw: block width and grid spacing.
      fsteps: half-window in grid points (ceil(cutoff/dw)).
      near: near-core half-width (full five-region scheme inside).
      num_global: grid size for the center / point validity tests.

    The kernel trusts the tables: interior and edge lines take region 0
    with no test, which holds only for rows no warmer than
    ``lines.TMAX_K`` (500 K, the region-0 and near-core half-widths) and
    at no more than ``lines.PMAX_ATM`` (1.5 atm, the shift margin);
    :meth:`GasOptics.optical_depth` refuses rows beyond them.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.  Returns ``tau0`` (rows, num_wpoints).
    """
    rows = prep.strength.shape[0]
    device = prep.strength.device
    if tau0 is None:
        tau0 = torch.zeros((rows, num_wpoints), dtype=torch.float32,
                           device=device)
    if not on_card(device, "accumulate_voigt"):
        return voigt_line_sample_reference(
            prep, ns, num_wpoints=num_wpoints, dw=dw, fsteps=fsteps,
            near=near, num_global=num_global, tau0=tau0, start=start)
    _check_cuda_args(prep, ns, tau0, ranges, start, num_wpoints, near)
    zones = ranges.tables(device)
    return KERNELS["voigt_line_sample"].launch(
        accumulate_voigt, device, tau0,
        prep.center_idx.data_ptr(), prep.center_frac.data_ptr(),
        prep.strength.data_ptr(), prep.lorentz.data_ptr(),
        prep.doppler.data_ptr(), ns.data_ptr(), zones.data_ptr(),
        tau0.data_ptr(), rows, prep.strength.shape[1], start, num_wpoints,
        num_global, fsteps, near, ranges.tile, zones.shape[0], dw)
