"""High-level gas-optics engine (port of
grtcode_tpu/gas_optics/gas_optics.py).

Absorbers are registered once on the host (data loading, grid binding,
per-tile and per-bin line-range tables); :meth:`GasOptics.optical_depth`
is the device forward pass: Curtis-Godson prep -> per-molecule line prep
and the line_sample or bin Voigt kernel (or the scatter sum) -> continua
-> CFC -> CIA -> (bin methods) the wing interpolation.  The (batch, layer)
plane flattens into one "rows" axis, so the whole batch is one kernel
launch per molecule.  In a spectral block the bin methods prep only the
window of lines that the block's bins read; ``GasOptics.line_prep``
counts the lines prepped against the catalog lines they stand for.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from .. import constants
from ..spectral import SpectralGrid
from ..utils import curtis_godson as cg
from ..utils import metrics
from ..utils.graphs import device_constant
from . import bins as bins_mod
from . import lines as lines_mod
from . import tips as tips_mod
from .bins_kernel import accumulate_bins_kernel
from .continua import OzoneContinuum, WaterVaporContinuum
from .hitran import LineCatalog, parse_par_file
from .molecules import MoleculeId
from .optical_depth import optical_depth_line_sample
from .voigt_kernel import accumulate_voigt, build_chunk_ranges
from .xsec import (CrossSectionTable, cfc_optical_depth,
                   cia_optical_depth)

_K1_METHODS = ("tiled", "line_sample")   # K1 and its tables
_BIN_METHODS = ("wavenumber_sweep", "line_sweep")
_METHODS = _K1_METHODS + ("scatter",) + _BIN_METHODS


@dataclasses.dataclass
class GasOptics:
    """Registered absorbers bound to one spectral grid, on one device."""

    grid: SpectralGrid
    wcutoff: float = constants.DEFAULT_LINE_CUTOFF
    hitran_path: str | None = None
    h2o_ctm: WaterVaporContinuum | None = None
    o3_ctm: OzoneContinuum | None = None
    tips: object = None
    line_chunk: int = 1024   # catalogs pad to a multiple of this
    # "tiled" / "line_sample": exact per-point sampling over the +-cutoff
    # window (the reference driver's production method), by K1.
    # "scatter": the same sum, each line's window added with index_add_
    # (the ground truth K1 is held to; no temperature or pressure limit).
    # "wavenumber_sweep": bin sweep, wings at 3 points per bin,
    # quadratically interpolated (kernels.c:177-304).
    # "line_sweep": per-line local window + binned wings
    # (kernels.c:306-406).
    method: str = "tiled"
    bin_width: float = 1.0   # [cm-1] for the bin methods
    bin_group: int = 8       # bins per spectral-block quantum (bin methods)
    tile: int = 64           # spectral tile width of the kernel
    ch: int = 32             # line-range alignment of the tile tables
    molecules: dict = dataclasses.field(default_factory=dict)   # id -> GridLines
    near_steps: dict = dataclasses.field(default_factory=dict)  # id -> int
    chunk_ranges: dict = dataclasses.field(default_factory=dict)  # id -> ChunkRanges
    cfcs: dict = dataclasses.field(default_factory=dict)        # id -> table
    cias: list = dataclasses.field(default_factory=list)        # (id1, id2, table)
    device: torch.device | str = dataclasses.field(kw_only=True)

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.tips is None:
            self.tips = tips_mod.default_tips()
        if self.method not in _METHODS:
            raise ValueError(f"method {self.method!r}: expected one of "
                             f"{_METHODS}")
        if not (constants.MIN_LINE_CUTOFF <= self.wcutoff
                <= constants.MAX_LINE_CUTOFF):
            raise ValueError(f"cutoff {self.wcutoff} outside allowed range")
        # Cap the tile so even small grids split into >= ~8 tiles.
        eighth = -(-self.grid.n // 8)
        self.tile = min(self.tile, max(8, -(-eighth // 8) * 8))
        self.ch = min(self.ch, max(8, -(-self.line_chunk // 8) * 8))
        # ~1 cm-1 spectral bins for the bin methods (gas_optics.c:73-81).
        self.bins = bins_mod.create_spectral_bins(
            self.grid.n, self.grid.w0, self.grid.dw, self.bin_width)
        self._bin_ranges = {}     # id -> BinRanges
        self._windows = {}        # (id, start_bin, nbins) -> (lo, hi, ranges)
        self._raw_bounds = {}     # id -> unpadded GridLines
        self._wrel = {}           # (nbins, start_bin) -> device table
        self.line_prep = metrics.LinePrepCounts()

    @property
    def block_quantum(self) -> int:
        """Spectral-block alignment unit: a whole group of bins for the bin
        methods, the kernel's tile for the sampling methods."""
        if self.method in _BIN_METHODS:
            return self.bins.ppb * self.bin_group
        return self.tile

    @property
    def _fsteps(self) -> int:
        return int(math.ceil(self.wcutoff / self.grid.dw))

    def _get_bin_ranges(self, mol_id: int) -> bins_mod.BinRanges:
        """Per-bin line ranges (host, cached), built on the unpadded
        catalog."""
        if mol_id not in self._bin_ranges:
            mode = ("bin_sweep" if self.method == "wavenumber_sweep"
                    else "line_sweep")
            self._bin_ranges[mol_id] = bins_mod.build_bin_ranges(
                self._raw_bounds[mol_id], self.bins, mode=mode,
                remote_cutoff=self.wcutoff)
        return self._bin_ranges[mol_id]

    def _line_window(self, mol_id: int, start_bin: int, nbins: int):
        """``(lo, hi, ranges)`` of a bin-method block (host, cached): the
        lines ``[lo, hi)`` of the padded catalog that the block's bins
        read, and the per-bin ranges shifted to index them
        (:meth:`bins.BinRanges.window`).  A block that reaches the whole
        catalog gets it, with the band's own ranges."""
        key = (mol_id, start_bin, nbins)
        if key not in self._windows:
            self._windows[key] = self._get_bin_ranges(mol_id).window(
                start_bin, nbins, self.molecules[mol_id].num_lines)
        return self._windows[key]

    def _block_w_rel(self, start_bin: int, nbins: int):
        """(nbins, NIP) f32 interpolation positions of the bin window on
        the device.  Bins past the band get the safe rows [0, 1, 2]
        (nonzero x1, x2), so their zero wings interpolate to zero and
        never to 0/0."""
        key = (nbins, start_bin)
        if key not in self._wrel:
            w = self.bins.w_rel
            pad = np.tile(np.arange(bins_mod.NIP, dtype=np.float32),
                          (max(0, start_bin + nbins - self.bins.n), 1))
            self._wrel[key] = torch.as_tensor(
                np.concatenate([w, pad])[start_bin:start_bin + nbins],
                device=self.device)
        return self._wrel[key]

    # -- registration (host side) -----------------------------------------
    def add_molecule(self, mol_id, min_line_center: float | None = None,
                     max_line_center: float | None = None):
        """Parse HITRAN lines for a molecule from ``hitran_path``."""
        mol_id = int(MoleculeId(mol_id))
        w0 = self.grid.w0 if min_line_center is None else min_line_center
        wn = self.grid.wn if max_line_center is None else max_line_center
        catalog = parse_par_file(self.hitran_path, mol_id, w0, wn,
                                 tips=self.tips)
        self.add_catalog(catalog)

    def add_catalog(self, catalog: LineCatalog):
        """Register a pre-built line catalog."""
        if catalog.mol_id in self.molecules:
            raise ValueError(f"molecule {catalog.mol_id} already added")
        bound = lines_mod.bind_to_grid(catalog, self.grid)
        self._raw_bounds[catalog.mol_id] = bound
        padded = bound.pad_to(
            max(self.line_chunk,
                -(-bound.num_lines // self.line_chunk) * self.line_chunk))
        self.molecules[catalog.mol_id] = padded
        fsteps = self._fsteps
        margin = lines_mod.shift_margin(padded, self.grid.dw)
        near = min(lines_mod.near_core_halfwidth(padded, self.grid.dw),
                   fsteps)
        self.near_steps[catalog.mol_id] = near
        self.chunk_ranges[catalog.mol_id] = build_chunk_ranges(
            padded.c0, self.grid.n, fsteps, self.tile, self.ch,
            shift_margin=margin, near_hw=near + margin,
            region0_hw=lines_mod.region0_halfwidth(padded, self.grid.dw))
        # What a step reads of this molecule goes to the device now, once,
        # so that a captured step copies nothing from the host.
        padded.tensors(self.device)
        device_constant(padded.mass_g, self.device)
        device_constant(self.grid.dw, self.device)
        tips_mod.q_inverse_layers(
            self.tips, padded.mol_id,
            torch.full((1,), constants.TREF, device=self.device),
            padded.num_iso)
        if self.method in _K1_METHODS:
            self.chunk_ranges[catalog.mol_id].tables(self.device)

    def add_cfc(self, cfc_id, path: str):
        table = CrossSectionTable.from_file(int(cfc_id), path, self.grid,
                                            self.device)
        self.cfcs[int(cfc_id)] = table

    def add_cia(self, species1, species2, path: str):
        # The pressure-squared column factor (~7.9e46 [K atm-2 cm-5]) is
        # folded into the stored table in f64: neither it nor real CIA
        # sigma (~1e-44 cm^5) fits f32, but the product does.
        table = CrossSectionTable.from_file(
            int(species1), path, self.grid, self.device,
            name=f"cia_{int(species1)}_{int(species2)}",
            scale=constants.CIA_COLUMN_FACTOR)
        self.cias.append((int(species1), int(species2), table))

    # -- forward pass ------------------------------------------------------
    def check_limits(self, level_pressure_mb, level_temperature) -> None:
        """Raise ValueError for layers beyond the line_sample tables'
        limits (a no-op for the other methods).  It reads the layers'
        largest temperature and pressure on the host, so a captured step
        cannot hold it: the driver runs it on the step's
        inputs before capture or replay."""
        if self.method not in _K1_METHODS:
            return
        # The line_sample tables (near core, zones, shift margins) hold
        # only up to these limits; beyond them a sample would silently
        # take the wrong Humlicek region.
        p2, t2 = (torch.atleast_2d(torch.as_tensor(
            x, dtype=torch.float32, device=self.device))
            for x in (level_pressure_mb, level_temperature))
        pavg, tavg = cg.layer_pressures_temperatures(
            p2 * constants.MB_TO_ATM, t2)
        t_max, p_max = torch.stack([tavg.max(), pavg.max()]).tolist()
        if t_max > lines_mod.TMAX_K or p_max > lines_mod.PMAX_ATM:
            raise ValueError(
                f"layer temperature {t_max} K or pressure {p_max} atm "
                f"beyond the line_sample tables' limits "
                f"({lines_mod.TMAX_K} K, {lines_mod.PMAX_ATM} atm); "
                f'method="scatter" computes such rows')

    def optical_depth(self, level_pressure_mb, level_temperature,
                      vmr: Mapping[int, torch.Tensor],
                      cfc_vmr: Mapping[int, torch.Tensor] | None = None,
                      cia_vmr: Mapping[int, torch.Tensor] | None = None,
                      block_start: int | None = None,
                      block_size: int | None = None,
                      check: bool = True) -> torch.Tensor:
        """Gas optical depth (..., nlayers, n_w).

        Args:
          level_pressure_mb: (nlevels,) or (B, nlevels) pressure [mb].
          level_temperature: same shape, temperature [K].
          vmr: molecule id -> level mole fraction (ppmv * 1e-6).
          cfc_vmr / cia_vmr: same for cross-section / CIA species.
          block_start / block_size: compute only the spectral window
            [block_start, block_start + block_size); ``block_start`` must
            be a multiple of :attr:`block_quantum`.
          check: run :meth:`check_limits` first; a captured step passes
            False, its caller having checked the inputs.
        """
        cfc_vmr = cfc_vmr or {}
        cia_vmr = cia_vmr or {}
        f32 = torch.float32

        def lev(x):
            """Level-quantity input -> (B, nlev) f32 on the device."""
            return torch.atleast_2d(torch.as_tensor(x, dtype=f32,
                                                    device=self.device))

        p_in = torch.as_tensor(level_pressure_mb, dtype=f32,
                               device=self.device)
        batched = p_in.ndim == 2
        p2 = torch.atleast_2d(p_in) * constants.MB_TO_ATM   # [atm]
        t2 = lev(level_temperature)
        B, nlev = p2.shape
        nlayers = nlev - 1
        rows = B * nlayers

        n2d = cg.number_densities(p2)
        pavg2, tavg2 = cg.layer_pressures_temperatures(p2, t2)
        pavg, tavg = pavg2.reshape(rows), tavg2.reshape(rows)

        start = 0 if block_start is None else int(block_start)
        nw = self.grid.n if block_size is None else int(block_size)
        if not (0 <= start < self.grid.n and start % self.block_quantum == 0):
            raise ValueError(
                f"block_start {start} must be a multiple of "
                f"{self.block_quantum} inside the grid [0, {self.grid.n})")

        def spectral(table):
            """Slice a (n_w,) grid table to the active window."""
            if block_start is None and block_size is None:
                return table
            n = table.shape[-1]
            padded = F.pad(table, (0, -(-n // nw) * nw - n))
            return padded[start:start + nw]

        if check:
            self.check_limits(level_pressure_mb, level_temperature)
        tau = torch.zeros((rows, nw), dtype=f32, device=self.device)
        bin_method = self.method in _BIN_METHODS
        if bin_method:
            # The block is a whole number of bin groups and needs nothing
            # outside itself: every fine point and coarse triple of its
            # bins receives all its line contributions here.
            ppb = self.bins.ppb
            if nw % self.block_quantum and block_size is not None:
                raise ValueError(
                    f"bin-method block_size {nw} must be a multiple of "
                    f"block_quantum {self.block_quantum}")
            start_bin = start // ppb
            nbins = -(-nw // ppb)
            tau_bins = torch.zeros((rows, nbins * ppb), dtype=f32,
                                   device=self.device)
            bins_tau = torch.zeros((rows, nbins, bins_mod.NIP), dtype=f32,
                                   device=self.device)
        for mol_id, bound in self.molecules.items():
            x = lev(vmr[mol_id])
            psavg2, ns2 = cg.partial_pressures_and_densities(p2, x, n2d)
            psavg, ns = psavg2.reshape(rows), ns2.reshape(rows)
            lo, hi, ranges = 0, bound.num_lines, None
            if bin_method:        # only the lines the block's bins read
                lo, hi, ranges = self._line_window(mol_id, start_bin, nbins)
            self.line_prep.add(hi - lo, bound.num_lines)
            with metrics.layer(metrics.LINE_PREP):
                prep = lines_mod.prepare(
                    bound, self.grid, pavg, tavg, psavg, tips=self.tips,
                    window=(lo, hi) if bin_method else None)
            with metrics.layer(metrics.VOIGT):
                if bin_method:
                    accumulate_bins_kernel(
                        prep, ns, ranges, self.bins, start_bin=start_bin,
                        nbins=nbins, tau0=tau_bins, bins_tau0=bins_tau)
                elif self.method == "scatter":
                    optical_depth_line_sample(
                        prep, ns, self.grid, cutoff=self.wcutoff,
                        chunk=self.line_chunk, tau0=tau, start=start,
                        block=None if block_size is None else nw)
                else:
                    accumulate_voigt(prep, ns, self.chunk_ranges[mol_id],
                                     num_wpoints=nw, dw=float(self.grid.dw),
                                     fsteps=self._fsteps,
                                     near=self.near_steps[mol_id],
                                     num_global=self.grid.n, tau0=tau,
                                     start=start)
            del prep
            if mol_id == int(MoleculeId.H2O) and self.h2o_ctm is not None:
                ctm = self.h2o_ctm
                with metrics.layer(metrics.ABSORBERS):
                    tau += ctm.optical_depth(ns, pavg, tavg, psavg,
                                             cs=spectral(ctm.cs),
                                             cf=spectral(ctm.cf),
                                             t0s=spectral(ctm.t0s),
                                             t0f=spectral(ctm.t0f))
            elif mol_id == int(MoleculeId.O3) and self.o3_ctm is not None:
                with metrics.layer(metrics.ABSORBERS):
                    tau += ns[:, None] * \
                        spectral(self.o3_ctm.cross_section)[None, :]

        if self.cfcs or self.cias:
            with metrics.layer(metrics.ABSORBERS):
                for cfc_id, table in self.cfcs.items():
                    tau += cfc_optical_depth(
                        table, n2d, lev(cfc_vmr[cfc_id]),
                        xs=spectral(table.cross_section)).reshape(rows, nw)
                for s1, s2, table in self.cias:
                    # Column factor pre-folded into the table (add_cia).
                    tau += cia_optical_depth(
                        table, p2, tavg2, lev(cia_vmr[s1]),
                        lev(cia_vmr[s2]),
                        xs=spectral(table.cross_section)).reshape(rows, nw)

        if bin_method:
            # The coarse wings interpolate onto the fine grid after ALL
            # absorbers (launch.c:211-218), each bin from its own triple.
            with metrics.layer(metrics.BIN_INTERP):
                bl = torch.arange(start_bin, start_bin + nbins,
                                  device=self.device) * ppb
                bins_mod.interpolate_bins(
                    bins_tau, bl, self._block_w_rel(start_bin, nbins),
                    ppb=ppb, last_ppb=self.bins.last_ppb,
                    do_interp=self.bins.do_interp,
                    do_last_interp=self.bins.do_last_interp,
                    num_wpoints=nbins * ppb, tau=tau_bins, bin0=start_bin,
                    last_bin=self.bins.n - 1)
                del bins_tau
                tau += tau_bins[:, :nw]
            del tau_bins

        tau = tau.reshape(B, nlayers, nw)
        return tau if batched else tau[0]
