"""The radiation driver: batched sky-tier fluxes (port of
grtcode_tpu/framework/driver.py).

Sky tiers, as in the JAX package:

  CSAF  clear-sky aerosol-free: gas + Rayleigh
  CS    clear-sky with Angstrom aerosols
  AF    all-sky aerosol-free: + stochastic clouds, fluxes averaged over
        ``num_subcolumns`` subcolumns

Each band's gas optical depth is computed once per spectral block (one
kernel launch per molecule) and shared by every tier.  The longwave pass
always runs; the shortwave pass runs only for lit columns (cos zenith > 0):
a mixed batch is split into its lit and night columns (day compaction), the
night ones take the longwave-only step, and both are scattered back.  With
``spectral_chunks=S > 1`` each band is streamed through S spectral blocks
one after the other, so a production resolution never holds a band-wide
tau; ``column_chunk`` bounds the columns held at once.

As the JAX package jits each step once per key and replays it, a step on
a CUDA device runs eagerly at the first call of its key (the warm-up), is
captured as a CUDA graph at the second and is replayed after that
(:mod:`..utils.graphs`): the key is JAX's (the sky tiers, the output
form, LW only or both bands, the spectral blocks, the solver and the
cloud settings) plus the inputs' shapes, which name the bucket.  A run
called once, as by the apps, holds no graph;
:meth:`RadiationDriver.clear_cache` gives a driver's graphs back.  Day
compaction pads the lit and the night columns to power-of-two buckets,
as JAX does, so a new lit count in the same bucket replays the same
graph.  On the CPU, and on the card under
:func:`..utils.debug.disable_jit`, the step runs eagerly.

Tracing (:mod:`..utils.metrics`): the driver's host work runs under the
spans ``grtcode::run``, ``inputs``, ``surface_spectra``,
``check_limits``, ``gather``, ``scatter`` and the step cache's
``step_eager``, ``step_capture`` and ``step_replay``; the step's body
under the device layers, ``grtcode::step`` around them all.
:meth:`RadiationDriver.step_stats` reads the step cache's counts, the
layers' device time in replays, the gas optics' line-prep counts and the
DISORT solver's doubling counts.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .. import constants
from ..gas_optics.gas_optics import GasOptics
from ..optics import Optics, combine
from ..solvers.disort import disort_shortwave
from ..solvers.longwave import longwave_fluxes
from ..solvers.rayleigh import rayleigh_tau
from ..solvers.shortwave import shortwave_fluxes
from ..solvers.solar_flux import SolarFlux
from ..utils import curtis_godson as cg
from ..utils import graphs, metrics, prng
from ..utils.interp import (block_trapezoid_weights, interpolate_to_grid_np,
                            trapezoid_uniform)
from .atmosphere import Atmosphere

DIFFUSE_MU = 0.5  # cosine of the diffuse angle


@dataclasses.dataclass
class FluxResults:
    """Per-tier fluxes: {"csaf"|"cs"|"af" -> {"rlu"|"rld"|"rsu"|"rsd" ->
    (B, nlevels) integrated [W m-2] or (B, nlevels, nw) spectral tensors on
    the driver's device}}."""

    tiers: dict
    integrated: bool

    _TIER_SUFFIX = {"CSAF": "csaf", "CS": "cs", "AF": "af"}

    def variable(self, name: str) -> np.ndarray:
        """A reference-named variable as numpy, e.g. RLUTCSAF: TOA upwelling
        LW clear-sky aerosol-free, shape (B,)."""
        m = name.upper()
        band = {"L": "l", "S": "s"}[m[1]]
        direction = {"U": "u", "D": "d"}[m[2]]
        rest = m[3:]
        level = None
        if rest.startswith("T"):
            level, rest = 0, rest[1:]
        elif rest.startswith("S") and rest not in ("CS", "CSAF"):
            level, rest = -1, rest[1:]
        if rest not in self._TIER_SUFFIX:
            # Unsuffixed names (RLU, RSDT, ...) are the full-sky (aerosols
            # + clouds) slots, which the driver does not compute.
            raise KeyError(
                f"{name}: no '{rest}' sky tier — the driver produces "
                "CSAF/CS/AF variables only")
        data = self.tiers[self._TIER_SUFFIX[rest]][f"r{band}{direction}"]
        return (data[:, level] if level is not None else data).cpu().numpy()

    def host(self) -> dict:
        """The tiers as numpy arrays on the host (for the file writers)."""
        return {t: {k: v.cpu().numpy() for k, v in fx.items()}
                for t, fx in self.tiers.items()}


def bucket_pad(idx: np.ndarray, batch: int) -> np.ndarray:
    """The column indices ``idx`` padded to a power-of-two bucket by
    repeating the first, the bucket capped at ``batch`` (the JAX driver's
    rule), so a step is captured per bucket size, not per count."""
    b = 1
    while b < idx.size:
        b *= 2
    b = min(b, batch)
    return np.concatenate([idx, np.repeat(idx[:1], b - idx.size)])


def _take(tree, idx):
    """Rows ``idx`` (a device index tensor) of every tensor in a nested
    dict."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _take(v, idx) for k, v in tree.items()}
    return tree.index_select(0, idx)


def _mesh_all_gather(mesh, axis: str, tensor):
    """``tensor`` from every rank of this rank's line along mesh dimension
    ``axis``, in mesh order.  A gloo group gathers through the host, so
    CUDA tensors work on either backend."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    t = tensor.contiguous()
    if t.is_cuda and dist.get_backend(group) == "gloo":
        t = t.cpu()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    by_rank = dict(zip(dist.get_process_group_ranks(group), parts))
    dim = mesh.mesh_dim_names.index(axis)
    coord = list(mesh.get_coordinate())
    line = []
    for i in range(mesh.size(dim)):
        coord[dim] = i
        line.append(int(mesh.mesh[tuple(coord)]))
    return [by_rank[r].to(tensor.device) for r in line]


@dataclasses.dataclass
class RadiationDriver:
    """Holds the per-band gas optics, the solar spectrum and the cloud
    optics, and runs the sky tiers on the gas optics' device.

    ``cloud_optics`` is the all-sky tier's callback, ``(cloud_args, key,
    w_lw, w_sw) -> (liq_lw, ice_lw, liq_sw, ice_sw)`` Optics with (B,
    nlayers, nw) fields (``CloudOpticsLib.driver_callback()`` makes one);
    ``key`` is a (2,) :mod:`..utils.prng` key, one per subcolumn.
    ``sw_solver="disort"`` runs the shortwave of every tier through the
    ``disort_streams``-stream discrete-ordinates solver
    (:func:`..solvers.disort.disort_shortwave`) instead of the two-stream
    one.
    """

    lw_gas: GasOptics
    sw_gas: GasOptics | None = None
    solar: SolarFlux | None = None
    cloud_optics: Callable | None = None
    num_subcolumns: int = 1
    cloud_seed: int = 0
    sw_solver: str = "two_stream"
    disort_streams: int = 16
    device: torch.device = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.device = self.lw_gas.device
        # Captured steps by key in one memory pool (the JAX driver's
        # ``_step_cache``), and the subcolumn keys by seed.
        self._step_cache = graphs.StepCache()
        self._keys = {}
        self._doublings = None      # DISORT's, made at its first step

    def clear_cache(self) -> None:
        """Drop the driver's captured steps and give their memory back to
        the card (``jax.clear_caches()``): each key's next call runs
        eagerly again, and the one after captures it."""
        self._step_cache.clear()

    def step_stats(self) -> dict:
        """The step cache's counts since the driver was made: ``eager``
        (steps run op by op: a key's warm-up, every step on the CPU or
        under ``disable_jit``), ``captures``, ``replays`` and ``dropped``
        (graphs given back when a step ran out of memory); and the layers'
        device time in the replays made inside
        :func:`..utils.metrics.layer_times` blocks: ``layer_ms`` by layer
        name summed over the ``timed`` replays, and the ``untimed`` ones;
        and ``line_prep``, the lines the bands' line prep prepped against
        the catalog lines they stand for (each ``GasOptics.line_prep``,
        which counts every caller of that gas optics); and ``disort``, the
        discrete-ordinates solver's doubling steps that the layers'
        optical depths need against the steps it ran, over every step and
        replay (:class:`..utils.metrics.DoublingCounts`; reading them
        synchronises with the device).  A copy: two readings differ by
        what ran between them."""
        gases = {id(g): g for g in (self.lw_gas, self.sw_gas)
                 if g is not None}.values()
        return dict(self._step_cache.stats(), line_prep={
            k: sum(getattr(g.line_prep, k) for g in gases)
            for k in ("prepped", "catalog")},
            disort=self._doublings.read() if self._doublings is not None
            else {"needed": 0, "run": 0})

    def _surface_spectra(self, atm: Atmosphere):
        """Emissivity / albedo on the solver grids (linear interpolation,
        constant extrapolation), all columns at once."""
        with metrics.span(metrics.SURFACE_SPECTRA):
            B = atm.batch
            if atm.emissivity is not None:
                emis = interpolate_to_grid_np(
                    self.lw_gas.grid, atm.emissivity_grid,
                    np.asarray(atm.emissivity, np.float64),
                    extrapolate="constant")
            else:
                emis = np.ones((B, self.lw_gas.grid.n))
            albedo = None
            if self.sw_gas is not None:
                if atm.albedo is not None:
                    albedo = interpolate_to_grid_np(
                        self.sw_gas.grid, atm.albedo_grid,
                        np.asarray(atm.albedo, np.float64),
                        extrapolate="constant")
                else:
                    albedo = np.zeros((B, self.sw_gas.grid.n))
            return emis, albedo

    def run(self, atm: Atmosphere, integrated: bool = True, mesh=None,
            column_chunk: int | None = None, col_index=None,
            spectral_chunks: int | None = None) -> FluxResults:
        """Every sky tier the atmosphere asks for: ``csaf`` always, ``cs``
        unless ``atm.clean``, ``af`` unless ``atm.clear``.

        ``integrated=False`` returns (B, nlevels, nw) spectra.
        ``column_chunk`` runs the batch in slices of that many columns and
        concatenates them on the device.  ``col_index`` gives each column's
        global id (``arange(B)`` by default), which keys its cloud
        subcolumns, so a chunked, compacted or sharded run draws the same
        clouds as the whole batch.  ``spectral_chunks`` streams each band
        through that many blocks: ``ceil(n / S)`` rounded up to the band's
        ``block_quantum``, each reduced with its exact trapezoid weights
        (integrated output only).  ``mesh`` (a (columns x spectral)
        DeviceMesh, :func:`..parallel.mesh.make_mesh`) runs this rank's
        column shard and spectral block and gathers the whole batch on
        every rank (:meth:`_run_mesh`).
        """
        with metrics.span(metrics.RUN):
            ids = (np.arange(atm.batch) if col_index is None
                   else np.asarray(col_index))
            col, cloud_args = self._inputs(atm, ids)
            return self._run_columns(
                col, atm.cos_zenith, cloud_args, clean=atm.clean,
                clear=atm.clear, integrated=integrated, mesh=mesh,
                column_chunk=column_chunk, spectral_chunks=spectral_chunks)

    def run_columns(self, col: dict, mu=None, cloud_args: dict | None = None,
                    *, clean: bool = True, clear: bool = True,
                    integrated: bool = True, mesh=None,
                    column_chunk: int | None = None,
                    spectral_chunks: int | None = None) -> FluxResults:
        """:meth:`run` on a batch already on the device.

        ``col`` holds (B, ...) float32 tensors: "p_lev", "t_lev" [mb, K]
        (B, nlevels); "t_lay" (B, nlayers); "t_surf" (B,); "emis" (B,
        nw_lw); "vmr_lw", "cfc_vmr", "cia_vmr" {species id: (B, nlevels)};
        with a shortwave band also "mu", "tsi" (B,), "albedo" (B, nw_sw),
        "vmr_sw", and optionally "albedo_dif" (the diffuse beam's albedo,
        "albedo" when absent); unless ``clean`` the aerosol fields of
        :meth:`_inputs`.  ``mu`` is the cosine of the zenith angle as host
        numpy (B,) (None: no shortwave); ``cloud_args`` the all-sky state
        (needed unless ``clear``).
        """
        with metrics.span(metrics.RUN):
            return self._run_columns(
                col, mu, cloud_args, clean=clean, clear=clear,
                integrated=integrated, mesh=mesh, column_chunk=column_chunk,
                spectral_chunks=spectral_chunks)

    def _run_columns(self, col, mu, cloud_args, *, clean, clear, integrated,
                     mesh, column_chunk, spectral_chunks) -> FluxResults:
        if self.sw_solver not in ("two_stream", "disort"):
            raise ValueError(f"sw_solver={self.sw_solver!r}: expected "
                             "'two_stream' or 'disort'")
        S = 1 if spectral_chunks is None else int(spectral_chunks)
        if S < 1:
            raise ValueError(
                f"spectral_chunks must be >= 1, got {spectral_chunks}")
        if S > 1 and (mesh is not None or not integrated):
            raise ValueError("spectral_chunks streams serially on one "
                             "device with integrated output (use a mesh "
                             "for sharded or spectrally-resolved runs)")
        if not clear and (self.cloud_optics is None or cloud_args is None):
            raise ValueError("cloudy atmosphere but no cloud_optics")
        batch = col["t_lev"].shape[0]
        mu = None if mu is None else np.asarray(mu, np.float64)
        state = (col, cloud_args, mu)
        flags = dict(clean=clean, clear=clear, integrated=integrated,
                     column_chunk=column_chunk)
        if mesh is not None:
            tiers = self._run_mesh(state, batch, mesh, **flags)
        else:
            tiers = self._run_rows(state, np.arange(batch), S=S, **flags)
        return FluxResults(tiers=tiers, integrated=integrated)

    def _run_rows(self, state, rows, clean, clear, integrated, column_chunk,
                  S, block=None):
        """The tiers of the batch's columns ``rows`` (``state`` is the
        whole batch's (col, cloud_args, mu)): in slices of
        ``column_chunk`` columns, with day compaction, summed over the S
        spectral blocks of each band, or only block ``block`` of them (a
        mesh rank's)."""
        if column_chunk is not None and rows.size > column_chunk:
            parts = [self._run_rows(state, rows[lo:lo + column_chunk],
                                    clean, clear, integrated, None, S, block)
                     for lo in range(0, rows.size, column_chunk)]
            return {t: {k: torch.cat([r[t][k] for r in parts])
                        for k in parts[0][t]}
                    for t in parts[0]}

        dev = self.device
        mu = None if state[2] is None else state[2][rows]
        with_sw = (self.sw_gas is not None and mu is not None
                   and bool(np.any(mu > 0.0)))
        step = dict(clean=clean, clear=clear, integrated=integrated, S=S,
                    block=block)
        lit = night = None
        if with_sw and not np.all(mu > 0.0):
            lit = np.flatnonzero(mu > 0.0)
            night = np.flatnonzero(~(mu > 0.0))
            if bucket_pad(lit, rows.size).size >= rows.size:
                # The lit bucket is the whole batch: compaction would save
                # no SW work and add a night step, so the full batch runs
                # with the day mask instead (as in JAX).
                lit = night = None
        with metrics.span(metrics.GATHER):
            idx = torch.as_tensor(rows, device=dev)
            col, cloud_args = (_take(tree, idx) for tree in state[:2])
            if lit is not None:
                # Day compaction: the lit columns run LW + SW, the night
                # ones LW only, each padded to its bucket, and both
                # scatter back.
                lit_p, night_p = (torch.as_tensor(bucket_pad(i, rows.size),
                                                  device=dev)
                                  for i in (lit, night))
                lit_in, night_in = ((_take(col, p), _take(cloud_args, p))
                                    for p in (lit_p, night_p))
        if lit is None:
            return self._step(col, cloud_args, with_sw=with_sw, **step)
        out_lit = self._step(*lit_in, with_sw=True, **step)
        out_night = self._step(*night_in, with_sw=False, **step)
        with metrics.span(metrics.SCATTER):
            lit, night = (torch.as_tensor(i, device=dev)
                          for i in (lit, night))
            out = {}
            for t, fluxes in out_lit.items():
                out[t] = {}
                for k, a_lit in fluxes.items():
                    full = torch.zeros((rows.size,) + a_lit.shape[1:],
                                       dtype=a_lit.dtype, device=dev)
                    full[lit] = a_lit[:lit.numel()]
                    full[night] = out_night[t][k][:night.numel()]
                    out[t][k] = full
        return out

    def _run_mesh(self, state, batch, mesh, clean, clear, integrated,
                  column_chunk):
        """A mesh run as the JAX package's shard_map step computes it.

        The rank at mesh coordinate (c, s) takes column shard c of the
        batch (padded to a multiple of the columns axis by repeating its
        first column, then split evenly) and spectral block s of each band
        (the blocks of ``run(spectral_chunks=S)``), and runs day compaction
        and the tiers on them as an unmeshed run does.  The S per-block
        integrals are gathered over the spectral axis and summed in block
        order, as the streamed run adds them, so a (1 x S) mesh is
        bit-identical to ``run(spectral_chunks=S)`` (an all_reduce would
        sum in the backend's order); spectral blocks are gathered along
        the wavenumber axis and trimmed to the band.  The column shards
        are gathered and trimmed, so every rank returns the whole batch.
        """
        from ..parallel.mesh import COLUMNS_AXIS, SPECTRAL_AXIS

        C, S = (mesh.size(mesh.mesh_dim_names.index(a))
                for a in (COLUMNS_AXIS, SPECTRAL_AXIS))
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        padded = np.concatenate([np.arange(batch),
                                 np.zeros((-batch) % C, np.int64)])
        per = padded.size // C
        c = coord[COLUMNS_AXIS]
        tiers = self._run_rows(state, padded[c * per:(c + 1) * per], clean,
                               clear, integrated, column_chunk, S,
                               block=coord[SPECTRAL_AXIS])
        nw_lw = self.lw_gas.grid.n
        nw_sw = self.sw_gas.grid.n if self.sw_gas is not None else nw_lw
        out = {}
        for t, fluxes in tiers.items():
            out[t] = {}
            for k, v in fluxes.items():
                if S > 1:
                    blocks = _mesh_all_gather(mesh, SPECTRAL_AXIS, v)
                    if integrated:
                        v = blocks[0]
                        for b in blocks[1:]:
                            v = v + b
                    else:
                        v = torch.cat(blocks, -1)[
                            ..., :nw_lw if k in ("rlu", "rld") else nw_sw]
                if C > 1:
                    v = torch.cat(_mesh_all_gather(mesh, COLUMNS_AXIS,
                                                   v))[:batch]
                out[t][k] = v
        return out

    def _inputs(self, atm: Atmosphere, ids):
        """The batch's device tensors: the column state, and the cloud
        state with the columns' global ids (None for a clear sky)."""
        with metrics.span(metrics.INPUTS):
            dev = self.device

            def t(a):
                return torch.as_tensor(np.array(a, np.float64),
                                       dtype=torch.float32, device=dev)

            def vmr(ppmv, keep=None):
                return {k: t(np.asarray(v, np.float64) * 1e-6)
                        for k, v in ppmv.items() if keep is None or k in keep}

            emis, albedo = self._surface_spectra(atm)
            col = {
                "p_lev": t(atm.level_pressure),
                "t_lev": t(atm.level_temperature),
                "t_lay": t(atm.layer_temperature),
                "t_surf": t(atm.surface_temperature),
                "emis": t(emis),
                "vmr_lw": vmr(atm.ppmv, self.lw_gas.molecules),
                "cfc_vmr": vmr(atm.cfc_ppmv),
                "cia_vmr": vmr(atm.cia_ppmv),
            }
            if self.sw_gas is not None:
                col.update({
                    "mu": t(atm.cos_zenith if atm.cos_zenith is not None
                            else -np.ones(atm.batch)),
                    "tsi": t(atm.total_solar_irradiance
                             if atm.total_solar_irradiance is not None
                             else np.zeros(atm.batch)),
                    "albedo": t(albedo),
                    "vmr_sw": vmr(atm.ppmv, self.sw_gas.molecules),
                })
            if not atm.clean:
                col.update({
                    "aero_tau1um": t(atm.aerosol_optical_depth_1um),
                    "aero_alpha": t(np.broadcast_to(
                        np.asarray(atm.aerosol_angstrom_exponent, np.float64),
                        (atm.batch,))),
                    "aero_omega": t(atm.aerosol_single_scatter_albedo),
                    "aero_g": t(atm.aerosol_asymmetry_factor),
                })
            cloud_args = None
            if not atm.clear:
                p = np.asarray(atm.level_pressure, np.float64)
                cloud_args = {
                    "col_index": torch.as_tensor(np.asarray(ids, np.int64),
                                                 device=dev),
                    "cloud_fraction": t(atm.cloud_fraction),
                    "liquid_water_content": t(atm.liquid_water_content),
                    "ice_water_content": t(atm.ice_water_content),
                    "layer_thickness": t(atm.layer_thickness),
                    "layer_pressure": t(0.5 * (p[:, :-1] + p[:, 1:])),
                    "t_lay": t(atm.layer_temperature),
                }
            return col, cloud_args

    @staticmethod
    def _blocks(gas, S):
        """(block size, block starts) of a band: the whole band unstreamed,
        else ``ceil(n / S)`` rounded up to the band's block quantum."""
        n = gas.grid.n
        if S == 1:
            return n, [0]
        q = gas.block_quantum
        size = -(-(-(-n // S)) // q) * q
        return size, [s * size for s in range(S)]

    def _subcolumn_keys(self):
        """The (num_subcolumns, 2) cloud keys of ``cloud_seed``, built
        once per seed and count."""
        key = (self.cloud_seed, self.num_subcolumns)
        if key not in self._keys:
            self._keys[key] = prng.split(
                prng.prng_key(self.cloud_seed, self.device),
                self.num_subcolumns)
        return self._keys[key]

    def _step(self, col, cloud_args, clean: bool, clear: bool,
              integrated: bool, with_sw: bool, S: int, block=None):
        """Every tier on one batch, summed over its S spectral blocks, or
        on block ``block`` alone.  ``with_sw=False`` is the longwave-only
        step of night columns: its shortwave fluxes are zeros (shaped as
        the SW band's block spectra in spectral output).

        On a CUDA device the step is the captured graph of its key (JAX's
        ``_step_cache``): eager at its first call, captured at the second
        and replayed after that; on the CPU or under
        :func:`..utils.debug.disable_jit` it runs eagerly.  The line_sample limits are checked on the inputs first.
        """
        gases = (self.lw_gas,) + ((self.sw_gas,) if with_sw else ())
        with metrics.span(metrics.CHECK_LIMITS):
            for gas in {g.method: g for g in gases}.values():  # per method
                gas.check_limits(col["p_lev"], col["t_lev"])
        keys = None if clear else self._subcolumn_keys()
        if with_sw and self.sw_solver == "disort" and self._doublings is None:
            # Made outside the step, so that no capture allocates it.
            self._doublings = metrics.DoublingCounts(self.device)

        def body(inputs):
            with metrics.layer(metrics.STEP):
                return self._step_body(*inputs, keys, clean, clear,
                                       integrated, with_sw, S, block)

        key = (clean, clear, integrated, with_sw, S, block, self.sw_solver,
               self.disort_streams, self.num_subcolumns, self.cloud_seed,
               self.cloud_optics)
        return self._step_cache(
            key, body, (col, cloud_args),
            label=f"driver step (clean={clean}, clear={clear}, "
                  f"integrated={integrated}, with_sw={with_sw}, "
                  f"spectral_chunks={S}, block={block}, "
                  f"{col['t_lev'].shape[0]} columns)")

    def _step_body(self, col, cloud_args, keys, clean, clear, integrated,
                   with_sw, S, block):
        """:meth:`_step`'s computation: what a graph captures."""
        pad = torch.nn.functional.pad
        size_lw, starts_lw = self._blocks(self.lw_gas, S)
        col = dict(col, emis=pad(col["emis"],
                                 (0, size_lw * S - col["emis"].shape[-1])))
        size_sw, starts_sw, sol = None, [None] * S, None
        if with_sw:
            size_sw, starts_sw = self._blocks(self.sw_gas, S)
            for k in ("albedo", "albedo_dif"):
                if k in col:
                    col[k] = pad(col[k], (0, size_sw * S - col[k].shape[-1]))
            sol = self.solar.incident_flux
            sol = pad(sol, (0, size_sw * S - sol.shape[-1]))
        starts = list(zip(starts_lw, starts_sw))
        if block is not None:
            starts = starts[block:block + 1]
        total = None
        for start_lw, start_sw in starts:
            block = self._core(col, cloud_args, keys, clean, clear,
                               integrated, S, start_lw, size_lw, start_sw,
                               size_sw, sol)
            if total is None:
                total = block
                continue
            with metrics.layer(metrics.INTEGRALS):
                total = {t: {k: total[t][k] + v for k, v in fx.items()}
                         for t, fx in block.items()}
        return total

    def _core(self, col, cloud_args, keys, clean, clear, integrated, S,
              start_lw, size_lw, start_sw, size_sw, sol):
        """Every tier on the spectral block [start, start + size) of each
        band (the whole band unstreamed); ``start_sw`` None runs the
        longwave only."""
        dev = self.device
        lwg = self.lw_gas.grid
        with_sw = start_sw is not None

        def reduce(fx, grid, start, size):
            if not integrated:
                return fx
            if S == 1:
                return trapezoid_uniform(fx, grid.dw)
            return (fx * block_trapezoid_weights(start, size, grid.n,
                                                 grid.dw, dev)).sum(-1)

        def window(start, size):
            return {} if S == 1 else dict(block_start=start, block_size=size)

        w_lw = lwg.wavenumbers(dev, start_lw, size_lw)
        emis = col["emis"][:, start_lw:start_lw + size_lw]
        tau_lw = self.lw_gas.optical_depth(
            col["p_lev"], col["t_lev"], col["vmr_lw"],
            cfc_vmr=col["cfc_vmr"], cia_vmr=col["cia_vmr"], check=False,
            **window(start_lw, size_lw))
        gas_lw = Optics.from_tau(tau_lw)
        del tau_lw

        w_sw = gasray_sw = None
        if with_sw:
            swg = self.sw_gas.grid
            w_sw = swg.wavenumbers(dev, start_sw, size_sw)
            albedo = col["albedo"][:, start_sw:start_sw + size_sw]
            albedo_dif = col.get("albedo_dif", col["albedo"])[
                :, start_sw:start_sw + size_sw]
            sol_block = sol[start_sw:start_sw + size_sw]
            mu = torch.clamp(col["mu"], min=1e-6)
            tau_sw = self.sw_gas.optical_depth(
                col["p_lev"], col["t_lev"], col["vmr_sw"],
                cfc_vmr=col["cfc_vmr"], cia_vmr=col["cia_vmr"], check=False,
                **window(start_sw, size_sw))
            with metrics.layer(metrics.SW):
                ray = rayleigh_tau(cg.number_densities(
                    col["p_lev"] * constants.MB_TO_ATM), w_sw)
                gasray_sw = combine([
                    Optics.from_tau(tau_sw),
                    Optics(ray, torch.ones_like(ray), torch.zeros_like(ray))])
            del tau_sw, ray

        def both(opt_lw, opt_sw):
            with metrics.layer(metrics.LW_SOLVER):
                flu, fld = longwave_fluxes(opt_lw.tau, opt_lw.omega,
                                           col["t_surf"], col["t_lay"],
                                           col["t_lev"], emis, w_lw)
            with metrics.layer(metrics.INTEGRALS):
                out = {"rlu": reduce(flu, lwg, start_lw, size_lw),
                       "rld": reduce(fld, lwg, start_lw, size_lw)}
            del flu, fld
            if with_sw and self.sw_solver == "disort":
                # The reference's --enable-disort swap: the discrete-
                # ordinates solver in place of the two-stream one, on the
                # same lit columns.
                with metrics.layer(metrics.DISORT):
                    fsu, fsd = disort_shortwave(
                        opt_sw.tau, opt_sw.omega, opt_sw.g, mu, albedo,
                        col["tsi"], sol_block, nstr=self.disort_streams,
                        doublings=self._doublings)
            elif with_sw:
                with metrics.layer(metrics.SW):
                    fsu, fsd = shortwave_fluxes(
                        opt_sw.tau, opt_sw.omega, opt_sw.g, mu,
                        torch.full_like(mu, DIFFUSE_MU), albedo, albedo_dif,
                        col["tsi"], sol_block)
            if with_sw:
                # The day mask: a night column of a full batch gets zero
                # shortwave (mu was clamped for the solvers).
                with metrics.layer(metrics.INTEGRALS):
                    day = (col["mu"] > 0.0).to(torch.float32)[:, None]
                    day = day if integrated else day[..., None]
                    out["rsu"] = reduce(fsu, swg, start_sw, size_sw) * day
                    out["rsd"] = reduce(fsd, swg, start_sw, size_sw) * day
            else:
                # Night columns: zeros, SW-block spectra in spectral output.
                shape = out["rlu"].shape
                if self.sw_gas is not None and not integrated:
                    shape = shape[:-1] + (self._blocks(self.sw_gas, S)[0],)
                out["rsu"] = torch.zeros(shape, device=dev)
                out["rsd"] = torch.zeros(shape, device=dev)
            return out

        def aerosol_optics(w):
            """Angstrom-exponent spectral aerosol optics: tau(lambda) =
            tau_1um * lambda_um^-alpha, grey ssa and asymmetry."""
            lam_um = 1e4 / w
            tau = col["aero_tau1um"][:, :, None] * \
                lam_um[None, None, :] ** (-col["aero_alpha"][:, None, None])
            return Optics(tau, col["aero_omega"][:, :, None].expand_as(tau),
                          col["aero_g"][:, :, None].expand_as(tau))

        tiers = {"csaf": both(gas_lw, gasray_sw)}
        if not clean:
            tiers["cs"] = both(
                combine([gas_lw, aerosol_optics(w_lw)]),
                combine([gasray_sw, aerosol_optics(w_sw)]) if with_sw
                else None)
        if not clear:
            # One cloud realization per subcolumn key, the same in every
            # spectral block; fluxes averaged over the subcolumns.
            subs = []
            for key in keys:
                with metrics.layer(metrics.CLOUD_OPTICS):
                    liq_lw, ice_lw, liq_sw, ice_sw = self.cloud_optics(
                        cloud_args, key, w_lw, w_sw)
                subs.append(both(
                    combine([gas_lw, liq_lw, ice_lw]),
                    combine([gasray_sw, liq_sw, ice_sw]) if with_sw
                    else None))
                del liq_lw, ice_lw, liq_sw, ice_sw
            tiers["af"] = subs[0] if len(subs) == 1 else {
                k: torch.stack([s[k] for s in subs]).mean(0)
                for k in subs[0]}
        return tiers
