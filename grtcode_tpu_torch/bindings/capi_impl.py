"""Python half of the C ABI (port of grtcode_tpu/bindings/capi_impl.py).

The C++ shim (``native/grtcode_tpu_c.cpp``, the ABI of
``native/grtcode_tpu_c.h``, built by :mod:`..bindings` with this module's
name) embeds CPython and calls the functions in this module.  Opaque reference structs (Device_t, SpectralGrid_t, Optics_t,
GasOptics_t, SolarFlux_t — fortran-bindings/malloc_structs.c:40-67)
become integer handles into a process-global registry; buffers cross the
boundary as writable memoryviews wrapped with ``np.frombuffer``.

The API mirrors the reference F90 wrappers (fortran-bindings/
grtcode_fortran.F90:585-893): device / spectral grid / optics / solar
flux / gas optics / rayleigh, plus the LW/SW flux entry points the
reference only exposes from C.  Everything here is host-side
orchestration; the compute runs in the port's PyTorch pipeline (and its
CUDA kernels) on the selected device.
"""
from __future__ import annotations

import itertools
import threading

import numpy as np

# torch and the port load on the first compute call, so importing this
# module inside the embedded interpreter is fast.

_registry: dict[int, object] = {}
_next_handle = itertools.count(1)
_lock = threading.Lock()
_default_device = None  # the selected torch.device; None: current CUDA one

GRTCODE_SUCCESS = 0


def _register(obj) -> int:
    with _lock:
        h = next(_next_handle)
        _registry[h] = obj
    return h


def _get(handle: int):
    return _registry[int(handle)]


def destroy(handle: int) -> int:
    """Generic destroy_* (grtcode_fortran.F90:634,704,765)."""
    _registry.pop(int(handle), None)
    return GRTCODE_SUCCESS


def set_verbosity(level: int) -> int:
    """grt_set_verbosity (grtcode_set_verbosity, verbosity.c:28-44)."""
    from ..utils import verbosity as vb
    vb.set_verbosity(int(level))
    return GRTCODE_SUCCESS


def _f64(buf, n=None):
    a = np.frombuffer(buf, dtype=np.float64)
    return a if n is None else a[: int(n)]


# -- device (utilities/src/device.c:26-75) ---------------------------------

def _resolve_device(device_id: int):
    """id >= 0 -> cuda:id; -1 -> the host CPU (HOST_ONLY,
    utilities/src/device.h:26-34)."""
    import torch

    if device_id < 0:
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if device_id >= n:
        raise IndexError(
            f"device id {device_id} out of range ({n} devices)")
    return torch.device("cuda", device_id)


def create_device(device_id: int) -> int:
    """Device_t equivalent: resolves to a torch.device at creation time
    (create_device, utilities/src/device.c:53-75).  The first device
    created becomes the process default for all compute entry points,
    like the reference where the Device_t passed to create_gas_optics
    governs placement; use_device() switches it explicitly."""
    dev = _resolve_device(int(device_id))
    h = _register({"kind": "device", "id": int(device_id), "device": dev})
    global _default_device
    if _default_device is None:
        _default_device = dev
    return h


def use_device(handle: int) -> int:
    """Makes the device behind ``handle`` the default for subsequent compute
    calls (grt_use_device)."""
    global _default_device
    _default_device = _get(handle)["device"]
    return GRTCODE_SUCCESS


def _device():
    """The compute device: the one selected, else the current CUDA device.
    The CPU runs only when the caller selects it (``grt_create_device(-1)``);
    with no device selected and no GPU present, the call fails
    (RuntimeError: GRT_GPU_ERR)."""
    import torch

    if _default_device is not None:
        return _default_device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: select the CPU explicitly with "
                           "grt_create_device(-1)")
    return torch.device("cuda", torch.cuda.current_device())


def num_devices() -> int:
    import torch

    return torch.cuda.device_count()


def _f32(a, dev):
    import torch

    return torch.as_tensor(np.array(a, np.float64), dtype=torch.float32,
                           device=dev)


def _host(t):
    return t.cpu().numpy().astype(np.float64)


# -- spectral grid (utilities/src/spectral_grid.c:32-112) -------------------

def create_spectral_grid(w0: float, wn: float, dw: float) -> int:
    from ..spectral import SpectralGrid

    return _register(SpectralGrid(float(w0), float(wn), float(dw)))


def spectral_grid_properties(handle: int, out) -> int:
    """Writes [w0, n, dw] into a 3-double buffer (f_spectral_grid_properties,
    grtcode_fortran.F90:657-665)."""
    g = _get(handle)
    o = _f64(out, 3)
    o[0], o[1], o[2] = g.w0, float(g.n), g.dw
    return GRTCODE_SUCCESS


# -- optics container (utilities/src/optics.c:84-357) -----------------------

def create_optics(num_layers: int, grid_handle: int) -> int:
    grid = _get(grid_handle)
    return _register({
        "kind": "optics", "grid": grid, "nlayers": int(num_layers),
        "tau": np.zeros((int(num_layers), grid.n)),
        "omega": np.zeros((int(num_layers), grid.n)),
        "g": np.zeros((int(num_layers), grid.n)),
    })


def optics_size(handle: int) -> int:
    """Element count of each optics array (layers x wavenumbers) — lets the
    C shim size memoryviews without duplicating shape logic."""
    return int(_get(handle)["tau"].size)


def optics_levels_size(handle: int) -> int:
    """Element count of a per-level flux array ((layers+1) x wavenumbers)."""
    o = _get(handle)
    return int((o["nlayers"] + 1) * o["grid"].n)


def optics_num_wavenumbers(handle: int) -> int:
    return int(_get(handle)["grid"].n)


def optics_properties(handle: int, tau_out, omega_out, g_out) -> int:
    o = _get(handle)
    n = o["tau"].size
    _f64(tau_out, n)[:] = o["tau"].ravel()
    _f64(omega_out, n)[:] = o["omega"].ravel()
    _f64(g_out, n)[:] = o["g"].ravel()
    return GRTCODE_SUCCESS


def add_optics(result_handle: int, handles) -> int:
    """Weighted combine (add_optics_objects, optics.c:128-148) of the optics
    objects named by ``handles`` (int64 buffer) into ``result_handle``."""
    from ..optics import Optics, combine

    dev = _device()
    hs = np.frombuffer(handles, dtype=np.int64)
    parts = [_get(int(h)) for h in hs]
    combined = combine([Optics(_f32(p["tau"], dev), _f32(p["omega"], dev),
                               _f32(p["g"], dev)) for p in parts])
    res = _get(result_handle)
    res["tau"] = _host(combined.tau)
    res["omega"] = _host(combined.omega)
    res["g"] = _host(combined.g)
    return GRTCODE_SUCCESS


# -- solar flux (shortwave/src/solar_flux.c:27-99) ---------------------------

def create_solar_flux(grid_handle: int, path: str) -> int:
    from ..solvers.solar_flux import SolarFlux

    return _register(SolarFlux.from_csv(path, _get(grid_handle), "cpu"))


def solar_flux_size(handle: int) -> int:
    return int(_get(handle).grid.n)


def solar_flux_properties(handle: int, out) -> int:
    sf = _get(handle)
    flux = _host(sf.incident_flux)
    _f64(out, flux.size)[:] = flux
    return GRTCODE_SUCCESS


# -- gas optics (gas-optics/src/gas_optics.c:51-464) -------------------------

def create_gas_optics(grid_handle: int, num_levels: int, hitran_path: str,
                      h2o_ctm_dir: str, o3_ctm_file: str) -> int:
    """A GasOptics on the compute device (:func:`_device`)."""
    from ..gas_optics.continua import OzoneContinuum, WaterVaporContinuum
    from ..gas_optics.gas_optics import GasOptics

    dev = _device()
    grid = _get(grid_handle)
    h2o = (WaterVaporContinuum.from_directory(h2o_ctm_dir, grid, dev)
           if h2o_ctm_dir else None)
    o3 = (OzoneContinuum.from_file(o3_ctm_file, grid, dev)
          if o3_ctm_file else None)
    go = GasOptics(grid, hitran_path=hitran_path or None, h2o_ctm=h2o,
                   o3_ctm=o3, device=dev)
    return _register({"kind": "gas_optics", "go": go,
                      "nlev": int(num_levels), "ppmv": {}, "cfc_ppmv": {},
                      "cia_ppmv": {}, "cia_ids": {}, "step": None})


def gas_optics_num_levels(handle: int) -> int:
    return int(_get(handle)["nlev"])


def add_molecule(handle: int, mol_id: int, min_line_center: float,
                 max_line_center: float) -> int:
    """min/max <= 0 mean 'use grid bounds' (f_add_molecule passes huge
    defaults, grtcode_fortran.F90:777-785)."""
    st = _get(handle)
    st["go"].add_molecule(
        int(mol_id),
        None if min_line_center <= 0 else float(min_line_center),
        None if max_line_center <= 0 else float(max_line_center))
    st["step"] = None
    return GRTCODE_SUCCESS


def num_molecules(handle: int) -> int:
    return len(_get(handle)["go"].molecules)


def set_molecule_ppmv(handle: int, mol_id: int, ppmv) -> int:
    st = _get(handle)
    st["ppmv"][int(mol_id)] = _f64(ppmv, st["nlev"]).copy()
    return GRTCODE_SUCCESS


def add_cfc(handle: int, cfc_id: int, path: str) -> int:
    st = _get(handle)
    st["go"].add_cfc(int(cfc_id), path)
    st["step"] = None
    return GRTCODE_SUCCESS


def set_cfc_ppmv(handle: int, cfc_id: int, ppmv) -> int:
    st = _get(handle)
    st["cfc_ppmv"][int(cfc_id)] = _f64(ppmv, st["nlev"]).copy()
    return GRTCODE_SUCCESS


def add_cia(handle: int, species1: int, species2: int, path: str) -> int:
    st = _get(handle)
    st["go"].add_cia(int(species1), int(species2), path)
    st["step"] = None
    return GRTCODE_SUCCESS


def set_cia_ppmv(handle: int, species_id: int, ppmv) -> int:
    st = _get(handle)
    st["cia_ppmv"][int(species_id)] = _f64(ppmv, st["nlev"]).copy()
    return GRTCODE_SUCCESS


def calculate_optical_depth(handle: int, p_mb, t, optics_handle: int) -> int:
    """f_calculate_optics (grtcode_fortran.F90:845-853) -> fills the optics
    object with absorption-only gas tau.  One plain step function per gas
    optics, cached until a species is added."""
    st = _get(handle)
    go = st["go"]
    nlev = st["nlev"]
    if st["step"] is None:
        mol_ids = sorted(go.molecules)
        cfc_ids = sorted(go.cfcs)
        cia_ids = sorted({s for s1, s2, _ in go.cias for s in (s1, s2)})

        def step(p, t, vmr, cfc_vmr, cia_vmr):
            return go.optical_depth(
                p, t, dict(zip(mol_ids, vmr)),
                cfc_vmr=dict(zip(cfc_ids, cfc_vmr)),
                cia_vmr=dict(zip(cia_ids, cia_vmr)))

        st["step"] = (step, mol_ids, cfc_ids, cia_ids)
    step, mol_ids, cfc_ids, cia_ids = st["step"]
    dev = go.device

    def to_vmr(d, ids):
        return [_f32(d[i] * 1e-6, dev) for i in ids]

    tau = step(_f32(_f64(p_mb, nlev), dev), _f32(_f64(t, nlev), dev),
               to_vmr(st["ppmv"], mol_ids), to_vmr(st["cfc_ppmv"], cfc_ids),
               to_vmr(st["cia_ppmv"], cia_ids))
    out = _get(optics_handle)
    out["tau"] = _host(tau)
    out["omega"][:] = 0.0
    out["g"][:] = 0.0
    return GRTCODE_SUCCESS


# -- rayleigh (shortwave/src/rayleigh.c:100-144) -----------------------------

def rayleigh_scattering(optics_handle: int, p_mb) -> int:
    from ..solvers.rayleigh import rayleigh_optics

    o = _get(optics_handle)
    nlev = o["nlayers"] + 1
    opt = rayleigh_optics(_f64(p_mb, nlev), o["grid"], device=_device())
    o["tau"] = _host(opt.tau)
    o["omega"] = _host(opt.omega)
    o["g"] = _host(opt.g)
    return GRTCODE_SUCCESS


# -- solvers (C-only in the reference; longwave.c:312, shortwave.c:506) ------

def longwave_fluxes(optics_handle: int, t_surf: float, t_levels, t_layers,
                    emis, flux_up_out, flux_down_out) -> int:
    """Mirrors calculate_lw_fluxes (longwave/src/longwave.c:312-353): layer
    temperatures are an explicit argument; an empty/None ``t_layers`` falls
    back to level midpoints (documented approximation, not silent)."""
    from ..solvers.longwave import longwave_fluxes as lw

    dev = _device()
    o = _get(optics_handle)
    nlev = o["nlayers"] + 1
    tl = _f64(t_levels, nlev)
    grid = o["grid"]
    em = _f64(emis, grid.n)
    tlay = (0.5 * (tl[:-1] + tl[1:]) if t_layers is None
            else _f64(t_layers, o["nlayers"]).copy())
    up, down = lw(_f32(o["tau"], dev), _f32(o["omega"], dev),
                  _f32(np.float32(t_surf), dev), _f32(tlay, dev),
                  _f32(tl, dev), _f32(em, dev), grid.wavenumbers(dev))
    _f64(flux_up_out, up.numel())[:] = _host(up).ravel()
    _f64(flux_down_out, down.numel())[:] = _host(down).ravel()
    return GRTCODE_SUCCESS


def shortwave_fluxes(optics_handle: int, mu_dir: float, mu_dif: float,
                     albedo_dir, albedo_dif, tsi: float, solar_handle: int,
                     flux_up_out, flux_down_out) -> int:
    from ..solvers.shortwave import shortwave_fluxes as sw

    dev = _device()
    o = _get(optics_handle)
    grid = o["grid"]
    sf = _get(solar_handle)

    def scalar(v):
        return _f32(np.float32(v), dev)

    up, down = sw(_f32(o["tau"], dev), _f32(o["omega"], dev),
                  _f32(o["g"], dev), scalar(mu_dir), scalar(mu_dif),
                  _f32(_f64(albedo_dir, grid.n), dev),
                  _f32(_f64(albedo_dif, grid.n), dev), scalar(tsi),
                  sf.incident_flux.to(dev))
    _f64(flux_up_out, up.numel())[:] = _host(up).ravel()
    _f64(flux_down_out, down.numel())[:] = _host(down).ravel()
    return GRTCODE_SUCCESS
