"""The port's C ABI: the JAX package's shim (``native/grtcode_tpu_c.cpp``,
the ABI of ``native/grtcode_tpu_c.h``) with the port's module name, built
by ``grtcode_tpu_torch.bindings.build`` and loaded in-process with ctypes.

* the built source is the JAX shim's with only the module name changed;
* the cases of tests/test_bindings.py through the port's shim: the
  spectral grid round trip, device selection (``grt_create_device(-1)``
  is the CPU, an id past the GPUs present is the reference's range error
  with a message), explicit and NULL layer temperatures, optics add;
* with no device selected and no GPU, compute calls fail with
  GRT_GPU_ERR and a message naming ``grt_create_device(-1)``: the CPU
  runs only when the caller selects it;
* optical depth, longwave and shortwave fluxes through the ABI against
  the JAX package's ``capi_impl`` on the same inputs, within the
  gas-optics pipeline (5e-4), LW (2e-4) and SW (3e-4) golden bars;
* with the JAX package's shim loaded RTLD_GLOBAL into the same process,
  the port's shim still dispatches into the port (``-Wl,-Bsymbolic``).
"""
import ctypes
import os
import pathlib

import numpy as np
import pytest
import torch

from grtcode_tpu_torch import bindings
from grtcode_tpu_torch.bindings import capi_impl

NATIVE = pathlib.Path(__file__).resolve().parents[1] / "native"


GRT_GPU_ERR = 12  # enum grt_return_codes, native/grtcode_tpu_c.h


@pytest.fixture(scope="module")
def lib():
    """The shim, with the CPU selected (id -1) for every compute call."""
    torch.set_num_threads(2)
    lib = bindings.load()
    assert lib.grt_initialize() == 0
    cpu = ctypes.c_int64()
    assert lib.grt_create_device(ctypes.c_int(-1), ctypes.byref(cpu)) == 0
    assert lib.grt_use_device(cpu) == 0
    return lib


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _handle(lib, fn, *args):
    h = ctypes.c_int64()
    assert getattr(lib, fn)(*args, ctypes.byref(h)) == 0, lib.grt_errstr()
    return h


def test_the_shim_is_the_jax_shim_with_the_ports_module():
    with open(bindings.SOURCE) as f:
        jax_text = f.read()
    with open(bindings.port_source()) as f:
        port_text = f.read()
    assert port_text != jax_text
    assert port_text == jax_text.replace(
        '"grtcode_tpu.bindings.capi_impl"',
        '"grtcode_tpu_torch.bindings.capi_impl"')


def test_spectral_grid_roundtrip(lib):
    h = _handle(lib, "grt_create_spectral_grid", ctypes.c_double(1.0),
                ctypes.c_double(500.0), ctypes.c_double(1.0))
    props = np.zeros(3)
    assert lib.grt_spectral_grid_properties(h, _dptr(props)) == 0
    assert props.tolist() == [1.0, 500.0, 1.0]
    assert lib.grt_destroy(h) == 0


def test_device_selection(lib):
    h = _handle(lib, "grt_create_device", ctypes.c_int(-1))
    assert lib.grt_use_device(h) == 0
    assert capi_impl._default_device == torch.device("cpu")
    n = ctypes.c_int()
    assert lib.grt_num_devices(ctypes.byref(n)) == 0
    assert n.value == torch.cuda.device_count()
    bad = ctypes.c_int64()
    assert lib.grt_create_device(ctypes.c_int(512), ctypes.byref(bad)) == 8
    assert b"out of range" in lib.grt_errstr()


def test_no_device_selected_and_no_gpu_refuses(lib, monkeypatch):
    """The CPU is never a silent default: with no device selected and no
    GPU, a compute call returns GRT_GPU_ERR and names the way to ask for
    the CPU, and leaves its output buffers untouched."""
    monkeypatch.setattr(capi_impl, "_default_device", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nlayers = 2
    grid = _handle(lib, "grt_create_spectral_grid", ctypes.c_double(1.0),
                   ctypes.c_double(4.0), ctypes.c_double(1.0))
    opt = _handle(lib, "grt_create_optics", ctypes.c_int(nlayers), grid)
    tlev = np.linspace(220.0, 290.0, nlayers + 1)
    emis = np.ones(4)
    up, down = np.full(12, -1.0), np.full(12, -1.0)
    assert lib.grt_longwave_fluxes(opt, ctypes.c_double(294.0), _dptr(tlev),
                                   None, _dptr(emis), _dptr(up),
                                   _dptr(down)) == GRT_GPU_ERR
    assert b"grt_create_device(-1)" in lib.grt_errstr()
    assert (up == -1.0).all() and (down == -1.0).all()
    p = np.linspace(1.0, 1000.0, nlayers + 1)
    assert lib.grt_rayleigh_scattering(opt, _dptr(p)) == GRT_GPU_ERR
    lib.grt_destroy(opt)
    lib.grt_destroy(grid)


def test_longwave_fluxes_t_layers(lib):
    nlayers, nw = 4, 8
    grid = _handle(lib, "grt_create_spectral_grid", ctypes.c_double(500.0),
                   ctypes.c_double(507.0), ctypes.c_double(1.0))
    opt = _handle(lib, "grt_create_optics", ctypes.c_int(nlayers), grid)
    capi_impl._get(opt.value)["tau"][:] = 0.3
    tlev = np.linspace(220.0, 290.0, nlayers + 1)
    emis = np.ones(nw)
    ts = ctypes.c_double(294.0)

    def fluxes(tlay):
        up, down = np.zeros((nlayers + 1) * nw), np.zeros((nlayers + 1) * nw)
        assert lib.grt_longwave_fluxes(
            opt, ts, _dptr(tlev), None if tlay is None else _dptr(tlay),
            _dptr(emis), _dptr(up), _dptr(down)) == 0
        return up, down

    mid = 0.5 * (tlev[:-1] + tlev[1:])
    up, down = fluxes(mid)
    up_null, down_null = fluxes(None)
    assert up.tobytes() == up_null.tobytes()
    assert down.tobytes() == down_null.tobytes()
    assert np.all(up > 0)
    _, down_hot = fluxes(mid + 5.0)
    assert not np.allclose(down_hot, down)
    lib.grt_destroy(opt)
    lib.grt_destroy(grid)


def test_optics_add_and_properties(lib):
    grid = _handle(lib, "grt_create_spectral_grid", ctypes.c_double(1.0),
                   ctypes.c_double(4.0), ctypes.c_double(1.0))
    a, b, res = (_handle(lib, "grt_create_optics", ctypes.c_int(2), grid)
                 for _ in range(3))
    capi_impl._get(a.value)["tau"][:] = 1.0
    capi_impl._get(b.value)["tau"][:] = 2.0
    parts = np.array([a.value, b.value], dtype=np.int64)
    assert lib.grt_add_optics(
        res, parts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int(2)) == 0
    tau, omega, g = np.zeros(8), np.zeros(8), np.zeros(8)
    assert lib.grt_optics_properties(res, _dptr(tau), _dptr(omega),
                                     _dptr(g)) == 0
    assert np.all(tau == 3.0) and not omega.any() and not g.any()
    for h in (a, b, res, grid):
        lib.grt_destroy(h)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    import sys
    sys.path.insert(0, str(NATIVE.parent))
    from tools.goldens import driver_inputs

    d = str(tmp_path_factory.mktemp("capi"))
    driver_inputs.write_inputs(d)
    return d


def _rel(got, want, floor=0.01):
    scale = np.maximum(np.abs(want), floor * np.abs(want).max())
    return float((np.abs(got - want) / scale).max())


def test_fluxes_through_the_abi_match_jax(lib, inputs):
    """Gas tau on a synthetic .par, then Rayleigh + gas optics through
    both solvers, the port through the C ABI and JAX through its
    capi_impl functions, on the same buffers."""
    from grtcode_tpu.bindings import capi_impl as jcapi

    nlev, nlayers = 10, 9
    p = np.linspace(1.0, 1000.0, nlev)
    t = np.linspace(210.0, 290.0, nlev)
    ppmv = np.full(nlev, 4000.0)

    def port_gas(w0, wn, dw):
        grid = _handle(lib, "grt_create_spectral_grid", ctypes.c_double(w0),
                       ctypes.c_double(wn), ctypes.c_double(dw))
        gas = _handle(lib, "grt_create_gas_optics", grid, ctypes.c_int(nlev),
                      os.path.join(inputs, "synthetic.par").encode(),
                      b"", b"")
        assert lib.grt_add_molecule(gas, ctypes.c_int(1), ctypes.c_double(0),
                                    ctypes.c_double(0)) == 0
        assert lib.grt_set_molecule_ppmv(gas, ctypes.c_int(1),
                                         _dptr(ppmv)) == 0
        opt = _handle(lib, "grt_create_optics", ctypes.c_int(nlayers), grid)
        assert lib.grt_calculate_optical_depth(gas, _dptr(p), _dptr(t),
                                               opt) == 0, lib.grt_errstr()
        return grid, opt

    def jax_gas(w0, wn, dw):
        grid = jcapi.create_spectral_grid(w0, wn, dw)
        gas = jcapi.create_gas_optics(
            grid, nlev, os.path.join(inputs, "synthetic.par"), "", "")
        jcapi.add_molecule(gas, 1, 0.0, 0.0)
        jcapi.set_molecule_ppmv(gas, 1, memoryview(ppmv))
        opt = jcapi.create_optics(nlayers, grid)
        jcapi.calculate_optical_depth(gas, memoryview(p), memoryview(t), opt)
        return grid, opt

    def tau(get, h):
        return get(h)["tau"]

    # Longwave: gas tau on 500-700 cm-1 at 0.5.
    grid, opt = port_gas(500.0, 700.0, 0.5)
    jgrid, jopt = jax_gas(500.0, 700.0, 0.5)
    assert _rel(tau(capi_impl._get, opt.value), tau(jcapi._get, jopt),
                1e-3) < 5e-4
    nw = capi_impl._get(opt.value)["tau"].shape[1]
    emis = np.full(nw, 0.98)
    up, down = np.zeros((nlev) * nw), np.zeros(nlev * nw)
    assert lib.grt_longwave_fluxes(opt, ctypes.c_double(292.0), _dptr(t),
                                   None, _dptr(emis), _dptr(up),
                                   _dptr(down)) == 0
    jup, jdown = np.zeros_like(up), np.zeros_like(down)
    jcapi.longwave_fluxes(jopt, 292.0, memoryview(t), None,
                          memoryview(emis), memoryview(jup),
                          memoryview(jdown))
    assert _rel(up, jup) < 2e-4 and _rel(down, jdown) < 2e-4

    # Shortwave: gas + Rayleigh on 2000-4000 cm-1 at 2.0.
    grid, gas_opt = port_gas(2000.0, 4000.0, 2.0)
    jgrid, jgas_opt = jax_gas(2000.0, 4000.0, 2.0)
    ray = _handle(lib, "grt_create_optics", ctypes.c_int(nlayers), grid)
    assert lib.grt_rayleigh_scattering(ray, _dptr(p)) == 0
    jray = jcapi.create_optics(nlayers, jgrid)
    jcapi.rayleigh_scattering(jray, memoryview(p))
    assert _rel(tau(capi_impl._get, ray.value), tau(jcapi._get, jray)) < 1e-6
    both = _handle(lib, "grt_create_optics", ctypes.c_int(nlayers), grid)
    parts = np.array([gas_opt.value, ray.value], dtype=np.int64)
    assert lib.grt_add_optics(
        both, parts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int(2)) == 0
    jboth = jcapi.create_optics(nlayers, jgrid)
    jcapi.add_optics(jboth, memoryview(np.array([jgas_opt, jray],
                                                dtype=np.int64)))
    solar_csv = os.path.join(inputs, "solar.csv")
    solar = _handle(lib, "grt_create_solar_flux", grid, solar_csv.encode())
    jsolar = jcapi.create_solar_flux(jgrid, solar_csv)
    nw = capi_impl._get(both.value)["tau"].shape[1]
    alb = np.full(nw, 0.2)
    up, down = np.zeros(nlev * nw), np.zeros(nlev * nw)
    assert lib.grt_shortwave_fluxes(
        both, ctypes.c_double(0.6), ctypes.c_double(0.5), _dptr(alb),
        _dptr(alb), ctypes.c_double(1361.0), solar, _dptr(up),
        _dptr(down)) == 0, lib.grt_errstr()
    jup, jdown = np.zeros_like(up), np.zeros_like(down)
    jcapi.shortwave_fluxes(jboth, 0.6, 0.5, memoryview(alb),
                           memoryview(alb), 1361.0, jsolar,
                           memoryview(jup), memoryview(jdown))
    assert _rel(up, jup) < 3e-4 and _rel(down, jdown) < 3e-4
    assert up.max() > 0 and down.max() > 0


def _jax_shim() -> str:
    """The JAX package's shim, ``native/grtcode_tpu_c.cpp`` unmodified,
    built with native/Makefile's flags into ``build/grtcode_tpu_torch/``
    (a temporary file renamed into place): nothing is written into
    ``native/``, where tests/test_bindings.py builds its own copy."""
    import shutil
    import subprocess

    from grtcode_tpu_torch.cuda_build import build_shared

    cxx, config = shutil.which("g++"), shutil.which("python3-config")
    if cxx is None or config is None:
        pytest.skip("the JAX package's shim needs g++ and python3-config")

    def flags(*args):
        return subprocess.run([config, *args], check=True,
                              capture_output=True, text=True).stdout.split()

    path, _ = build_shared(
        "jax_grtcode_tpu_c",
        [cxx, "-O2", "-Wall", "-Wextra", "-fPIC", "-std=c++17", "-shared",
         *flags("--includes")],
        bindings.SOURCE, headers=[bindings.HEADER],
        link=flags("--ldflags", "--embed"))
    return path


def test_port_shim_beside_the_jax_shim(lib):
    """The JAX package's shim loaded RTLD_GLOBAL first (as
    tests/test_bindings.py does) takes no port call: the port's shim
    binds its own symbols, so its grids land in the port's registry."""
    ctypes.CDLL(_jax_shim(), mode=ctypes.RTLD_GLOBAL)
    before = set(capi_impl._registry)
    h = _handle(lib, "grt_create_spectral_grid", ctypes.c_double(1.0),
                ctypes.c_double(9.0), ctypes.c_double(2.0))
    assert set(capi_impl._registry) - before == {h.value}
    assert type(capi_impl._get(h.value)).__module__ == \
        "grtcode_tpu_torch.spectral"
