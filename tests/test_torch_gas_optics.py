"""The port's GasOptics == the JAX package's.

A 3-molecule band (H2O, CO2, O3) with H2O and O3 continua, two CFCs and
two CIA pairs, registered from CSV files through the port's own
add_catalog / add_cfc / add_cia and converted from the JAX object with
gas_optics_from_jax: both give the JAX state and the JAX optical depth.
"""
import jax
import numpy as np
import pytest
import torch

from grtcode_tpu.gas_optics import continua as jcontinua
from grtcode_tpu.gas_optics import gas_optics as jgas
from grtcode_tpu.gas_optics.hitran import synthetic_catalog as jcatalog
from grtcode_tpu.spectral import SpectralGrid as JGrid
from grtcode_tpu_torch.convert import gas_optics_from_jax
from grtcode_tpu_torch.gas_optics import continua, gas_optics
from grtcode_tpu_torch.gas_optics.hitran import synthetic_catalog
from grtcode_tpu_torch.spectral import SpectralGrid

# f32 parity with the JAX package (its kernel's bar, tests/test_pallas.py);
# measured worst case on this band: 4.4e-7.
RTOL = 2e-6
GRID = (400.0, 1300.0, 0.5)
MOLECULES = (1, 2, 3)
CFCS = (0, 1)
CIAS = ((0, 0), (1, 0))


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _write_csv(path, header, cols):
    with open(path, "w") as f:
        f.write(header + "\n")
        for row in zip(*cols):
            f.write(",".join(f"{v:.8e}" for v in row) + "\n")


def _raw(mol_id):
    rng = np.random.default_rng(40 + mol_id)
    n = 150
    vnn = np.sort(rng.uniform(GRID[0] - 20.0, GRID[1] + 20.0, n))
    return (mol_id, vnn, 10.0 ** rng.uniform(-22.0, -19.0, n)), dict(
        yair=rng.uniform(0.02, 0.11, n), yself=rng.uniform(0.05, 0.4, n),
        en=rng.uniform(0.0, 2800.0, n), n=rng.uniform(0.35, 0.85, n),
        d=rng.uniform(-0.01, 0.01, n),
        iso=rng.choice([1, 2], n, p=[0.9, 0.1]))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("gas_inputs")
    w = np.arange(300.0, 1401.0, 20.0)
    (d / "h2o").mkdir()
    _write_csv(d / "h2o" / "296MTCKD25_S.csv", "w,Cs",
               (w, 2.5e-22 * np.exp(-w / 900.0) + 4e-25))
    _write_csv(d / "h2o" / "296MTCKD25_F.csv", "w,Cf",
               (w, 6.0e-25 * np.exp(-w / 1500.0) + 1e-27))
    z = np.zeros_like(w)
    _write_csv(d / "h2o" / "CKDS.csv", "w,T0,a,b",
               (w, 0.012 + 0.004 * np.sin(w / 800.0), z, z))
    _write_csv(d / "h2o" / "CKDF.csv", "w,T0,a,b",
               (w, 0.006 + 0.002 * np.cos(w / 1100.0), z, z))
    _write_csv(d / "o3.csv", "w,sigma",
               (w, 4e-22 * np.exp(-0.5 * ((w - 1000.0) / 150.0) ** 2)))
    for k in CFCS:
        _write_csv(d / f"cfc{k}.csv", "w,sigma", (w, 8e-19 * np.exp(
            -0.5 * ((w - 850.0 - 60 * k) / 40.0) ** 2)))
    for s1, s2 in CIAS:
        _write_csv(d / f"cia{s1}{s2}.csv", "w,sigma", (w, 4e-44 * np.exp(
            -0.5 * ((w - 500.0 - 100 * s1) / 90.0) ** 2)))

    rng = np.random.default_rng(3)
    B, nlev = 2, 9
    p = np.linspace(0.05, 1013.0, nlev)[None, :] * np.ones((B, 1))
    t = np.linspace(210.0, 290.0, nlev)[None, :] + \
        rng.uniform(-4, 4, (B, nlev))
    vmr = {1: rng.uniform(1e-5, 2e-2, (B, nlev)),
           2: np.full((B, nlev), 4e-4), 3: rng.uniform(1e-8, 8e-6, (B, nlev))}
    cfc = {k: np.full((B, nlev), 1e-6 * (k + 1)) for k in CFCS}
    cia = {0: np.full((B, nlev), 0.781), 1: np.full((B, nlev), 0.209)}
    return d, (p, t, vmr, cfc, cia)


def _register(gas_cls, h2o_cls, o3_cls, catalog, grid, d, **device):
    """Register the band through one package's own public path (the port's
    constructors and readers also take the device)."""
    dev = tuple(device.values())
    g = gas_cls(
        grid, h2o_ctm=h2o_cls.from_directory(str(d / "h2o"), grid, *dev),
        o3_ctm=o3_cls.from_file(str(d / "o3.csv"), grid, *dev),
        method="line_sample", **device)
    for mol in MOLECULES:
        args, kws = _raw(mol)
        g.add_catalog(catalog(*args, **kws))
    for k in CFCS:
        g.add_cfc(k, str(d / f"cfc{k}.csv"))
    for s1, s2 in CIAS:
        g.add_cia(s1, s2, str(d / f"cia{s1}{s2}.csv"))
    return g


@pytest.fixture(scope="module")
def gases(inputs):
    d, _ = inputs
    jg = _register(jgas.GasOptics, jcontinua.WaterVaporContinuum,
                   jcontinua.OzoneContinuum, jcatalog, JGrid(*GRID), d)
    own = _register(gas_optics.GasOptics, continua.WaterVaporContinuum,
                    continua.OzoneContinuum, synthetic_catalog,
                    SpectralGrid(*GRID), d, device="cpu")
    return jg, own, gas_optics_from_jax(jg, "cpu")


def test_registration_builds_the_jax_state(gases):
    jg, own, conv = gases
    for port in (own, conv):
        assert port.tile == jg.tile and port.ch == jg.pallas_ch
        assert list(port.molecules) == list(jg.molecules)
        for mol, gl in jg.molecules.items():
            for f in ("c0", "frac0", "vnn", "snn", "yair", "yself", "en",
                      "n", "d", "iso0"):
                assert np.array_equal(getattr(port.molecules[mol], f),
                                      np.asarray(getattr(gl, f))), (mol, f)
            assert port.near_steps[mol] == jg.near_steps[mol]
            assert np.array_equal(port.chunk_ranges[mol].lo,
                                  jg.chunk_ranges[mol].lo)
            assert np.array_equal(port.chunk_ranges[mol].nchunks,
                                  jg.chunk_ranges[mol].nchunks)
        for f in ("cs", "cf", "t0s", "t0f"):
            assert np.array_equal(getattr(port.h2o_ctm, f).numpy(),
                                  np.asarray(getattr(jg.h2o_ctm, f)))
        assert np.array_equal(port.o3_ctm.cross_section.numpy(),
                              np.asarray(jg.o3_ctm.cross_section))
        for k in CFCS:
            assert np.array_equal(port.cfcs[k].cross_section.numpy(),
                                  np.asarray(jg.cfcs[k].cross_section))
        assert [(a, b) for a, b, _ in port.cias] == \
            [(a, b) for a, b, _ in jg.cias]
        for (_, _, pt), (_, _, jt) in zip(port.cias, jg.cias):
            assert np.array_equal(pt.cross_section.numpy(),
                                  np.asarray(jt.cross_section))


def _jax_tau(jg, state, **block):
    p, t, vmr, cfc, cia = state
    f = jax.numpy.float32
    return np.asarray(jg.optical_depth(
        jax.numpy.asarray(p, f), jax.numpy.asarray(t, f),
        {k: jax.numpy.asarray(v, f) for k, v in vmr.items()},
        cfc_vmr={k: jax.numpy.asarray(v, f) for k, v in cfc.items()},
        cia_vmr={k: jax.numpy.asarray(v, f) for k, v in cia.items()},
        **block))


def _port_tau(g, state, **block):
    p, t, vmr, cfc, cia = state
    return g.optical_depth(p, t, vmr, cfc_vmr=cfc, cia_vmr=cia,
                           **block).numpy()


@pytest.mark.parametrize("which", ["registered", "converted"])
def test_optical_depth_matches_jax(gases, inputs, which):
    jg, own, conv = gases
    state = inputs[1]
    want = _jax_tau(jg, state)
    got = _port_tau(own if which == "registered" else conv, state)
    assert got.shape == want.shape == (2, 8, SpectralGrid(*GRID).n)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert np.isfinite(got).all() and want.min() > 0


@pytest.mark.parametrize("block", [0, 3, 5])
def test_spectral_block_matches_jax(gases, inputs, block):
    jg, own, _ = gases
    size = 5 * own.block_quantum
    kw = dict(block_start=block * size, block_size=size)
    want = _jax_tau(jg, inputs[1], **kw)
    got = _port_tau(own, inputs[1], **kw)
    n = SpectralGrid(*GRID).n - block * size
    np.testing.assert_allclose(got[..., :n], want[..., :n], rtol=RTOL,
                               atol=0)


def test_block_outside_the_grid_raises(gases, inputs):
    own = gases[1]
    p, t, vmr, cfc, cia = inputs[1]
    for start in (own.block_quantum // 2, 6 * 5 * own.block_quantum):
        with pytest.raises(ValueError, match="block_start"):
            own.optical_depth(p, t, vmr, cfc_vmr=cfc, cia_vmr=cia,
                              block_start=start, block_size=64)



@pytest.mark.parametrize("beyond", ["temperature", "pressure"])
def test_rows_beyond_the_tables_limits_raise(gases, inputs, beyond):
    """The line_sample tables hold up to 500 K and 1.5 atm per layer;
    rows beyond either limit are refused, not computed."""
    own = gases[1]
    p, t, vmr, cfc, cia = inputs[1]
    if beyond == "temperature":
        t = np.asarray(t) + 300.0
    else:
        p = np.asarray(p) * 2.0
    with pytest.raises(ValueError, match="limits"):
        own.optical_depth(p, t, vmr, cfc_vmr=cfc, cia_vmr=cia)
