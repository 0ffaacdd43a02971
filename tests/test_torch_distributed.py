"""The port's multi-process flow (``grtcode_tpu_torch.parallel.
distributed``), ``ClearSkyRT`` and the apps' ``-mesh``, on the CPU.

* ``column_slice`` equals the JAX package's on every layout tried, with
  its -x/-X bounds; segments round-trip and combine, a gap is rejected;
* ``run_process_segment`` and ``run_driver_segment`` rerun idempotently
  (a done segment is skipped); without a process group a node is one rank
  and streams its spectral blocks, which the combined segments reproduce
  bit for bit, padding an uneven column split;
* the 2-node dryrun (``python -m grtcode_tpu_torch.parallel.dryrun``:
  2 nodes x 2 gloo ranks) writes segments that combine byte-identically
  to one process's run;
* ``ClearSkyRT`` equals the JAX package's ``ClearSkyRT`` at JAX's mesh
  bars (tests/test_parallel.py:80-81), integrated and spectral, with
  night columns and different direct and diffuse albedos;
* ``circ.main(... -mesh 1x2)`` in a spawned 2-rank group: only the rank at
  mesh coordinate (0, 0) writes, and its file equals a single-process
  run's with ``-spectral-chunks 2`` byte for byte.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from grtcode_tpu_torch.parallel import ClearSkyRT, distributed, dryrun  # noqa: E402
from grtcode_tpu_torch.parallel.clear_sky import stack_vmr  # noqa: E402
from grtcode_tpu_torch.utils.segments import SegmentManifest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("n,nproc,x,X", [
    (100, 10, 0, None), (101, 10, 0, None), (7, 3, 0, None), (8, 8, 0, None),
    (5, 1, 0, None), (100, 2, 10, 29), (32, 3, 4, 30)])
def test_column_slice_matches_jax(n, nproc, x, X):
    from grtcode_tpu.parallel import distributed as jdist

    covered = []
    for pid in range(nproc):
        got = distributed.column_slice(n, pid, nproc, x=x, X=X)
        assert got == jdist.column_slice(n, pid, nproc, x=x, X=X)
        covered.extend(range(*got))
    assert covered == list(range(x, (n - 1 if X is None else X) + 1))
    with pytest.raises(ValueError):
        distributed.column_slice(n, 0, nproc, x=n - 1, X=n)


def test_segment_roundtrip_and_combine(tmp_path):
    d = str(tmp_path)
    rng = np.random.default_rng(0)
    full = {"rlu": rng.normal(size=(10, 5)).astype(np.float32),
            "rld": rng.normal(size=(10, 5)).astype(np.float32)}
    manifest = SegmentManifest(d)
    for pid in range(3):
        s, e = distributed.column_slice(10, pid, 3)
        path = distributed.write_segment(
            d, "fluxes", pid, s, e, {k: v[s:e] for k, v in full.items()},
            manifest=manifest)
        assert path == distributed.segment_path(d, "fluxes", pid)
        assert manifest.is_done(f"fluxes.seg{pid:05d}")
    combined = distributed.combine_column_segments(d, "fluxes")
    for k in full:
        assert combined[k].tobytes() == full[k].tobytes()


def test_combine_rejects_gaps(tmp_path):
    d = str(tmp_path)
    distributed.write_segment(d, "x", 0, 0, 3, {"a": np.zeros(3)})
    distributed.write_segment(d, "x", 1, 4, 6, {"a": np.zeros(2)})
    with pytest.raises(ValueError, match="gap"):
        distributed.combine_column_segments(d, "x")
    with pytest.raises(FileNotFoundError):
        distributed.combine_column_segments(d, "y")


def test_run_process_segment_idempotent(tmp_path):
    calls = []

    class FakeModel:
        def step(self, mesh, integrated=True):
            def fn(batch):
                calls.append(mesh)
                return {"out": torch.as_tensor(batch["x"]) * 2.0}
            return fn

    batch = {"x": np.arange(8, dtype=np.float32)[:, None]}
    d = str(tmp_path)
    p1 = distributed.run_process_segment(
        FakeModel(), batch, d, "seg", process_index=0, num_processes=2)
    p2 = distributed.run_process_segment(
        FakeModel(), batch, d, "seg", process_index=0, num_processes=2)
    assert p1 == p2 and calls == [None]
    distributed.run_process_segment(
        FakeModel(), batch, d, "seg", process_index=1, num_processes=2)
    combined = distributed.combine_column_segments(d, "seg")
    assert combined["out"].tobytes() == (batch["x"] * 2.0).tobytes()


def test_run_driver_segment_uneven_streams_without_a_group(tmp_path):
    """Two nodes of one rank each, 5 columns (3 + 2), 2 spectral blocks:
    the combined segments equal run(spectral_chunks=2) byte for byte, and
    a second call reuses the done-marker."""
    driver, atm = dryrun.build_driver_case(B=5)
    d = str(tmp_path)
    for pid in range(2):
        distributed.run_driver_segment(driver, atm, d, "drv", n_spectral=2,
                                       process_index=pid, num_processes=2)
    combined = distributed.combine_column_segments(d, "drv")
    ref = driver.run(atm, spectral_chunks=2)
    assert sorted(ref.tiers) == ["af", "cs", "csaf"]
    for tier, fx in ref.tiers.items():
        for var, v in fx.items():
            assert combined[f"{tier}_{var}"].tobytes() == \
                v.numpy().tobytes(), (tier, var)
    mtime = os.path.getmtime(distributed.segment_path(d, "drv", 0))
    p = distributed.run_driver_segment(driver, atm, d, "drv", n_spectral=2,
                                       process_index=0, num_processes=2)
    assert p == distributed.segment_path(d, "drv", 0)
    assert os.path.getmtime(p) == mtime


def test_two_node_dryrun_segments_byte_identical(tmp_path):
    checked = dryrun.orchestrate(str(tmp_path))
    assert sorted(checked) == ["dryrun", "dryrun_driver", "dryrun_spec"]
    assert len(checked["dryrun_driver"]) == 12
    assert len(os.listdir(tmp_path)) >= 6   # 3 names x 2 nodes + markers


@pytest.fixture(scope="module")
def clear_sky_models():
    """The JAX package's tests/test_parallel.py model and batch, in both
    packages."""
    import jax.numpy as jnp
    from grtcode_tpu.gas_optics.gas_optics import GasOptics as JGasOptics
    from grtcode_tpu.parallel import ClearSkyRT as JClearSkyRT
    from grtcode_tpu.solvers.solar_flux import SolarFlux as JSolarFlux
    from grtcode_tpu.spectral import SpectralGrid as JGrid
    from grtcode_tpu_torch.convert import gas_optics_from_jax, solar_from_jax
    from tests.test_parallel import _catalog

    lw_grid = JGrid(200.0, 500.0, 0.25)
    sw_grid = JGrid(2000.0, 3000.0, 1.0)
    lw_gas = JGasOptics(lw_grid, line_chunk=64)
    lw_gas.add_catalog(_catalog(1, 180.0, 520.0, 120, 0))
    lw_gas.add_catalog(_catalog(2, 180.0, 520.0, 80, 1))
    sw_gas = JGasOptics(sw_grid, line_chunk=64)
    sw_gas.add_catalog(_catalog(1, 1980.0, 3020.0, 90, 2))
    solar = JSolarFlux.from_samples(np.linspace(1900.0, 3100.0, 50),
                                    np.full(50, 1.0), sw_grid)
    jmodel = JClearSkyRT(lw_gas=lw_gas, sw_gas=sw_gas, solar=solar)
    model = ClearSkyRT(gas_optics_from_jax(lw_gas, "cpu"),
                       gas_optics_from_jax(sw_gas, "cpu"),
                       solar_from_jax(solar, "cpu"))
    rng = np.random.default_rng(7)
    B, nlev = 8, 12
    p = np.linspace(0.01, 1013.0, nlev)[None, :] * \
        rng.uniform(0.9, 1.1, (B, 1))
    t = np.linspace(210.0, 290.0, nlev)[None, :] + \
        rng.uniform(-5, 5, (B, nlev))
    f32 = np.float32
    batch = {
        "p_lev": p.astype(f32), "t_lev": t.astype(f32),
        "t_surf": (t[:, -1] + rng.uniform(0, 3, B)).astype(f32),
        "emis": rng.uniform(0.9, 1.0, B).astype(f32),
        "mu_dir": np.where(np.arange(B) % 3 == 0, -0.1,
                           rng.uniform(0.2, 0.9, B)).astype(f32),
        "albedo_dir": rng.uniform(0.05, 0.4, B).astype(f32),
        "albedo_dif": rng.uniform(0.05, 0.4, B).astype(f32),
        "tsi": np.full(B, 1361.0, f32),
        "vmr_lw": rng.uniform(1e-6, 1e-2, (B, 2, nlev)).astype(f32),
        "vmr_sw": rng.uniform(1e-6, 1e-2, (B, 1, nlev)).astype(f32),
    }
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    return model, jmodel, batch, jbatch


@pytest.mark.parametrize("integrated", [True, False],
                         ids=["integrated", "spectral"])
def test_clear_sky_rt_matches_jax(clear_sky_models, integrated):
    model, jmodel, batch, jbatch = clear_sky_models
    got = model.step(integrated=integrated)(batch)
    want = jmodel.step(integrated=integrated)(jbatch)
    night = batch["mu_dir"] <= 0.0
    for k in ("rlu", "rld", "rsu", "rsd"):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        if integrated:
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-4,
                                       err_msg=k)
        else:
            scale = np.abs(w).max() + 1e-6
            np.testing.assert_allclose(g / scale, w / scale, atol=2e-5,
                                       err_msg=k)
        if k in ("rsu", "rsd"):
            assert not g[night].any()


def test_stack_vmr_follows_registration_order(clear_sky_models):
    model = clear_sky_models[0]
    vmr = {1: np.full((3, 4), 1.0), 2: np.full((3, 4), 2.0)}
    st = stack_vmr(model.lw_gas, vmr)
    assert st.shape == (3, 2, 4) and st.dtype == torch.float32
    assert float(st[0, 0, 0]) == 1.0 and float(st[0, 1, 0]) == 2.0
    assert stack_vmr(model.lw_gas, {}, "cfcs") is None


def _circ_argv(d):
    from tools.goldens import driver_inputs

    driver_inputs.write_inputs(d)
    return [os.path.join(d, "synthetic.par"), os.path.join(d, "solar.csv"),
            "-h2o-ctm", os.path.join(d, "h2o_ctm"), "-o3-ctm",
            os.path.join(d, "o3_ctm.csv"), "-r-lw", "4.0", "-r-sw", "10.0"]


def _circ_ranks(rank, store, argv, out):
    import torch.distributed as dist
    from grtcode_tpu_torch.apps import circ

    torch.set_num_threads(1)
    distributed.initialize(store, 2, rank, device="cpu", timeout_s=60)
    try:
        circ.main(argv + ["-mesh", "1x2", "-o", f"{out}.{rank}"],
                  device="cpu")
    finally:
        dist.destroy_process_group()


def test_circ_app_mesh_under_a_process_group(tmp_path):
    import h5py
    from grtcode_tpu_torch.apps import circ

    d = str(tmp_path)
    argv = _circ_argv(d)
    out = os.path.join(d, "mesh.nc")
    dryrun.spawn(_circ_ranks, 2,
                 ("file://" + os.path.join(d, "store"), argv, out),
                 timeout_s=60)
    assert os.path.exists(f"{out}.0") and not os.path.exists(f"{out}.1")
    single = os.path.join(d, "single.nc")
    circ.main(argv + ["-spectral-chunks", "2", "-o", single], device="cpu")
    with h5py.File(f"{out}.0", "r") as a, h5py.File(single, "r") as b:
        for name in ("rlu", "rld", "rsu", "rsd"):
            assert np.asarray(a[name]).tobytes() == \
                np.asarray(b[name]).tobytes(), name
