"""Simulated multi-node run on the CPU: 2 nodes x 2 ranks, gloo.

    python -m grtcode_tpu_torch.parallel.dryrun [--out-dir D]

validates the per-node production flow of :mod:`.distributed` without a
cluster: it spawns four ranks that join one ``torch.distributed`` group
(gloo, a ``file://`` store) as two nodes of two ranks (``LOCAL_WORLD_SIZE=
2``).  Each node runs its column slice on a mesh of its own ranks and
writes one segment and its done-marker: the flagship two-band step
(:class:`.clear_sky.ClearSkyRT`) integrated on (2 columns x 1 spectral)
meshes and spectrally resolved on (1 x 2) ones, and the full three-tier
driver (aerosols and stochastic clouds) integrated on (1 x 2) ones.  The
parent then merges the segments and checks them byte for byte against
the same computations in one process: the unsharded step, and the
driver streamed through 2 spectral blocks, whose sums the (1 x 2) mesh
reproduces (the
reference's SLURM-sharded run against a single-node run,
GRTworkflow/run-rfmip-irf.sh:102-125 + combiner).  The cases are copies
of the JAX package's dryrun cases (tools/dryrun_distributed.py).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

NODES = 2
RANKS_PER_NODE = 2
N_SPECTRAL = 2
BATCH_COLUMNS = 8
TIMEOUT_S = 120.0


def build_flagship(lw_points: int = 256, sw_points: int = 128,
                   nlines: int = 96, chunk: int = 32, B: int = BATCH_COLUMNS,
                   nlev: int = 9, device="cpu"):
    """(ClearSkyRT, batch dict): the JAX package's flagship two-band step
    (``__graft_entry__._build``) at dryrun size."""
    from ..gas_optics.gas_optics import GasOptics
    from ..gas_optics.hitran import synthetic_catalog
    from ..solvers.solar_flux import SolarFlux
    from ..spectral import SpectralGrid
    from .clear_sky import ClearSkyRT

    lw_grid = SpectralGrid(1.0, 1.0 + 0.1 * (lw_points - 1), 0.1)
    sw_grid = SpectralGrid(2000.0, 2000.0 + 1.0 * (sw_points - 1), 1.0)

    def catalog(mol_id, grid, L, seed):
        rng = np.random.default_rng(seed)
        vnn = np.sort(rng.uniform(grid.w0, grid.last, L))
        return synthetic_catalog(
            mol_id, vnn, rng.uniform(1e-22, 1e-19, L),
            yair=rng.uniform(0.02, 0.1, L), yself=rng.uniform(0.05, 0.4, L),
            en=rng.uniform(0.0, 2000.0, L), n=rng.uniform(0.4, 0.8, L),
            d=rng.uniform(-0.01, 0.01, L))

    lw_gas = GasOptics(lw_grid, line_chunk=chunk, device=device)
    lw_gas.add_catalog(catalog(1, lw_grid, nlines, 0))
    lw_gas.add_catalog(catalog(2, lw_grid, nlines // 2, 1))
    sw_gas = GasOptics(sw_grid, line_chunk=chunk, device=device)
    sw_gas.add_catalog(catalog(1, sw_grid, nlines // 2, 2))
    solar = SolarFlux.from_samples(
        np.linspace(sw_grid.w0 - 10, sw_grid.last + 10, 64),
        np.full(64, 1.0), sw_grid, device)
    rng = np.random.default_rng(7)
    p = np.linspace(0.01, 1013.0, nlev)[None, :] * np.ones((B, 1))
    t = np.linspace(210.0, 290.0, nlev)[None, :] + \
        rng.uniform(-5, 5, (B, nlev))
    f32 = np.float32
    batch = {
        "p_lev": p.astype(f32), "t_lev": t.astype(f32),
        "t_surf": (t[:, -1] + 1.5).astype(f32),
        "emis": np.full(B, 0.98, f32),
        "mu_dir": rng.uniform(0.2, 0.9, B).astype(f32),
        "albedo_dir": np.full(B, 0.15, f32),
        "albedo_dif": np.full(B, 0.15, f32),
        "tsi": np.full(B, 1361.0, f32),
        "vmr_lw": rng.uniform(1e-6, 1e-2, (B, 2, nlev)).astype(f32),
        "vmr_sw": rng.uniform(1e-6, 1e-2, (B, 1, nlev)).astype(f32),
    }
    return ClearSkyRT(lw_gas=lw_gas, sw_gas=sw_gas, solar=solar), batch


def build_driver_case(B: int = BATCH_COLUMNS, device="cpu"):
    """(RadiationDriver, Atmosphere): a small but complete three-tier
    case, both bands, synthetic lines, aerosols (CS) and stochastic Pade
    clouds (AF), the same on every rank."""
    from ..clouds.lib import CloudOpticsLib
    from ..clouds.pade import synthetic_pade_table
    from ..framework.atmosphere import Atmosphere
    from ..framework.driver import RadiationDriver
    from ..gas_optics.gas_optics import GasOptics
    from ..gas_optics.hitran import synthetic_catalog
    from ..solvers.solar_flux import SolarFlux
    from ..spectral import SpectralGrid

    lw_grid = SpectralGrid(100.0, 150.0, 0.2)
    sw_grid = SpectralGrid(2000.0, 20000.0, 10.0)

    def cat(grid, seed, L=64):
        r = np.random.default_rng(seed)
        vnn = np.sort(r.uniform(grid.w0, grid.last, L))
        return synthetic_catalog(
            1, vnn, r.uniform(1e-22, 1e-19, L),
            yair=r.uniform(0.02, 0.1, L), yself=r.uniform(0.05, 0.4, L),
            en=r.uniform(0.0, 2000.0, L), n=r.uniform(0.4, 0.8, L),
            d=r.uniform(-0.01, 0.01, L))

    lw_gas = GasOptics(lw_grid, line_chunk=32, device=device)
    lw_gas.add_catalog(cat(lw_grid, 0))
    sw_gas = GasOptics(sw_grid, line_chunk=32, device=device)
    sw_gas.add_catalog(cat(sw_grid, 1))
    w = np.linspace(1900.0, 20100.0, 64)
    solar = SolarFlux.from_samples(w, 1.0 + 0.3 * np.sin(w / 3000.0),
                                   sw_grid, device)
    clouds = CloudOpticsLib(
        liquid=synthetic_pade_table(nbnd=8, w0=100.0, wn=20000.0, seed=0,
                                    device=device),
        ice=synthetic_pade_table(nbnd=8, w0=100.0, wn=20000.0, seed=1,
                                 device=device))
    driver = RadiationDriver(lw_gas=lw_gas, sw_gas=sw_gas, solar=solar,
                             cloud_optics=clouds.driver_callback(),
                             cloud_seed=7)
    nlev = 9
    nlay = nlev - 1
    rng = np.random.default_rng(23)
    atm = Atmosphere(
        level_pressure=np.linspace(1.0, 1013.0, nlev)[None]
        * np.ones((B, 1)),
        level_temperature=np.linspace(220.0, 290.0, nlev)[None]
        + rng.uniform(-4, 4, (B, nlev)),
        surface_temperature=rng.uniform(285.0, 300.0, B),
        ppmv={1: rng.uniform(100.0, 3000.0, (B, nlev))},
        cos_zenith=rng.uniform(0.2, 0.9, B),
        total_solar_irradiance=np.full(B, 1361.0),
        aerosol_optical_depth_1um=rng.uniform(0.0, 0.3, (B, nlay)),
        aerosol_angstrom_exponent=np.full(B, 1.3),
        aerosol_single_scatter_albedo=rng.uniform(0.85, 0.99, (B, nlay)),
        aerosol_asymmetry_factor=rng.uniform(0.3, 0.8, (B, nlay)),
        cloud_fraction=rng.uniform(0.2, 0.9, (B, nlay)),
        liquid_water_content=rng.uniform(0.0, 0.3, (B, nlay)),
        ice_water_content=rng.uniform(0.0, 0.02, (B, nlay)),
        layer_thickness=np.full((B, nlay), 500.0),
        clean=False, clear=False)
    return driver, atm


def _worker(rank: int, store: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from . import distributed

    torch.set_num_threads(1)
    os.environ["LOCAL_WORLD_SIZE"] = str(RANKS_PER_NODE)
    os.environ["LOCAL_RANK"] = str(rank % RANKS_PER_NODE)
    distributed.initialize(store, NODES * RANKS_PER_NODE, rank,
                           device="cpu", timeout_s=TIMEOUT_S)
    try:
        model, batch = build_flagship()
        # Integrated on (2 x 1) node meshes, spectra on (1 x 2) ones.
        for name, integrated, n_spectral in (
                ("dryrun", True, 1), ("dryrun_spec", False, N_SPECTRAL)):
            distributed.run_process_segment(
                model, batch, out_dir, name, n_spectral=n_spectral,
                integrated=integrated)
        driver, atm = build_driver_case()
        distributed.run_driver_segment(driver, atm, out_dir, "dryrun_driver",
                                       n_spectral=N_SPECTRAL)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, args=(), timeout_s: float = TIMEOUT_S) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes; raise if
    any fails or the whole run outlasts ``timeout_s`` (then every process
    is killed)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks still running after "
                                   f"{timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def orchestrate(out_dir: str) -> dict:
    """Spawn the ranks, combine their segments, check them against the
    single-process runs; returns {segment name: arrays compared}."""
    from . import distributed

    store = "file://" + os.path.join(os.path.abspath(out_dir), "store")
    spawn(_worker, NODES * RANKS_PER_NODE, (store, out_dir))
    model, batch = build_flagship()
    driver, atm = build_driver_case()
    want = {"dryrun": model.step(integrated=True)(batch),
            "dryrun_spec": model.step(integrated=False)(batch),
            "dryrun_driver": {
                f"{t}_{k}": v for t, fx in driver.run(
                    atm, spectral_chunks=N_SPECTRAL).tiers.items()
                for k, v in fx.items()}}
    for name, ref in want.items():
        got = distributed.combine_column_segments(out_dir, name)
        if sorted(got) != sorted(ref):
            raise AssertionError(f"{name}: arrays {sorted(got)}, expected "
                                 f"{sorted(ref)}")
        for k, v in ref.items():
            v = v.cpu().numpy()
            if got[k].shape != v.shape or got[k].tobytes() != v.tobytes():
                raise AssertionError(
                    f"{name}/{k}: combined segments differ from the "
                    f"single-process run (max abs diff "
                    f"{np.abs(got[k] - v).max():.3e})")
    return {name: sorted(ref) for name, ref in want.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default=None,
                    help="where the segments go (a temporary directory "
                         "by default)")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = args.out_dir or tmp
        checked = orchestrate(out_dir)
    print(f"dryrun ok: {NODES} nodes x {RANKS_PER_NODE} ranks (gloo), "
          f"segments byte-identical to one process: " + "; ".join(
              f"{k} ({', '.join(v)})" for k, v in checked.items()))


if __name__ == "__main__":
    main()
