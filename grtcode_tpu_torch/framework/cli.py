"""Shared command-line interface for the front-end applications (port of
grtcode_tpu/framework/cli.py).

The reference's shared flag set (framework/src/driver.c:872-935) plus
per-app flags, on stdlib argparse, with the JAX package's flag names and
defaults.  ``-d N`` selects the CUDA device ``cuda:N`` (``cuda:0`` without
it); an app never carries on on the CPU when CUDA is missing.  ``-mesh CxS``
runs the app over a (columns x spectral) mesh of ranks, one per GPU, in a
process group that ``torchrun --nproc-per-node C*S`` launches; each rank
then runs on its own GPU and the rank at mesh coordinate (0, 0) writes the
output.
"""
from __future__ import annotations

import argparse
import logging
import os

import torch

from ..spectral import SpectralGrid

log = logging.getLogger("grtcode_tpu_torch")


def shared_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("hitran_file", help="HITRAN database file (.par).")
    p.add_argument("solar_flux", help="Solar flux CSV file.")
    p.add_argument("-beta-path", dest="beta_path",
                   help="(accepted for parity; the incomplete beta is "
                        "computed analytically)")
    p.add_argument("-c", "--line-cutoff", type=float, default=25.0,
                   help="Cutoff [1/cm] from line center.")
    p.add_argument("-d", "--device", type=int, default=None,
                   help="CUDA device index (cuda:N; default 0).")
    p.add_argument("-flux-at-level", dest="flux_at_level", type=int,
                   default=None, help="Interior level to output fluxes at.")
    p.add_argument("-ice-path", dest="ice_path",
                   help="Ice cloud Pade parameterization netCDF.")
    p.add_argument("-integrated", action="store_true",
                   help="Output integrated instead of spectral fluxes.")
    p.add_argument("-liquid-path", dest="liquid_path",
                   help="Liquid cloud Pade parameterization netCDF.")
    p.add_argument("-o", dest="output", default="output.nc",
                   help="Name of output file.")
    p.add_argument("-r-lw", dest="r_lw", type=float, default=0.1)
    p.add_argument("-r-sw", dest="r_sw", type=float, default=1.0)
    p.add_argument("-w-lw", dest="w_lw", type=float, default=1.0)
    p.add_argument("-w-sw", dest="w_sw", type=float, default=1.0)
    p.add_argument("-W-lw", dest="W_lw", type=float, default=3250.0)
    p.add_argument("-W-sw", dest="W_sw", type=float, default=50000.0)
    p.add_argument("-h2o-ctm", dest="h2o_ctm",
                   help="MT-CKD water-vapor continuum directory.")
    p.add_argument("-o3-ctm", dest="o3_ctm",
                   help="Ozone continuum CSV file.")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-spectral-chunks", dest="spectral_chunks", type=int,
                   default=None, metavar="N",
                   help="Stream each band through N spectral blocks one "
                        "after the other (integrated output) - bounds "
                        "memory at fine resolutions like -r-lw 0.01.")
    p.add_argument("-mesh", default=None, metavar="CxS",
                   help="Shard over a (columns x spectral) device mesh, "
                        "e.g. '4x2' (launch under torchrun "
                        "--nproc-per-node C*S).")
    return p


def mesh_from_args(args, device=None):
    """The (columns x spectral) mesh ``-mesh CxS`` asks for (None without
    it) over the process group: the one already initialised, else the one
    torchrun's environment describes (:func:`..parallel.distributed.
    initialize`; ``device="cpu"`` puts the ranks on the CPU).  Exits when
    ``-mesh`` is malformed or there is no process group to join."""
    if not getattr(args, "mesh", None):
        return None
    try:
        c, s = (int(v) for v in args.mesh.lower().split("x"))
    except ValueError:
        raise SystemExit(f"-mesh {args.mesh!r}: expected CxS, e.g. 4x2")
    import torch.distributed as dist

    from ..parallel import distributed, make_mesh

    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise SystemExit(
                f"-mesh {c}x{s} runs one rank per GPU: launch the app under "
                f"torchrun --nproc-per-node {c * s}")
        distributed.initialize(device=device)
    cpu = device is not None and torch.device(device).type == "cpu"
    return make_mesh(c, s, device_type="cpu" if cpu else "cuda")


def writes_output(mesh) -> bool:
    """Whether this process writes the app's output: always without a
    mesh, else only the rank at mesh coordinate (0, 0)."""
    return mesh is None or not any(mesh.get_coordinate())


def grids_from_args(args) -> tuple[SpectralGrid, SpectralGrid]:
    return (SpectralGrid(args.w_lw, args.W_lw, args.r_lw),
            SpectralGrid(args.w_sw, args.W_sw, args.r_sw))


def configure(args) -> None:
    """Logging and the reference's verbosity level (-v is GRTCODE_INFO,
    framework/src/driver.c:901-902)."""
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(levelname)s %(name)s: %(message)s")
    from ..utils import verbosity as vb
    vb.set_verbosity(vb.GRTCODE_INFO if args.verbose else vb.GRTCODE_WARN)


def device_from_args(args, device=None, mesh=None) -> torch.device:
    """The device an app runs on: ``device`` when the caller passes one
    (the CPU tests do), else the rank's GPU under a ``mesh``, else
    ``cuda:N`` for ``-d N`` (``cuda:0`` without it).  Exits when CUDA is
    not available or has no such device."""
    if device is not None:
        return torch.device(device)
    if mesh is not None:
        return torch.device("cuda", torch.cuda.current_device())
    if not torch.cuda.is_available():
        raise SystemExit("this application runs on an NVIDIA GPU and "
                         "torch.cuda.is_available() is false")
    index = 0 if args.device is None else args.device
    if not 0 <= index < torch.cuda.device_count():
        raise SystemExit(f"-d {index}: {torch.cuda.device_count()} CUDA "
                         "device(s) available")
    return torch.device("cuda", index)


def add_gas_flags(p: argparse.ArgumentParser, molecules, cfcs=(), cias=()):
    for name in molecules:
        p.add_argument(f"-{name}", action="store_true",
                       help=f"Include {name}.")
    for name in cfcs:
        p.add_argument(f"-{name}", dest=name.replace("-", "_"),
                       nargs="?", const=True, default=False,
                       help=f"Include {name} (cross-section CSV path).")
    for name in cias:
        p.add_argument(f"-{name}", dest=name.replace("-", "_"),
                       nargs="?", const=True, default=False,
                       help=f"Include {name} collision-induced absorption.")


def register_cross_sections(driver, args, cfc_options=(),
                            cia_pairs=None) -> None:
    """Load the continuum / cross-section data files named on the command
    line into BOTH bands' gas optics, on each band's device, as the
    reference's create_gas_optics + add_molecules wiring does
    (framework/src/driver.c:616-625 passes h2o_ctm/o3_ctm to both bands;
    :193-210 adds every -<CFC> CSV and -<CIA> CSV to each GasOptics_t).

    ``cfc_options``: iterable of CLI option names (e.g. "CFC-11",
    "CFC-11-eq"); a flag whose value is a path loads that CSV (a bare
    flag just enables the species' abundance, table-less).
    ``cia_pairs``: {option name -> (CiaId, CiaId)}.
    """
    from ..gas_optics.molecules import CfcId

    gases = [g for g in (driver.lw_gas, driver.sw_gas) if g is not None]
    if getattr(args, "h2o_ctm", None):
        from ..gas_optics.continua import WaterVaporContinuum

        for g in gases:
            g.h2o_ctm = WaterVaporContinuum.from_directory(
                args.h2o_ctm, g.grid, g.device)
    if getattr(args, "o3_ctm", None):
        from ..gas_optics.continua import OzoneContinuum

        for g in gases:
            g.o3_ctm = OzoneContinuum.from_file(args.o3_ctm, g.grid,
                                                g.device)
    for opt in cfc_options:
        val = getattr(args, opt.replace("-", "_"), False)
        if not isinstance(val, str):
            continue
        base = opt[:-3] if opt.endswith("-eq") else opt
        cfc_id = CfcId[base.replace("-", "")]
        for g in gases:
            g.add_cfc(cfc_id, val)
    for opt, pair in (cia_pairs or {}).items():
        val = getattr(args, opt.replace("-", "_"), False)
        if not isinstance(val, str):
            continue
        for g in gases:
            g.add_cia(pair[0], pair[1], val)
