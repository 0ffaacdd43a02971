"""The port's (columns x spectral) mesh runs, on the CPU with gloo.

One spawned group of four CPU ranks (a ``file://`` store under the test's
temporary directory, a 60 s timeout) runs every mesh shape of the
three-tier dryrun case (``grtcode_tpu_torch.parallel.dryrun.
build_driver_case``: aerosols, stochastic clouds, a third of the columns
at night so day compaction is on the path):

* 6 columns on meshes (1 x 2), (2 x 1), (2 x 2) and (3 x 1), and 5 columns
  on (2 x 2) and (3 x 1), whose shards pad; integrated and spectral
  output; ranks outside a smaller mesh sit it out;
* every rank of a mesh returns the whole batch, the same on each;
* each result is bit-identical to the port's single-process run:
  ``run(spectral_chunks=S)`` for integrated output (the mesh sums the
  gathered block integrals in block order, as streaming does), ``run()``
  for spectra;
* and close to the JAX package's (2 x 2) mesh run of the same case (its
  betainc replaced by the exact one, as in tests/test_torch_driver_tiers.
  py): integrated fluxes within JAX's mesh bars, rtol 2e-5 / atol 2e-4
  per value (tests/test_parallel.py:80-81) and 2e-5 of each variable's
  largest flux (:156-158); spectra within the port's bars against JAX
  (tests/test_torch_driver_batching.py): LW 1e-4 and SW 5e-3 relative,
  floored at 1 % of the largest value.

The rank function is at module level and the JAX imports are inside the
fixtures, so the spawned ranks import no JAX.
"""
import os

import numpy as np
import pytest
import torch

from grtcode_tpu_torch.parallel import distributed, dryrun, make_mesh

WORLD = 4
CASES = {6: [(1, 2), (2, 1), (2, 2), (3, 1)], 5: [(2, 2), (3, 1)]}
MODES = {"integrated": True, "spectral": False}
RUNS = [(B, shape, mode) for B, shapes in CASES.items() for shape in shapes
        for mode in MODES]


def _case(B):
    driver, atm = dryrun.build_driver_case(B=B)
    atm.cos_zenith[1::3] = -0.4
    return driver, atm


def _name(B, shape, mode, rank):
    return f"B{B}_{shape[0]}x{shape[1]}_{mode}_rank{rank}.npz"


def _ranks(rank, store, out_dir):
    """One rank: every mesh of CASES that holds it, both output modes."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    distributed.initialize(store, WORLD, rank, device="cpu", timeout_s=60)
    try:
        try:
            make_mesh(3, 2, device_type="cpu")
        except ValueError as e:
            with open(os.path.join(out_dir, f"error_rank{rank}.txt"),
                      "w") as f:
                f.write(str(e))
        for B, shapes in CASES.items():
            driver, atm = _case(B)
            for C, S in shapes:
                mesh = make_mesh(C, S, devices=range(C * S),
                                 device_type="cpu")
                if rank >= C * S:
                    continue
                for mode, integrated in MODES.items():
                    res = driver.run(atm, integrated=integrated, mesh=mesh)
                    np.savez(os.path.join(out_dir,
                                          _name(B, (C, S), mode, rank)),
                             **{f"{t}_{k}": v.numpy()
                                for t, fx in res.tiers.items()
                                for k, v in fx.items()})
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh"))
    dryrun.spawn(_ranks, WORLD, ("file://" + os.path.join(d, "store"), d),
                 timeout_s=60)

    def load(B, shape, mode, rank):
        if B is None:
            with open(os.path.join(d, f"error_rank{rank}.txt")) as f:
                return f.read()
        with np.load(os.path.join(d, _name(B, shape, mode, rank))) as z:
            return {k: z[k] for k in z.files}
    return load


@pytest.fixture(scope="module")
def single(request):
    """The port's single-process runs: {(B, mode, S): arrays}."""
    torch.set_num_threads(2)
    out = {}
    for B in CASES:
        driver, atm = _case(B)
        for S in (1, 2):
            out[(B, "integrated", S)] = driver.run(atm, spectral_chunks=S)
        out[(B, "spectral", 1)] = driver.run(atm, integrated=False)
    return {key: {f"{t}_{k}": v.numpy() for t, fx in res.tiers.items()
                  for k, v in fx.items()} for key, res in out.items()}


@pytest.fixture(scope="module")
def jax_mesh():
    """The JAX package's (2 x 2) mesh run of the 6-column case, both
    output modes."""
    from grtcode_tpu.clouds import beta as jbeta
    from grtcode_tpu.parallel import make_mesh as jmake_mesh
    from tests.test_torch_driver_tiers import exact_betainc
    from tools.dryrun_distributed import build_driver_case

    driver, atm = build_driver_case(B=6)
    atm.cos_zenith[1::3] = -0.4
    mesh = jmake_mesh(2, 2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbeta, "betainc", exact_betainc)
        return {mode: {f"{t}_{k}": np.asarray(v)
                       for t, fx in driver.run(atm, integrated=integrated,
                                               mesh=mesh).tiers.items()
                       for k, v in fx.items()}
                for mode, integrated in MODES.items()}


@pytest.mark.parametrize("B,shape,mode", RUNS)
def test_mesh_bit_identical_to_single_process(mesh_runs, single, B, shape,
                                              mode):
    C, S = shape
    want = single[(B, mode, S if mode == "integrated" else 1)]
    first = mesh_runs(B, shape, mode, 0)
    assert sorted(first) == sorted(want)
    for rank in range(C * S):
        got = mesh_runs(B, shape, mode, rank)
        for k, v in want.items():
            assert got[k].shape == v.shape, (rank, k)
            assert got[k].tobytes() == v.tobytes(), \
                (rank, k, float(np.abs(got[k] - v).max()))


@pytest.mark.parametrize("shape", CASES[6])
@pytest.mark.parametrize("mode", list(MODES))
def test_mesh_close_to_jax_mesh_run(mesh_runs, jax_mesh, shape, mode):
    from tests.test_torch_driver_batching import SW_SPECTRUM_TOL
    from tests.test_torch_driver_tiers import TOLERANCE, worst_rel

    got = mesh_runs(6, shape, mode, 0)
    want = jax_mesh[mode]
    assert sorted(got) == sorted(want)
    for k, ref in want.items():
        assert got[k].shape == ref.shape, k
        if mode == "integrated":
            np.testing.assert_allclose(got[k], ref, rtol=2e-5, atol=2e-4,
                                       err_msg=k)
            scale = np.abs(ref).max() + 1e-6
            np.testing.assert_allclose(got[k] / scale, ref / scale,
                                       atol=2e-5, err_msg=k)
        else:
            lw = k.endswith(("rlu", "rld"))
            assert worst_rel(got[k], ref) < (TOLERANCE if lw
                                             else SW_SPECTRUM_TOL), k


def test_night_columns_have_no_shortwave(mesh_runs):
    night = np.arange(5) % 3 == 1
    for mode in MODES:
        got = mesh_runs(5, (3, 1), mode, 0)
        for t in ("csaf", "cs", "af"):
            rsd = got[f"{t}_rsd"].reshape(5, -1)
            assert not rsd[night].any()
            assert rsd[~night].any(axis=1).all()


def test_make_mesh_checks_its_size(mesh_runs):
    """C x S must equal the number of ranks (the JAX package's
    ValueError), and a mesh needs a process group."""
    import torch.distributed as dist

    for rank in range(WORLD):
        assert mesh_runs(None, None, None, rank) == \
            "mesh 3x2 needs 6 devices, have 4"
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(1, 1, device_type="cpu")
