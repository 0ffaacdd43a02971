"""The seam of the port's hand-written kernels (grtcode_tpu_torch/cuda_build.py)
on the CPU.

* The registry: every ``csrc/*.cu`` has one registered kernel and every
  registered kernel its source and its dispatcher.
* K2's argument checks (``bins_kernel._check_cuda_args``), the checks K1's
  and K3's tests make of theirs: dtypes, contiguity, shapes, the bin
  window and the lines its ranges reach.
* Each registered kernel's launch with its entry point replaced by a
  ctypes function of the same prototype (the CPU build of torch has no
  CUDA stream, so the stream lookup is replaced too): a nonzero return
  raises naming the kernel and is not counted; a zero return is counted
  once and the kernel got its arguments with the stream last; inside
  ``debug.debug_mode()`` a NaN in its output raises naming the kernel.

The kernels themselves run only on the card (tests/test_torch_gpu.py).
"""
import ctypes
import glob
import os

import numpy as np
import pytest
import torch

from grtcode_tpu_torch import constants, cuda_build
from grtcode_tpu_torch.gas_optics import bins as bm
from grtcode_tpu_torch.gas_optics import bins_kernel as bk
from grtcode_tpu_torch.gas_optics import lines, voigt_kernel as vk
from grtcode_tpu_torch.gas_optics.hitran import synthetic_catalog
from grtcode_tpu_torch.solvers import disort
from grtcode_tpu_torch.spectral import SpectralGrid
from grtcode_tpu_torch.utils import curtis_godson as cg
from grtcode_tpu_torch.utils import debug

DISPATCHERS = {"voigt_line_sample": vk.accumulate_voigt,
               "voigt_bins": bk.accumulate_bins_kernel,
               "disort_doubling": disort.layer_operators}
CUDA = torch.device("cuda", 0)   # only named: nothing runs on it here
STREAM = 0x5EED


def test_every_kernel_source_has_one_registered_kernel():
    sources = sorted(os.path.basename(p)[:-len(".cu")] for p in
                     glob.glob(os.path.join(cuda_build.CSRC, "*.cu")))
    assert sources and sorted(cuda_build.KERNELS) == sources
    assert all(k.name == name for name, k in cuda_build.KERNELS.items())
    assert sorted(DISPATCHERS) == sources


@pytest.fixture(scope="module")
def molecule():
    """tests/test_pallas.py's setup (grid 100-180 cm-1 at 0.1, 120 lines,
    3 x 6 rows) prepared on the CPU, with its bins at 1 cm-1."""
    grid = SpectralGrid(100.0, 180.0, 0.1)
    rng = np.random.default_rng(5)
    n_lines = 120
    cat = synthetic_catalog(
        1, np.sort(rng.uniform(90.0, 190.0, n_lines)),
        rng.uniform(1e-22, 1e-19, n_lines),
        yair=rng.uniform(0.02, 0.1, n_lines),
        yself=rng.uniform(0.05, 0.4, n_lines),
        en=rng.uniform(0.0, 2000.0, n_lines),
        n=rng.uniform(0.4, 0.8, n_lines),
        d=rng.uniform(-0.02, 0.02, n_lines))
    bound = lines.bind_to_grid(cat, grid)
    nlev, B = 7, 3
    p = torch.linspace(0.01, 1013.0, nlev).expand(B, nlev)
    t = torch.linspace(215.0, 288.0, nlev).expand(B, nlev)
    p_atm = p * constants.MB_TO_ATM
    pavg, tavg = cg.layer_pressures_temperatures(p_atm, t)
    psavg, ns = cg.partial_pressures_and_densities(
        p_atm, torch.full((B, nlev), 1e-3), cg.number_densities(p_atm))
    rows = B * (nlev - 1)
    prep = lines.prepare(bound, grid, pavg.reshape(rows),
                         tavg.reshape(rows), psavg.reshape(rows))
    bins = bm.create_spectral_bins(grid.n, grid.w0, grid.dw, 1.0)
    ranges = bm.build_bin_ranges(bound, bins, mode="bin_sweep")
    return prep, ns.reshape(rows).contiguous(), bins, ranges


def _bin_args(molecule, **change):
    """bins_kernel._check_cuda_args's arguments for a window of 8 bins,
    with the entries of ``change`` in place of the defaults."""
    prep, ns, bins, ranges = molecule
    fields = {k: change.get(k, v) for k, v in vars(prep).items()}
    rows, nbins = ns.shape[0], 8
    reach = bk.device_tables(ranges, bins, "cpu")[2]
    return (lines.PreparedLines(**fields), change.get("ns", ns),
            change.get("tau0", torch.zeros((rows, nbins * bins.ppb))),
            change.get("bins_tau0", torch.zeros((rows, nbins, bm.NIP))),
            nbins, bins.ppb, change.get("start_bin", 0),
            change.get("reach", reach))


@pytest.mark.parametrize("bad,match", [
    ("center_idx_dtype", "center_idx has dtype"),
    ("strength_dtype", "strength has dtype"),
    ("noncontiguous", "lorentz must be contiguous"),
    ("ns_shape", "ns has shape"),
    ("tau0_shape", "tau0 has shape"),
    ("bins_tau0_shape", "bins_tau0 has shape"),
    ("reach_past_the_lines", "the bin ranges reach line"),
    ("negative_window", "bin window start -8")])
def test_bin_kernel_wrapper_rejects_what_the_kernel_does_not_take(
        molecule, bad, match):
    prep, ns = molecule[0], molecule[1]
    rows, L = prep.strength.shape
    change = {
        "center_idx_dtype": dict(center_idx=prep.center_idx.long()),
        "strength_dtype": dict(strength=prep.strength.double()),
        "noncontiguous": dict(lorentz=torch.cat(
            [prep.lorentz, prep.lorentz], 1)[:, ::2]),
        "ns_shape": dict(ns=ns[:-1]),
        "tau0_shape": dict(tau0=torch.zeros((rows, 3))),
        "bins_tau0_shape": dict(bins_tau0=torch.zeros((rows, 8, 2))),
        "reach_past_the_lines": dict(reach=L + 1),
        "negative_window": dict(start_bin=-8),
    }[bad]
    with pytest.raises(ValueError, match=match):
        bk._check_cuda_args(*_bin_args(molecule, **change))
    bk._check_cuda_args(*_bin_args(molecule))  # the unchanged call is fine


def _values(kernel):
    """One value of each of the kernel's argument types."""
    return [1.5 if t is ctypes.c_float else 7 for t in kernel.argtypes]


@pytest.fixture
def stub(monkeypatch):
    """``stub(name, ret)``: kernel ``name`` with its entry point replaced by
    a ctypes function of its prototype that records its arguments and
    returns ``ret``, the stream lookup replaced, and its dispatcher's
    count at 0 (all restored after the test).  Returns the kernel and the
    list of recorded calls."""
    looked_up = []
    monkeypatch.setattr(cuda_build, "_stream",
                        lambda device: looked_up.append(device) or STREAM)

    def make(name, ret):
        kernel, calls = cuda_build.KERNELS[name], []

        def entry(*args):
            calls.append(args)
            return ret

        proto = ctypes.CFUNCTYPE(ctypes.c_int, *kernel.argtypes,
                                 ctypes.c_void_p)
        monkeypatch.setattr(kernel, "fn", proto(entry))
        monkeypatch.setattr(DISPATCHERS[name], "launches", 0)
        return kernel, calls, looked_up
    return make


@pytest.mark.parametrize("name", sorted(DISPATCHERS))
def test_a_failed_launch_raises_and_is_not_counted(stub, name):
    kernel, calls, _ = stub(name, 700)
    with pytest.raises(RuntimeError,
                       match=f"^{name} launch failed: CUDA error 700$"):
        kernel.launch(DISPATCHERS[name], CUDA, torch.zeros(2),
                      *_values(kernel))
    assert len(calls) == 1
    assert DISPATCHERS[name].launches == 0


@pytest.mark.parametrize("name", sorted(DISPATCHERS))
def test_a_launch_runs_on_the_current_stream_and_is_counted(stub, name):
    kernel, calls, looked_up = stub(name, 0)
    out = (torch.zeros(2), torch.ones(3))
    assert kernel.launch(DISPATCHERS[name], CUDA, out,
                         *_values(kernel)) is out
    assert DISPATCHERS[name].launches == 1
    assert looked_up == [CUDA]
    (args,) = calls
    assert len(args) == len(kernel.argtypes) + 1 and args[-1] == STREAM
    assert list(args[:-1]) == _values(kernel)


def test_debug_mode_names_the_kernel_that_wrote_a_nan(stub):
    kernel, calls, _ = stub("voigt_line_sample", 0)
    tau0 = torch.full((2, 3), float("nan"))
    with debug.debug_mode():
        with pytest.raises(FloatingPointError,
                           match="NaN produced by the voigt_line_sample"):
            kernel.launch(vk.accumulate_voigt, CUDA, tau0,
                          *_values(kernel))
    assert len(calls) == 1
