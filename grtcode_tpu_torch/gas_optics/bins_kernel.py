"""Bin-method optical depth: the CUDA bin kernel and its dispatcher
(counterpart of grtcode_tpu/gas_optics/bins_pallas.py).

The kernel, ``csrc/voigt_bins.cu``, replaces the Pallas TPU kernel
``bins_pallas.py::_bin_kernel``.  For one molecule and a window of bins it
adds the local lines' exact Voigt on each bin's fine points and the remote
lines' Voigt at each bin's NIP = 3 interpolation points, both in place.
It is built, loaded and launched through its entry in
:data:`grtcode_tpu_torch.cuda_build.KERNELS`.

What bounds it on the card is f32 arithmetic and IEEE division, as for the
line_sample kernel; the design (coarse blocks with one (row, bin) per
thread walking exactly its bin's remote ranges, fine blocks of one bin
with four points per lane, per-(row, line) factors in shared memory, and
Humlicek coefficients kept only for the lines with a sample inside the
region-0 limit) is described at the top of the ``.cu`` file.  The TPU
design's tables beyond the per-bin ranges (chunk-aligned group starts,
interior chunk split, ``coarse_region0``, ``lpad``) served its DMA
pipeline and pairwise-rational path; this kernel decides region 0 per
(row, line, bin) on the card instead and uses none of them.

:func:`accumulate_bins_kernel` dispatches on the device of its tensors:
CPU tensors take the plain version :func:`bins.accumulate_bins`; CUDA
tensors launch the kernel or raise (:func:`..cuda_build.on_card`).  Each
function counts its own launches in ``.launches``.
"""
from __future__ import annotations

import torch

from ..cuda_build import KERNELS, check_tensors, on_card
from ..utils.graphs import count_launches
from .bins import NIP, BinRanges, SpectralBins, accumulate_bins
from .lines import PreparedLines


def device_tables(ranges: BinRanges, bins: SpectralBins, device):
    """The kernel's per-bin tables on ``device``, copied once and cached
    on ``ranges``: (6, nbins) int32 half-open line ranges (local,
    remote-left, remote-right), (nbins, NIP) f32 interpolation positions,
    and the largest line index the ranges reach."""
    key = str(torch.device(device))
    if key not in ranges._on_device:
        bounds = ranges.bounds()
        ranges._on_device[key] = (
            torch.as_tensor(bounds, device=device),
            torch.as_tensor(bins.w_rel, device=device),
            int(bounds[1::2].max(initial=0)))
    return ranges._on_device[key]


def _check_cuda_args(prep: PreparedLines, ns, tau0, bins_tau0, nbins: int,
                     ppb: int, start_bin: int, reach: int):
    rows, L = prep.strength.shape
    f32 = torch.float32
    check_tensors(prep.strength.device, dict(
        prep.kernel_layout(), ns=(ns, (rows,), f32),
        tau0=(tau0, (rows, nbins * ppb), f32),
        bins_tau0=(bins_tau0, (rows, nbins, NIP), f32)))
    if start_bin < 0 or nbins < 0:
        raise ValueError(f"bin window start {start_bin}, size {nbins}")
    if reach > L:
        raise ValueError(f"the bin ranges reach line {reach}, the prepared "
                         f"lines hold {L}")
    if L >= 2 ** 31 or (start_bin + nbins) * ppb >= 2 ** 31:
        raise ValueError("line or point count exceeds int32 indexing")


@count_launches
def accumulate_bins_kernel(prep: PreparedLines, ns, ranges: BinRanges,
                           bins: SpectralBins, *, start_bin: int = 0,
                           nbins: int | None = None, tau0=None,
                           bins_tau0=None):
    """Bin-method accumulation of one molecule on the bin window
    ``[start_bin, start_bin + nbins)``, added in place into ``tau0``
    (rows, nbins * ppb) fine tau and ``bins_tau0`` (rows, nbins, NIP)
    coarse wings (zeros when not given); see :func:`bins.accumulate_bins`
    for the semantics.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.  Returns ``(tau0, bins_tau0)``.
    """
    rows = prep.strength.shape[0]
    device = prep.strength.device
    nbins = bins.n - start_bin if nbins is None else nbins
    if tau0 is None:
        tau0 = torch.zeros((rows, nbins * bins.ppb), dtype=torch.float32,
                           device=device)
    if bins_tau0 is None:
        bins_tau0 = torch.zeros((rows, nbins, NIP), dtype=torch.float32,
                                device=device)
    if not on_card(device, "accumulate_bins_kernel"):
        return accumulate_bins(prep, ns, ranges, bins, start_bin=start_bin,
                               nbins=nbins, tau0=tau0, bins_tau0=bins_tau0)
    bounds, w_rel, reach = device_tables(ranges, bins, device)
    _check_cuda_args(prep, ns, tau0, bins_tau0, nbins, bins.ppb, start_bin,
                     reach)
    return KERNELS["voigt_bins"].launch(
        accumulate_bins_kernel, device, (tau0, bins_tau0),
        prep.center_idx.data_ptr(), prep.center_frac.data_ptr(),
        prep.strength.data_ptr(), prep.lorentz.data_ptr(),
        prep.doppler.data_ptr(), ns.data_ptr(), bounds.data_ptr(),
        w_rel.data_ptr(), tau0.data_ptr(), bins_tau0.data_ptr(), rows,
        prep.strength.shape[1], start_bin, nbins, bins.n, bins.ppb,
        bins.num_wpoints, bins.wres)
