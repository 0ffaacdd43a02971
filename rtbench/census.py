"""What a call's inputs need of the Voigt kernels: samples by Humlicek
class, operations, bytes and the least time the card could take.

A frozen form of ``grtcode_tpu_torch/kernel_bench.py`` at commit 64ee402
(``CLASSES``, ``OPS``, the published peaks and ``bound_ms``), fed the
benchmark's own line prep (``rtbench.reference.rt.line_prep``), so the
count is the same work whatever implements it.  The samples are what the
method needs, not what a kernel happens to compute: every line's grid
points within the cutoff (``line_sample``) or its bins' fine points and
remote bins' three points (``wavenumber_sweep``), the longwave of every
column and the shortwave of lit columns only, and each byte read or
written once.  Bucket padding and the masked night shortwave therefore
show as a lower share.

kernel_bench evaluates the near-core offsets one by one; here each
class's samples are counted in closed form, as kernel_bench counts the
far wing's region-1 samples: the integer offsets o whose
|x| = |o - frac| dw sqrt(ln 2) / alpha_D falls in the class's interval of
|x|, which depends on y alone.  The two agree to the samples that sit on a
class boundary in rounding (``rtbench/tests/test_rtbench_census.py``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .reference import rt

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet): f32 operations outside the tensor cores, HBM3 bandwidth.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12

# f32 operations per sample by class: Humlicek regions 0-3, region 4
# with |x| <= 18.1 y + 1.65 (4a) and beyond (4b), the pure Lorentz limit.
CLASSES = ("region0", "region1", "region2", "region3", "region4a",
           "region4b", "lorentz")
OPS = {"region0": 8, "region1": 16, "region2": 25, "region3": 30,
       "region4a": 120, "region4b": 208, "lorentz": 8}
_OPS = torch.tensor([OPS[c] for c in CLASSES], dtype=torch.float64)


def bound_s(ops: float, nbytes: float) -> float:
    """The least time [s] for ``ops`` f32 operations moving ``nbytes``."""
    return max(ops / PEAK_F32_OPS, nbytes / PEAK_BYTES)


def _count(lo, hi, o_lo, o_hi, frac, scale):
    """Integer offsets o in [o_lo, o_hi] with |o - frac| * scale in
    [lo, hi) (half of the boundary points excluded)."""
    a, b = lo / scale, hi / scale
    right = (torch.minimum(o_hi, torch.ceil(frac + b) - 1)
             - torch.maximum(o_lo, torch.ceil(frac + a)) + 1).clamp(min=0)
    left = (torch.minimum(o_hi, torch.ceil(frac - a) - 1)
            - torch.maximum(o_lo, torch.floor(frac - b) + 1) + 1).clamp(min=0)
    return right + left


def class_counts(centre, frac, lorentz, doppler, o_lo, o_hi, dw):
    """Samples by class (CLASSES order, a (7,) float64 tensor) of lines
    whose nearest grid point is ``centre`` (fraction ``frac`` from it),
    evaluated at the offsets [o_lo, o_hi] from it (empty where o_hi <
    o_lo); every argument a float64 tensor of one shape."""
    repwid = rt.SQRT_LN2 / doppler
    y_true = repwid * lorentz
    y = y_true.clamp(max=70.0)
    scale = dw * repwid
    total = (o_hi - o_lo + 1).clamp(min=0)
    lor = y_true >= 70.55
    xlim0 = torch.sqrt(15100.0 + y * (40.0 - y * 3.6))
    xlim1 = torch.where(y >= 8.425, torch.zeros_like(y), torch.sqrt(
        torch.clamp(164.0 - y * (4.3 + y * 1.8), min=0.0)))
    xlim2 = 6.8 - y
    tiny = y <= 0.000001
    xlim1 = torch.where(tiny, xlim0, xlim1)
    xlim2 = torch.where(tiny, xlim0, xlim2)
    m = torch.minimum(torch.minimum(xlim0, xlim1), xlim2).clamp(min=0.0)
    b4 = 18.1 * y + 1.65
    y24 = 2.4 * y
    zero = torch.zeros_like(y)
    spans = (
        (xlim1, xlim0),                                         # region 1
        (xlim2, torch.minimum(xlim1, xlim0)),                   # region 2
        (zero, torch.minimum(m, y24)),                          # region 3
        (y24, torch.minimum(m, b4)),                            # region 4a
        (torch.maximum(y24, b4), m))                            # region 4b
    spans = [(lo.clamp(min=0.0), hi) for lo, hi in spans]     # |x| >= 0
    counts = [torch.where(lor | (hi <= lo), zero,
                          _count(lo, hi, o_lo, o_hi, frac, scale))
              for lo, hi in spans]
    lorentz_n = torch.where(lor, total, zero)
    region0 = total - lorentz_n - sum(counts)
    return torch.stack([region0.sum(), *(c.sum() for c in counts),
                        lorentz_n.sum()])


class LocalWindows:
    """Each line's fine points under the bin method: the points of the
    run of bins whose local range holds it (first, last; last < first for
    a line local to no bin), and its remote samples per row."""

    def __init__(self, band, v: np.ndarray):
        bins = rt.Bins(band)
        lo, hi, rlo, rhi, ok, lok, rok = bins.ranges(v, band.local_bins,
                                                     band.remote_bins)
        L = v.size
        first = np.full(L, np.iinfo(np.int64).max)
        last = np.full(L, -1)
        for j in np.flatnonzero(ok):
            a, b = lo[j], hi[j] + 1
            first[a:b] = np.minimum(first[a:b], bins.first[j])
            last[a:b] = np.maximum(last[a:b], bins.first[j] + bins.size[j]
                                   - 1)
        self.first = np.where(last >= 0, first, 0)
        self.last = last
        right_start = np.where(ok, hi + 1, lo)
        remote = (np.where(lok, lo - rlo, 0).sum()
                  + np.maximum(np.where(rok, rhi - right_start + 1, 0),
                               0).sum())
        self.remote_samples = int(remote) * rt.NIP
        self.bins = bins


def molecule_counts(pos, lorentz, doppler, band, windows=None):
    """Samples by class of one molecule's (rows, L) prepared lines."""
    dev = pos.device
    centre = torch.floor(pos + 0.5)
    frac = pos - centre
    if windows is None:           # line_sample: the cutoff window
        fsteps = int(math.ceil(band.cutoff / band.dw))
        valid = (centre >= 0) & (centre < band.n)
        o_lo = torch.clamp(-centre, min=-fsteps)
        o_hi = torch.where(valid, torch.clamp(band.n - 1 - centre,
                                              max=fsteps), o_lo - 1)
    else:                          # the bin method: the local points
        f = torch.as_tensor(windows.first, device=dev, dtype=pos.dtype)
        last = torch.as_tensor(windows.last, device=dev, dtype=pos.dtype)
        o_lo, o_hi = f[None] - centre, last[None] - centre
    return class_counts(centre, frac, lorentz, doppler, o_lo, o_hi, band.dw)


class Census:
    """The per-call sums of a deployment's Voigt work: ``add(column)``
    for each column a call runs, then :meth:`kernels`."""

    def __init__(self, dep, device, tips=None):
        self.dep, self.device = dep, device
        self.tips = tips or rt.PartitionSums()
        self.windows = {}
        self.work = {}      # (band, mol) -> [counts (7,), rows]
        for name, band in dep.bands.items():
            if band.method == "wavenumber_sweep":
                for mol, lines in band.lines.items():
                    self.windows[(name, mol)] = LocalWindows(
                        band, np.asarray(lines["vnn"], np.float64))

    def add(self, cols: dict) -> None:
        """Count the work of a batch of columns (``Deployment.columns``):
        the longwave of each, the shortwave of the lit ones."""
        lit = np.asarray(cols["mu"]) > 0.0
        for name, band in self.dep.bands.items():
            part = cols
            if name == "sw":
                if not lit.any():
                    continue
                part = {k: ({m: a[lit] for m, a in v.items()}
                            if isinstance(v, dict) else np.asarray(v)[lit])
                        for k, v in cols.items()}
            c = rt.Column(part, torch.float64, self.device)
            for mol, lines in band.lines.items():
                pos, _, lor, dop = rt.line_prep(c, mol, lines, band,
                                                self.tips)
                counts = molecule_counts(pos, lor, dop, band,
                                         self.windows.get((name, mol)))
                slot = self.work.setdefault((name, mol), [0.0, 0])
                slot[0] = slot[0] + counts.cpu()
                slot[1] += pos.shape[0]

    def kernels(self) -> dict:
        """{"k1" | "k2": {"ops", "bytes", "bound_s"}}: K1 is the
        line_sample work, K2 the bin method's, each band-molecule's
        operations and bytes summed over the added columns before the
        larger of their two times is taken; a kernel with no work is left
        out."""
        out = {}
        for (name, mol), (counts, rows) in self.work.items():
            band = self.dep.bands[name]
            L = band.lines[mol]["vnn"].size
            ops = float((counts * _OPS).sum())
            if band.method == "wavenumber_sweep":
                w = self.windows[(name, mol)]
                ops += OPS["region0"] * w.remote_samples * rows
                points = w.bins.count * (w.bins.ppb + rt.NIP)
                kernel = "k2"
            else:
                points = band.n
                kernel = "k1"
            nbytes = 4.0 * rows * (5 * L + 1 + 2 * points)
            k = out.setdefault(kernel, {"ops": 0.0, "bytes": 0.0,
                                        "bound_s": 0.0})
            k["ops"] += ops
            k["bytes"] += nbytes
            k["bound_s"] += bound_s(ops, nbytes)
        return out
