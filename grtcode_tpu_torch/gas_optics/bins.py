"""Spectral bins and the bin-interpolated optical-depth methods (port of
grtcode_tpu/gas_optics/bins.py).

The reference's ``wavenumber_sweep`` (bin_sweep) and ``line_sweep``
methods (gas-optics/src/kernels.c:177-304, 306-406):

  * ``SpectralBins`` mirrors create_spectral_bins
    (gas-optics/src/spectral_bin.c:30-108): the grid is partitioned into
    ~1 cm-1 bins; each bin carries NIP = 3 interpolation wavenumbers
    (first / midpoint / last fine point).
  * "Local" lines evaluate the full Voigt on the bin's fine grid points;
    "remote" lines evaluate only at the NIP points, accumulated into a
    coarse (rows, bins, NIP) buffer.
  * After ALL absorbers (continua, CFC and CIA add straight to the fine
    tau), the coarse wing buffer is quadratically interpolated onto the
    fine grid and clamped at zero (kernel_utils.c:79-104 bin_quad_interp).

The host half (bins, bracketing, per-bin line ranges) is a numpy copy of
the JAX package's, so the tables are byte-identical.  The device half is
plain PyTorch: :func:`accumulate_bins`, the plain version of the CUDA bin
kernel (``csrc/voigt_bins.cu``, dispatched by
:mod:`grtcode_tpu_torch.gas_optics.bins_kernel`), and
:func:`interpolate_bins`.  Both work on a window of bins, so a spectral
block needs nothing from outside itself.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.graphs import device_constant
from .hitran import STRENGTH_SCALE
from .lines import GridLines, PreparedLines
from .voigt import voigt_line_shape

NIP = 3  # interpolation points per bin (spectral_bin-internal.h)
# A block's line window starts and ends on multiples of this many lines
# (or at the catalog's end), so each of its lines takes the same path
# through lines.prepare's elementwise ops as in the whole catalog's prep:
# PyTorch's CPU kernels run a row's last elements short of two vectors
# through scalar code, whose pow can differ in the last bit.
LINE_ALIGN = 64


@dataclasses.dataclass
class SpectralBins:
    """Uniform spectral bins (spectral_bin.h:29-50)."""

    num_wpoints: int
    w0: float
    wres: float
    width: float
    ppb: int            # fine points per bin
    last_ppb: int
    n: int              # number of bins
    do_interp: bool
    do_last_interp: bool
    l: np.ndarray       # (n,) int64 leftmost fine index per bin
    r: np.ndarray       # (n,) rightmost fine index per bin
    w: np.ndarray       # (n, NIP) float64 interpolation wavenumbers

    @property
    def w_rel(self) -> np.ndarray:
        """(n, NIP) f32 interpolation positions in grid units: the
        half-integers ``(w - w0) / wres`` both the kernel and the plain
        version evaluate the remote wings at."""
        return ((self.w - self.w0) / self.wres).astype(np.float32)


def create_spectral_bins(num_wpoints: int, w0: float, wres: float,
                         bin_width: float = 1.0) -> SpectralBins:
    """Mirror of create_spectral_bins (spectral_bin.c:30-108)."""
    ppb = int(np.floor(bin_width / wres)) + 1
    do_interp = ppb > 3
    last_ppb = num_wpoints % ppb
    last_ppb = ppb if last_ppb == 0 else last_ppb
    do_last_interp = last_ppb > 3
    n = num_wpoints // ppb
    if ppb != last_ppb:
        n += 1
    l = np.arange(n, dtype=np.int64) * ppb
    sizes = np.full(n, ppb, dtype=np.int64)
    sizes[-1] = last_ppb
    r = l + sizes - 1
    w = np.empty((n, NIP), dtype=np.float64)
    w[:, 0] = w0 + l * wres
    w[:, NIP - 1] = w[:, 0] + (sizes - 1) * wres
    w[:, 1] = 0.5 * (w[:, 0] + w[:, NIP - 1])
    return SpectralBins(num_wpoints=num_wpoints, w0=w0, wres=wres,
                        width=bin_width, ppb=ppb, last_ppb=last_ppb, n=n,
                        do_interp=do_interp, do_last_interp=do_last_interp,
                        l=l, r=r, w=w)


# ---------------------------------------------------------------------------
# Host-side bracketing (kernel_utils.c:26-76 semantics)
# ---------------------------------------------------------------------------

def _bracket_left(v: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """C bracket()'s *left* index: largest i with v[i] <= val (0 if val
    precedes everything); exact hits return the hit index."""
    i = np.searchsorted(v, vals, side="left")
    exact = (i < len(v)) & (np.take(v, np.minimum(i, len(v) - 1)) == vals)
    left = np.where(exact, i, i - 1)
    return np.clip(left, 0, max(len(v) - 1, 0))


def _bracket_right(v: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """C bracket()'s *right* index: smallest i with v[i] >= val (n-1 if
    val exceeds everything)."""
    i = np.searchsorted(v, vals, side="left")
    return np.clip(i, 0, max(len(v) - 1, 0))


@dataclasses.dataclass
class BinRanges:
    """Per-bin contiguous line index ranges for local + remote passes.

    Local: lines evaluated on the bin's fine points.  Remote: lines
    evaluated at the bin's NIP interpolation points (left and right of
    the local window are contiguous ranges on the sorted catalog).
    """

    local_lo: np.ndarray    # (nbins,)
    local_cnt: np.ndarray
    rem_lo: np.ndarray      # remote-left range
    rem_cnt_l: np.ndarray
    rem_hi_start: np.ndarray  # remote-right range start
    rem_cnt_r: np.ndarray
    lmax_local: int
    lmax_remote: int
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    def bounds(self) -> np.ndarray:
        """(6, nbins) int32 half-open ranges: local [lo, end), remote-left
        [lo, end), remote-right [lo, end)."""
        out = np.stack([self.local_lo, self.local_cnt, self.rem_lo,
                        self.rem_cnt_l, self.rem_hi_start,
                        self.rem_cnt_r]).astype(np.int64)
        out[1::2] += out[0::2]
        return out.astype(np.int32)

    def window(self, start_bin: int, nbins: int, num_lines: int):
        """``(lo, hi, ranges)`` of the bin window ``[start_bin, start_bin
        + nbins)``: the smallest line window ``[lo, hi)`` that holds every
        line its bins read (each nonempty local and remote range), its
        ends rounded out to multiples of ``LINE_ALIGN`` and clamped to the
        ``num_lines`` lines of the (padded) catalog; and the ranges as
        they index the window, the window's bins' nonempty ranges shifted
        by ``-lo`` and every other range empty.  A window of the whole
        catalog gives these ranges themselves."""
        bnd = self.bounds().astype(np.int64)
        begin, end = bnd[0::2], bnd[1::2]                   # (3, bins)
        cols = slice(start_bin, start_bin + nbins)
        used = np.zeros_like(begin, bool)
        used[:, cols] = end[:, cols] > begin[:, cols]
        if used.any():
            a = LINE_ALIGN
            lo = int(begin[used].min()) // a * a
            hi = min(-(-int(end[used].max()) // a) * a, num_lines)
        else:
            lo, hi = 0, min(LINE_ALIGN, num_lines)
        if lo == 0 and hi == num_lines:
            return lo, hi, self
        start = np.where(used, begin - lo, 0).astype(np.int32)
        cnt = np.where(used, end - begin, 0).astype(np.int32)
        shifted = BinRanges(start[0], cnt[0], start[1], cnt[1], start[2],
                            cnt[2], self.lmax_local, self.lmax_remote)
        return lo, hi, shifted


def build_bin_ranges(lines: GridLines, bins: SpectralBins, *,
                     mode: str, nbin_local: int = 1, nbin_remote: int = 25,
                     local_cutoff: float = 1.5,
                     remote_cutoff: float = 25.0,
                     lane_multiple: int = 8) -> BinRanges:
    """Local/remote line ranges per bin.

    mode="bin_sweep": local = centers within [first point of bin
    j-nbin_local, last point of bin j+nbin_local] with the C bracket's
    one-line overshoot (kernels.c:196-227); remote extends nbin_remote
    bins each way.
    mode="line_sweep": local = centers within +-local_cutoff cm-1 of the
    bin (the reference's per-line bin walk, kernels.c:326-357, inverted);
    remote extends +-remote_cutoff cm-1.

    ``lines`` must be the unpadded catalog: the padding's sentinel
    centers would break the ``leftw > v[-1]`` test.
    """
    # Unshifted line centers in wavenumber units (float64, host).
    v = (np.asarray(lines.c0, np.float64)
         + np.asarray(lines.frac0, np.float64)) * bins.wres + bins.w0
    nl = lines.num_lines
    j = np.arange(bins.n)
    if mode == "bin_sweep":
        jl = np.maximum(j - nbin_local, 0)
        jr = np.minimum(j + nbin_local, bins.n - 1)
        leftw = bins.w[jl, 0]
        rightw = bins.w[jr, NIP - 1]
        jlr = np.maximum(j - nbin_remote, 0)
        jrr = np.minimum(j + nbin_remote, bins.n - 1)
        leftw_r = bins.w[jlr, 0]
        rightw_r = bins.w[jrr, NIP - 1]
        # C bracket semantics: local = [bracket_left(leftw),
        # bracket_right(rightw)] inclusive (one-line overshoot each side).
        llo = _bracket_left(v, leftw)
        lhi = _bracket_right(v, rightw)
        # Bins with no overlap at all get empty ranges (kernels.c:203-236);
        # the leftw > v[-1] branch sets left = num_lines so the remote-left
        # range then covers through the last line (kernels.c:229-232).
        nonempty = (leftw <= v[-1]) & (rightw >= v[0]) if nl else \
            np.zeros(bins.n, bool)
        llo = np.where(leftw > (v[-1] if nl else -np.inf), nl, llo)
        rlo = _bracket_left(v, leftw_r)
        rhi = _bracket_right(v, rightw_r)
        ne_l = (leftw >= v[0]) & (leftw_r <= v[-1]) if nl else \
            np.zeros(bins.n, bool)
        ne_r = (rightw <= v[-1]) & (rightw_r >= v[0]) if nl else \
            np.zeros(bins.n, bool)
    elif mode == "line_sweep":
        # Inverted per-line bin walk: line touches bins
        # [floor((v - cutoff - w0)/bw), floor((v + cutoff - w0)/bw)]
        # (kernels.c:326-357), so bin j's local lines have
        # v in [start_j - cutoff, end_of_bin_width_j + cutoff).
        bw = bins.wres * bins.ppb
        start = bins.w0 + j * bw
        llo = np.searchsorted(v, start - local_cutoff, side="left")
        lhi = np.searchsorted(v, start + bw + local_cutoff, side="left") - 1
        rlo = np.searchsorted(v, start - remote_cutoff, side="left")
        rhi = np.searchsorted(v, start + bw + remote_cutoff, side="left") - 1
        nonempty = lhi >= llo
        ne_l = rlo < llo
        ne_r = rhi > lhi
    else:
        raise ValueError(mode)

    local_lo = np.where(nonempty, llo, 0).astype(np.int32)
    local_cnt = np.where(nonempty, lhi - llo + 1, 0).astype(np.int32)
    rem_lo = np.where(ne_l, rlo, 0).astype(np.int32)
    rem_cnt_l = np.where(ne_l, llo - rlo, 0).astype(np.int32)
    # Remote-right starts just past the local range.
    rhs = np.where(nonempty, lhi + 1, llo)
    rem_hi_start = np.where(ne_r, rhs, 0).astype(np.int32)
    rem_cnt_r = np.where(ne_r, rhi - rhs + 1, 0).astype(np.int32)
    rem_cnt_r = np.maximum(rem_cnt_r, 0)

    def pad(x):
        m = int(x.max(initial=0))
        return max(-(-max(m, 1) // lane_multiple) * lane_multiple,
                   lane_multiple)

    return BinRanges(local_lo=local_lo, local_cnt=local_cnt, rem_lo=rem_lo,
                     rem_cnt_l=rem_cnt_l, rem_hi_start=rem_hi_start,
                     rem_cnt_r=rem_cnt_r, lmax_local=pad(local_cnt),
                     lmax_remote=pad(np.maximum(rem_cnt_l, rem_cnt_r)))


# ---------------------------------------------------------------------------
# Device accumulation (plain PyTorch)
# ---------------------------------------------------------------------------

# Elements of the largest (rows, bins, lines, points) tensor one step of
# the plain version builds; bounds its temporaries to a few hundred MB.
_PLAIN_BUDGET = 1 << 22


def _range_sum(cols, ns_scaled, lo, cnt, pts, lmax: int, dw):
    """Sum over each bin's line range [lo, lo + cnt) of S n K at the bin's
    evaluation points ``pts`` (nb, P): (rows, nb, P)."""
    cidx, cfrac, s, lor, dop = cols
    L = s.shape[1]
    ks = torch.arange(lmax, dtype=torch.int64, device=s.device)
    idx = lo[:, None] + ks                           # (nb, lmax)
    valid = ks < cnt[:, None]
    flat = idx.clamp(max=L - 1).reshape(-1)

    def take(a):
        return a.index_select(1, flat).view(a.shape[0], *idx.shape, 1)

    dv = ((pts[None, :, None, :] - take(cidx).to(torch.float32))
          - take(cfrac)) * dw
    k = voigt_line_shape(dv, take(lor), take(dop))
    contrib = torch.where(valid[None, :, :, None],
                          take(s) * ns_scaled * k, 0.0)
    return contrib.sum(dim=2)


def accumulate_bins(prep: PreparedLines, ns, ranges: BinRanges,
                    bins: SpectralBins, *, start_bin: int = 0,
                    nbins: int | None = None, tau0=None, bins_tau0=None):
    """One molecule's bin-method accumulation on the bin window
    ``[start_bin, start_bin + nbins)``: the plain version of the CUDA bin
    kernel (port of the JAX package's ``accumulate_bins``).

    Args:
      prep: PreparedLines (rows, L) of the lines the ranges index: the
        padded catalog, or a window of it with the ranges of
        :meth:`BinRanges.window`.
      ns: (rows,) species column density [cm-2].
      ranges / bins: host tables of the band.
      tau0: (rows, nbins * ppb) fine tau of the window; the local lines'
        exact Voigt is added in place.  Fine points past the grid end are
        left as they are.
      bins_tau0: (rows, nbins, NIP) coarse wings; the remote lines' Voigt
        at the bin's interpolation points is added in place.

    Bins past the band add nothing.  The JAX ``lax.map`` over bins is a
    loop over chunks of bins.  Returns ``(tau0, bins_tau0)``.
    """
    accumulate_bins.launches += 1
    rows = prep.strength.shape[0]
    device = prep.strength.device
    ppb = bins.ppb
    nbins = bins.n - start_bin if nbins is None else nbins
    f32 = torch.float32
    if tau0 is None:
        tau0 = torch.zeros((rows, nbins * ppb), dtype=f32, device=device)
    if bins_tau0 is None:
        bins_tau0 = torch.zeros((rows, nbins, NIP), dtype=f32, device=device)
    cols = (prep.center_idx, prep.center_frac, prep.strength, prep.lorentz,
            prep.doppler)
    ns_scaled = (ns.to(f32) / STRENGTH_SCALE)[:, None, None, None]
    dw = device_constant(bins.wres, device)
    key = ("plain", torch.device(device))     # the tables, copied once
    if key not in ranges._on_device:
        ranges._on_device[key] = (
            torch.as_tensor(ranges.bounds().astype(np.int64), device=device),
            torch.as_tensor(bins.w_rel, device=device))
    bnd, w_rel = ranges._on_device[key]
    pts_local = torch.arange(ppb, dtype=f32, device=device)
    per_bin = max(ranges.lmax_local * ppb, ranges.lmax_remote * NIP)
    step = max(1, _PLAIN_BUDGET // (rows * per_bin))
    for b0 in range(start_bin, min(start_bin + nbins, bins.n), step):
        b1 = min(b0 + step, start_bin + nbins, bins.n)
        llo, lend, rlo, rendl, rhs, rendr = bnd[:, b0:b1]
        base = (torch.arange(b0, b1, dtype=torch.int64, device=device)
                * ppb).to(f32)
        local = _range_sum(cols, ns_scaled, llo, lend - llo,
                           base[:, None] + pts_local, ranges.lmax_local, dw)
        # The last bin's fine points past the grid end are dropped.
        keep = max(0, min(ppb * (b1 - b0), bins.num_wpoints - b0 * ppb))
        f0 = (b0 - start_bin) * ppb
        tau0[:, f0:f0 + keep] += local.reshape(rows, -1)[:, :keep]
        wrel = w_rel[b0:b1]
        rem = _range_sum(cols, ns_scaled, rlo, rendl - rlo, wrel,
                         ranges.lmax_remote, dw) + \
            _range_sum(cols, ns_scaled, rhs, rendr - rhs, wrel,
                       ranges.lmax_remote, dw)
        bins_tau0[:, b0 - start_bin:b1 - start_bin] += rem
    return tau0, bins_tau0


accumulate_bins.launches = 0


def interpolate_bins(bins_tau, bin_l, bin_w_rel, *, ppb: int, last_ppb: int,
                     do_interp: bool, do_last_interp: bool,
                     num_wpoints: int, tau, bin0: int = 0,
                     last_bin: int | None = None):
    """Quadratic bin-wing interpolation onto the fine grid
    (kernels.c:514-581, kernel_utils.c:79-117), added into ``tau`` in place
    (the JAX function returns a new array; in place saves one fine-grid
    buffer) and returned.

    bins_tau: (rows, nbins, NIP); bin_l: (nbins,) first fine index per bin;
    bin_w_rel: (nbins, NIP) f32 interpolation positions in grid units.
    A step passes both as device tensors, which are used as they are.

    For a spectral block of bins, pass the block's rows of bins_tau /
    bin_l / bin_w_rel plus ``bin0`` (the block's first global bin index)
    and ``last_bin`` (the band's global last bin index) so the last-bin
    interpolation switch lands on the right bin; ``tau`` / ``num_wpoints``
    are then block-local.
    """
    rows, nbins, _ = bins_tau.shape
    if last_bin is None:
        last_bin = nbins - 1
    device = bins_tau.device
    f32 = torch.float32
    pts = torch.arange(ppb, dtype=f32, device=device)
    wrel, bl = (a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
                for a in (bin_w_rel, bin_l))             # an array-like
    wrel = wrel.to(device=device, dtype=f32)
    bl = bl.to(device=device, dtype=f32)
    # Per-bin fine positions (nbins, ppb), relative to x0 of the bin.
    p = (bl[:, None] + pts[None, :]) - wrel[:, 0:1]
    x1 = wrel[:, 1:2] - wrel[:, 0:1]
    x2 = wrel[:, 2:3] - wrel[:, 0:1]
    y = [bins_tau[:, :, i, None] for i in range(NIP)]

    def quad(p, x1, x2, y0, y1, y2):
        c0 = (p - x1) * (p - x2) / (x1 * x2)
        c1 = p * (p - x2) / (x1 * (x1 - x2))
        c2 = p * (p - x1) / (x2 * (x2 - x1))
        t = c0 * y0
        t += c1 * y1
        t += c2 * y2
        return t.clamp_(min=0.0)                  # (rows, nbins, ppb)

    def nearest(p, x1, x2, y0, y1, y2):
        # ppb <= 3: bin_no_interp copies bins.tau[k] to fine point k
        # verbatim (kernel_utils.c:108-117).
        k = p.to(torch.int32).clamp(0, NIP - 1)
        return torch.where(k == 0, y0, torch.where(k == 1, y1, y2))

    vals = (quad if do_interp else nearest)(p, x1, x2, *y)
    jl = last_bin - bin0
    if do_interp != do_last_interp and 0 <= jl < nbins:
        # The band's last bin (possibly short) switches rule; only that
        # bin is recomputed.
        one = slice(jl, jl + 1)
        vals[:, one] = (nearest if do_interp else quad)(
            p[one], x1[one], x2[one], *(v[:, one] for v in y))
    tau += vals.reshape(rows, nbins * ppb)[:, :num_wpoints]
    return tau
