"""Work counts, bounds and A/B timing of the port's CUDA kernels.

The census counts what a kernel call has to compute at given inputs: the
(row, line, point) samples by Humlicek region, and how the kernel's walks
split them (zones for K1, block kinds for K2).  :func:`bound_ms` turns a
census into the least time the card could take: the larger of the bytes
over the memory rate and the f32 operations over the f32 rate, with the
operations counted per sample by region (:data:`OPS`); :func:`k3_bound`
does the same for DISORT's doubling kernel from its elements' needed
doublings.  ``chip_smoke.py`` reports them for the main path's shapes.

Run as a script, it times this package's kernels against those of another
checkout of the repo on the main path's shapes, in turns (other, this,
this, other), and checks whether the two give the same bits:

    git archive REV | tar -x -C build/other    # a git-ignored directory
    python -m grtcode_tpu_torch.kernel_bench --other build/other

The other checkout's package is imported under another name and launches
its kernels through its own dispatchers and tables, built from its own
sources into its own ``build/``; both versions get the same prepared
lines.  Results go to stdout and ``chiprun_out/kernel_bench.json``.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

from . import constants
from .gas_optics.voigt import humlicek_region

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet).
PEAK_F32_OPS = 67e12          # f32 operations per second, no tensor cores
PEAK_BYTES = 3.35e12          # device memory bytes per second

# f32 operations per sample (each add, multiply, compare-select and
# division one operation): x = ((g - cidx) - frac) dw repwid, x^2, the
# product with S n and the accumulation are 6 of every sample; then the
# region's own formula (voigt.humlicek_k) and its region tests.
# Classes: Humlicek regions 0-3, region 4 with |x| <= 18.1 y + 1.65 (4a)
# and beyond (4b), and the pure-Lorentz limit (y >= 70.55).
CLASSES = ("region0", "region1", "region2", "region3", "region4a",
           "region4b", "lorentz")
OPS = {"region0": 8, "region1": 16, "region2": 25, "region3": 30,
       "region4a": 120, "region4b": 208, "lorentz": 8}


def bound_ms(counts: dict, nbytes: float) -> dict:
    """The least time for ``counts`` samples by class moving ``nbytes``:
    ``{"bound_ms", "bound_by", "ops", "bytes"}``."""
    ops = float(sum(OPS[c] * float(counts.get(c, 0)) for c in CLASSES))
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": float(nbytes)}


def _classes(xi, y_true):
    """Class index (CLASSES order) of each sample."""
    y = y_true.clamp(max=70.0)
    abx = xi.abs()
    region = humlicek_region(abx, y)
    region = torch.where((region == 4) & (abx > 18.1 * y + 1.65), 5, region)
    return torch.where(y_true >= 70.55, 6, region)


def _count(cls, mask, counts):
    counts += torch.bincount(cls[mask], minlength=len(CLASSES))


def lines_reached(ranges, start_bin: int, nbins: int) -> int:
    """How many lines (first to last) the non-empty ranges of the bin
    window [start_bin, start_bin + nbins) reach: what K2 reads."""
    bnd = ranges.bounds()[:, start_bin:start_bin + nbins].astype(np.int64)
    lo, hi = bnd[0::2], bnd[1::2]
    live = hi > lo
    if not live.any():
        return 0
    return int(hi[live].max() - lo[live].min())


def line_sample_lines_reached(ranges, start: int, num_wpoints: int,
                              num_lines: int) -> int:
    """How many lines (first to last) the tiles of the block [start, start
    + num_wpoints) reach: what K1 reads for it."""
    t0, nt = start // ranges.tile, -(-num_wpoints // ranges.tile)
    z = ranges.zones()[t0:t0 + nt].astype(np.int64)
    z[:, 1] = np.minimum(z[:, 1], num_lines)
    live = z[:, 1] > z[:, 0]
    if not live.any():
        return 0
    return int(z[live, 1].max() - z[live, 0].min())


def _y_repwid(prep, sl):
    """(y unclamped, sqrt(ln2) / alpha_d) of the lines ``sl``."""
    repwid = constants.SQRT_LN2 / prep.doppler[:, sl]
    return repwid * prep.lorentz[:, sl], repwid


def _in_interval_count(lo, hi):
    """Number of integers in [lo, hi] (float tensors), 0 when empty."""
    return (torch.floor(hi) - torch.ceil(lo) + 1).clamp(min=0)


def census_line_sample(prep, ranges, *, num_wpoints: int, fsteps: int,
                       near: int, num_global: int, dw: float,
                       start: int = 0, line_chunk: int = 8192) -> dict:
    """What K1 computes on the block [start, start + num_wpoints): samples
    by class (near-core samples exactly, far-wing region-1 samples by
    counting the integer offsets inside the region-0 limit), (tile, line)
    pairs by zone times rows, and the (row, 32-point warp, line) triples in
    which a one-output-per-thread walk branches into the five-region
    Humlicek for some lanes only."""
    dev = prep.strength.device
    rows, L = prep.strength.shape
    counts = torch.zeros(len(CLASSES), dtype=torch.int64, device=dev)
    total = far1 = diverge = lor = 0
    end = min(start + num_wpoints, num_global) - 1
    for c in range(0, L, line_chunk):
        sl = slice(c, c + line_chunk)
        cidx = prep.center_idx[:, sl].to(torch.int64)
        frac = prep.center_frac[:, sl]
        y_true, repwid = _y_repwid(prep, sl)
        valid = (cidx >= 0) & (cidx < num_global) & (prep.strength[:, sl] > 0)
        lo = torch.clamp(cidx - fsteps, min=start)
        hi = torch.clamp(cidx + fsteps, max=end)
        window = torch.where(valid, (hi - lo + 1).clamp(min=0), 0)
        total += int(window.sum())
        lor += int(torch.where(y_true >= 70.55, window, 0).sum())
        for o in range(-near, near + 1):
            g = cidx + o
            m = valid & (g >= start) & (g <= end)
            xi = ((o - frac) * dw) * repwid
            _count(_classes(xi, y_true), m, counts)
        # Far wing: |g - cidx| in (near, fsteps] inside the region-0 limit
        # is region 1 (grid-edge clipping ignored: a few lines at most).
        y = y_true.clamp(max=70.0)
        lim = torch.sqrt(15100.0 + y * (40.0 - y * 3.6)) / (dw * repwid)
        d_lo, d_hi = frac - lim, frac + lim        # |d - frac| < lim
        right = _in_interval_count(torch.clamp(d_lo, min=near + 1),
                                   torch.clamp(d_hi, max=fsteps))
        left = _in_interval_count(torch.clamp(d_lo, min=-fsteps),
                                  torch.clamp(d_hi, max=-near - 1))
        in_lim = torch.where(valid & (y_true < 70.55), right + left, 0)
        far1 += int(in_lim.sum())
        # Warps of 32 points from the block start that the near core of a
        # (row, line) touches (each holds 1-31 near-core lanes).
        a = torch.clamp(cidx - near, min=start) - start
        b = torch.clamp(cidx + near, max=end) - start
        touch = torch.where(valid & (y_true < 70.55) & (b >= a),
                            b // 32 - a // 32 + 1, 0)
        diverge += int(touch.sum())
    by = dict(zip(CLASSES, counts.tolist()))
    by["region1"] += far1
    by["lorentz"] = lor
    by["region0"] = total - sum(by[c] for c in CLASSES[1:])
    # (tile, line) pairs by zone, from the tables of the block's tiles.
    t0, nt = start // ranges.tile, -(-num_wpoints // ranges.tile)
    z = ranges.zones()[t0:t0 + nt].astype(np.int64)
    if len(z):
        z[:, 1] = np.minimum(z[:, 1], L)
    core = np.clip(z[:, 5], z[:, 0], z[:, 1]) - np.clip(z[:, 4], z[:, 0],
                                                        z[:, 1])
    interior = sum(np.maximum(np.minimum(z[:, h], z[:, 1])
                              - np.maximum(z[:, l], z[:, 0]), 0)
                   for l, h in ((6, 7), (8, 9)))
    nearz = np.clip(z[:, 3], z[:, 0], z[:, 1]) - np.clip(z[:, 2], z[:, 0],
                                                         z[:, 1])
    all_pairs = np.maximum(z[:, 1] - z[:, 0], 0)
    zones = {"interior": int(interior.sum()) * rows,
             "core_adjacent": int(core.sum()) * rows,
             "edge": int((all_pairs - interior - core).sum()) * rows,
             "near_core_precompute": int(nearz.sum()) * rows}
    return {"samples": by, "samples_total": total, "zone_line_tiles": zones,
            "diverging_warp_lines": diverge}


def census_bins(prep, ranges, bins, *, start_bin: int, nbins: int) -> dict:
    """What K2 computes on the bin window: fine samples by class (exactly:
    each local line's points inside its region-0 limit, the rest region
    0), coarse samples (remote lines x 3 points), and the (row, 32-point
    tile, line) triples in which fine lanes split between region 0 and
    the other regions."""
    dev = prep.strength.device
    rows = prep.strength.shape[0]
    bnd = ranges.bounds().astype(np.int64)
    js = np.arange(start_bin, min(start_bin + nbins, bins.n))
    llo, lend = bnd[0, js], bnd[1, js]
    lmin, lmax = int(llo.min(initial=0)), int(lend.max(initial=0))
    n = max(lmax - lmin, 0)
    # Each local line's fine points: the bins whose local range holds it
    # form one run (the ranges are monotone in the bin).
    first = np.full(n, np.iinfo(np.int64).max)
    last = np.full(n, -1)
    for j, a, b in zip(js, llo - lmin, lend - lmin):
        if b > a:
            first[a:b] = np.minimum(first[a:b], j * bins.ppb)
            last[a:b] = np.maximum(last[a:b], min((j + 1) * bins.ppb,
                                                  bins.num_wpoints) - 1)
    has = torch.as_tensor(last >= 0, device=dev)[None, :]
    p_lo = torch.as_tensor(np.where(last >= 0, first, 0), device=dev)[None]
    p_hi = torch.as_tensor(last, device=dev)[None, :]
    sl = slice(lmin, lmax)
    y_true, repwid = _y_repwid(prep, sl)
    y = y_true.clamp(max=70.0)
    limx = torch.sqrt(15100.0 + y * (40.0 - y * 3.6))   # |x| bound
    lim = limx / (bins.wres * repwid)                    # in points
    cidx = prep.center_idx[:, sl].to(torch.int64)
    frac = prep.center_frac[:, sl]
    npts = torch.where(has, p_hi - p_lo + 1, 0).expand(rows, n)
    fine_total = int(npts.sum())
    live = has & (y_true < 70.55)
    counts = torch.zeros(len(CLASSES), dtype=torch.int64, device=dev)
    # Each line's reach in points; with the lines in descending order of
    # it, the lines that can have a sample at offset d (|d - frac| < lim,
    # |frac| <= 0.5) form a prefix, and each offset evaluates only those.
    reach = torch.where(live, lim, 0).amax(0)
    order = torch.argsort(reach, descending=True)
    reach_sorted = reach[order].cpu().numpy()
    cols = [t.index_select(1, order) for t in (cidx, frac, repwid, limx,
                                               y_true, live, p_lo, p_hi)]
    dmax = int(np.ceil(reach_sorted[0])) + 1 if n else 0
    for d in range(-dmax, dmax + 1):
        k = int(np.count_nonzero(reach_sorted >= abs(d) - 1))
        ci, fr, rw, lx, yt, lv, lo, hi = (t[:, :k] for t in cols)
        xi = ((float(d) - fr) * bins.wres) * rw
        m = lv & (ci + d >= lo) & (ci + d <= hi) & (xi.abs() < lx)
        _count(_classes(xi, yt), m, counts)
    by = dict(zip(CLASSES, counts.tolist()))
    by["lorentz"] = int(torch.where(y_true >= 70.55, npts, 0).sum())
    by["region0"] = fine_total - sum(by[c] for c in CLASSES[1:])
    # Tiles of 32 fine points whose lanes split between region 0 and the
    # rest: per (row, line), the tiles its inside-the-limit points touch.
    c = cidx.to(torch.float32) + frac
    a = torch.maximum(torch.ceil(c - lim).to(torch.int64), p_lo)
    b = torch.minimum(torch.floor(c + lim).to(torch.int64), p_hi)
    base = start_bin * bins.ppb
    touch = torch.where(live & (b >= a),
                        (b - base) // 32 - (a - base) // 32 + 1, 0)
    rem = (bnd[3, js] - bnd[2, js]) + (bnd[5, js] - bnd[4, js])
    return {"fine_samples": by, "fine_total": fine_total,
            "coarse_total": int(rem.sum()) * 3 * rows,
            "diverging_warp_lines": int(touch.sum())}


def k1_bound(prep, ranges, *, num_wpoints: int, fsteps: int, near: int,
             num_global: int, dw: float, start: int = 0) -> dict:
    """The census and bound of one K1 launch on the block [start, start +
    num_wpoints): the lines its tiles reach read once (5 f32 each per
    row), the column densities read once, tau read and written once."""
    rows, n_lines = prep.strength.shape
    cen = census_line_sample(prep, ranges, num_wpoints=num_wpoints,
                             fsteps=fsteps, near=near, num_global=num_global,
                             dw=dw, start=start)
    reached = line_sample_lines_reached(ranges, start, num_wpoints, n_lines)
    nbytes = 4 * rows * (5 * reached + 1 + 2 * num_wpoints)
    return dict(bound_ms(cen["samples"], nbytes), census=cen)


def k2_bound(prep, ranges, bins, *, start_bin: int, nbins: int) -> dict:
    """The census and bound of one K2 launch on the bin window: inputs read
    once, both buffers read and written once, the fine samples by class
    and every coarse sample at region 0's count (the remote lines lie >= 1
    cm-1 away: |x| >> 123 at these widths)."""
    from .gas_optics.bins import NIP

    rows = prep.strength.shape[0]
    cen = census_bins(prep, ranges, bins, start_bin=start_bin, nbins=nbins)
    samples = dict(cen["fine_samples"])
    samples["region0"] += cen["coarse_total"]
    reached = lines_reached(ranges, start_bin, nbins)
    nbytes = 4 * rows * (5 * reached + 1 + 2 * nbins * (bins.ppb + NIP))
    return dict(bound_ms(samples, nbytes), census=cen)


def k3_ops(h: int) -> dict:
    """f32 operations of DISORT's doubling kernel for one element with h
    streams a hemisphere (each add, multiply, division and exp one
    operation; a fused multiply-add two): ``step``, one executed doubling
    (six h x h products, four matrix-vector products, the LU with partial
    pivoting and its h + 1 right-hand sides, the elementwise updates and
    the attenuations); ``init``, the initializer's phase matrices and
    single-scattering operators; ``bytes``, an element's inputs (dtau,
    omega, k, 2h + 1 moments) read and its R, T, sr, st and d written
    once."""
    tri, sq = h * (h - 1) // 2, (h - 1) * h * (2 * h - 1) // 6
    solve = 2 * sq + tri + 4 * (h + 1) * tri + (h + 1) * h
    step = 12 * h ** 3 + 8 * h ** 2 + solve + 13 * h ** 2 + 20 * h
    moments = 2 * h + 1
    init = h * (5 + 4 * moments * h + 4 * moments + 4 * h)
    return {"step": step, "init": init,
            "bytes": 4 * (3 + moments + 2 * h * h + 2 * h + 1)}


def k3_bound(needed: int, elements: int, h: int) -> dict:
    """The bound of DISORT's doubling kernel on ``elements`` elements whose
    counts sum to ``needed`` doublings: only the needed steps counted (the
    steps a warp's lanes wait on a neighbour are the kernel's own loss)."""
    per = k3_ops(h)
    ops = needed * per["step"] + elements * per["init"]
    nbytes = elements * per["bytes"]
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": float(ops), "bytes": float(nbytes)}


# ---------------------------------------------------------------------------
# Measurement helpers (also used by chip_smoke.py)
# ---------------------------------------------------------------------------

def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def clocks() -> str:
    """SM clock, its maximum, memory clock, temperature and power draw as
    nvidia-smi reads them now (to tell a slow card from slow code)."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,clocks.mem,"
         "temperature.gpu,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True)
    if proc.returncode != 0:
        return f"not readable (nvidia-smi exit {proc.returncode})"
    return proc.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, reps):
    """Mean device time of ``fn()`` over ``reps`` runs (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def band_prep(gas, mol, batch, dev):
    """(PreparedLines, column densities, kernel arguments) of molecule
    ``mol`` of ``gas`` at the batch's B x nlayers rows, as
    GasOptics.optical_depth makes them."""
    from .gas_optics import lines
    from .utils import curtis_godson as cg

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    p2 = f32(batch["p_lev"]) * constants.MB_TO_ATM
    pavg, tavg = cg.layer_pressures_temperatures(p2, f32(batch["t_lev"]))
    psavg, ns = cg.partial_pressures_and_densities(
        p2, f32(batch["vmr"][mol] * 1e-6), cg.number_densities(p2))
    rows = pavg.numel()
    prep = lines.prepare(gas.molecules[mol], gas.grid, pavg.reshape(rows),
                         tavg.reshape(rows), psavg.reshape(rows),
                         tips=gas.tips)
    kw = dict(num_wpoints=gas.grid.n, dw=float(gas.grid.dw),
              fsteps=gas._fsteps, near=gas.near_steps[mol],
              num_global=gas.grid.n)
    return prep, ns.reshape(rows).contiguous(), kw


# ---------------------------------------------------------------------------
# A/B timing against another checkout of the repo
# ---------------------------------------------------------------------------

REPS = 2   # launches in each timed turn


def _import_other(root: str) -> str:
    """Import the ``grtcode_tpu_torch`` package of the checkout at ``root``
    as ``other_grtcode_tpu_torch`` and return that name.  Its dispatchers
    build its own kernel sources into ``root/build/``."""
    pkg = os.path.join(os.path.abspath(root), "grtcode_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "other_grtcode_tpu_torch", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return spec.name


class _Version:
    """One version of the package: its examples and its two dispatchers,
    which build their kernels at their first launch."""

    def __init__(self, package: str, label: str):
        self.label = label
        self.examples = importlib.import_module(f"{package}.examples")
        self.vk = importlib.import_module(f"{package}.gas_optics.voigt_kernel")
        self.bk = importlib.import_module(f"{package}.gas_optics.bins_kernel")


def _turns(other, this):
    """other, this, this, other: mean ms of each and the turns."""
    o = [cuda_ms(other, REPS)]
    t = [cuda_ms(this, REPS), cuda_ms(this, REPS)]
    o.append(cuda_ms(other, REPS))
    return float(np.mean(o)), float(np.mean(t)), o, t


def _compare(outs):
    """(bit-identical, max |difference|) of two versions' output lists."""
    a, b = outs.values()
    return (all(torch.equal(x, y) for x, y in zip(a, b)),
            max(float((x - y).abs().max()) for x, y in zip(a, b)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout of the repo")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: needs an NVIDIA GPU")
    from .gas_optics import bins as bm

    dev = torch.device("cuda", 0)
    card = card_line()
    other = _Version(_import_other(args.other), "other")
    this = _Version(__package__, "this")
    versions = (other, this)
    out = {"card": card, "clocks_idle": clocks(), "other": args.other,
           "k1": [], "k2": []}
    print(json.dumps({"card": card}), flush=True)

    def gases(**kw):
        """Each version's (lw, sw) gas optics of ``rfmip_like(**kw)``, and
        the batch."""
        made = {}
        for v in versions:
            lw, sw, _, batch, _, _ = v.examples.rfmip_like(device=dev, **kw)
            made[v.label] = (lw, sw)
        return made, batch

    def k1_case(gas, mol, batch, path, starts, size):
        """K1 of both versions on the blocks [s, s + size), s in starts;
        ``gas`` maps each version's label to its GasOptics of the band."""
        prep, ns, kw = band_prep(gas["this"], mol, batch, dev)
        ranges = gas["this"].chunk_ranges[mol]
        rows = ns.shape[0]
        a = dict(fsteps=kw["fsteps"], near=kw["near"],
                 num_global=kw["num_global"], dw=kw["dw"])
        tau = torch.zeros((rows, size), device=dev)

        def launch(v, s):
            v.vk.accumulate_voigt(prep, ns, gas[v.label].chunk_ranges[mol],
                                  num_wpoints=size, start=s, tau0=tau, **a)

        outs = {}
        for v in versions:
            outs[v.label] = []
            for s in starts:
                tau.zero_()
                launch(v, s)
                outs[v.label].append(tau.clone())
        same, diff = _compare(outs)
        del outs
        o_ms, t_ms, o, t = _turns(
            *(lambda v=v: [launch(v, s) for s in starts] for v in versions))
        cens = [census_line_sample(prep, ranges, num_wpoints=size, start=s,
                                   **a) for s in starts]
        samples = {c: sum(cen["samples"][c] for cen in cens)
                   for c in CLASSES}
        nbytes = sum(4 * rows * (5 * line_sample_lines_reached(
            ranges, s, size, prep.strength.shape[1]) + 1 + 2 * size)
            for s in starts)
        rec = dict(path=path, mol=mol, lines=prep.strength.shape[1],
                   rows=rows, blocks=len(starts), other_ms=o_ms, this_ms=t_ms,
                   other_turns=o, this_turns=t, bit_identical=same,
                   max_abs_diff=diff, census=cens[0], samples=samples,
                   **bound_ms(samples, nbytes))
        print(json.dumps({k: v for k, v in rec.items() if k != "census"}),
              flush=True)
        out["k1"].append(rec)

    def k2_case(gas, mol, batch, path, nb, S):
        """K2 of both versions on the first block of ``nb`` bins, then on
        the S blocks of a step."""
        prep, ns, _ = band_prep(gas["this"], mol, batch, dev)
        ranges, bins = gas["this"]._get_bin_ranges(mol), gas["this"].bins
        rows = ns.shape[0]
        fine = torch.zeros((rows, nb * bins.ppb), device=dev)
        coarse = torch.zeros((rows, nb, bm.NIP), device=dev)

        def launch(v, s):
            g = gas[v.label]
            v.bk.accumulate_bins_kernel(prep, ns, g._get_bin_ranges(mol),
                                        g.bins, start_bin=s * nb, nbins=nb,
                                        tau0=fine, bins_tau0=coarse)

        outs = {}
        for v in versions:
            fine.zero_()
            coarse.zero_()
            launch(v, 0)
            outs[v.label] = [fine.clone(), coarse.clone()]
        same, diff = _compare(outs)
        del outs
        o1, t1, _, _ = _turns(*(lambda v=v: launch(v, 0) for v in versions))
        o_ms, t_ms, o, t = _turns(
            *(lambda v=v: [launch(v, s) for s in range(S)] for v in versions))
        # The census and bound of each block (every coarse sample counted
        # at region 0's operations: the remote lines lie >= 1 cm-1 away).
        blocks = []
        for s in range(S):
            cen = census_bins(prep, ranges, bins, start_bin=s * nb, nbins=nb)
            samples = dict(cen["fine_samples"])
            samples["region0"] += cen["coarse_total"]
            nbytes = 4 * rows * (5 * lines_reached(ranges, s * nb, nb) + 1
                                 + 2 * nb * (bins.ppb + bm.NIP))
            blocks.append((cen, samples, nbytes))
        step_samples = {c: sum(b[1].get(c, 0) for b in blocks)
                        for c in CLASSES}
        rec = dict(path=path, mol=mol, lines=prep.strength.shape[1],
                   rows=rows, nbins=nb, block_other_ms=o1, block_this_ms=t1,
                   other_ms=o_ms, this_ms=t_ms, other_turns=o, this_turns=t,
                   bit_identical=same, max_abs_diff=diff,
                   census=blocks[0][0], step_samples=step_samples,
                   step_diverging=sum(b[0]["diverging_warp_lines"]
                                      for b in blocks),
                   **{f"block_{k}": v for k, v in
                      bound_ms(blocks[0][1], blocks[0][2]).items()},
                   **bound_ms(step_samples, sum(b[2] for b in blocks)))
        print(json.dumps({k: v for k, v in rec.items() if k != "census"}),
              flush=True)
        out["k2"].append(rec)

    made, batch = gases()
    for band, path in ((0, "lw0.1"), (1, "sw1.0")):
        gas = {label: pair[band] for label, pair in made.items()}
        for mol in gas["this"].molecules:
            k1_case(gas, mol, batch, path, [0], gas["this"].grid.n)
    del made
    S = 10   # the streamed step's blocks per band
    made, batch = gases(lw_method="wavenumber_sweep", lw_res=0.01)
    sw = {label: pair[1] for label, pair in made.items()}
    q = sw["this"].block_quantum
    size = -(-(-(-sw["this"].grid.n // S)) // q) * q
    for mol in sw["this"].molecules:
        k1_case(sw, mol, batch, "sw1.0-streamed",
                [s * size for s in range(S)], size)
    lw = {label: pair[0] for label, pair in made.items()}
    q = lw["this"].block_quantum
    nb = -(-(-(-lw["this"].grid.n // S)) // q) * q // lw["this"].bins.ppb
    for mol in lw["this"].molecules:
        k2_case(lw, mol, batch, "lw0.01-streamed", nb, S)
    out["clocks_after"] = clocks()
    for key in ("k1", "k2"):
        recs = out[key]
        out[f"{key}_per_step"] = {
            p: {f: sum(r[f] for r in recs if r["path"] == p)
                for f in ("other_ms", "this_ms", "bound_ms")}
            for p in sorted({r["path"] for r in recs})}
    out["all_bit_identical"] = all(r["bit_identical"]
                                   for r in out["k1"] + out["k2"])
    print(json.dumps({"card": card, "clocks_after": out["clocks_after"],
                      "k1_per_step": out["k1_per_step"],
                      "k2_per_step": out["k2_per_step"],
                      "all_bit_identical": out["all_bit_identical"]}),
          flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "kernel_bench.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)


if __name__ == "__main__":
    main()
