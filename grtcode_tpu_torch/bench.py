"""Headline benchmark of the port: production-scale line-by-line throughput
on one GPU (counterpart of the repo's ``bench.py``, with its structure,
names and flags).

    python -m grtcode_tpu_torch.bench [--smoke] [--batch B] [--chunk C]
        [--method line_sample|wavenumber_sweep|line_sweep] [--lw-res R]
        [--lw-blocks N] [--profile] [--sweep-batch] [--device cuda:0|cpu]

Workload: the reference's RFMIP-IRF production configuration
(GRTworkflow/run-rfmip-irf.sh:104-125), built by
:func:`grtcode_tpu_torch.examples.rfmip_like`: 7 LW molecules (H2O CO2 O3
N2O CH4 CO O2) and 4 SW molecules at HITRAN2016-scale line counts
(~430k lines), H2O + O3 continua, 3 CFC cross sections, 3 CIA pairs, the LW
band 1-3250 cm-1 at 0.1 (32,491 points; ``--lw-res``) and the SW band
1-50,000 cm-1 at 1.0 (50,000 points), 54 layers, B = 32 columns, both
solvers, trapezoid-integrated fluxes.  One untimed first step (on the card
it loads, or at first use builds, the two CUDA kernels; a second one
captures the step's graph), then 10 timed
steps (2 with ``--smoke``) on the host clock ending in
``torch.cuda.synchronize()``.

The step (:func:`make_step`) is the JAX bench's own, captured on the card
as a CUDA graph as JAX jits it (``compile_first_s`` is then the eager
warm-up step and the step that captures and replays), not
``RadiationDriver.run``: emissivity
1, albedo 0.15, diffuse mu 0.5, the
surface 1.5 K above the bottom level, no day compaction, the LW band
streamed in ``--lw-blocks`` quantum-aligned blocks and the SW band not,
and a chain scalar ``rlu[0, 0] * 1e-30`` that the next step adds to the
level temperatures, so steps cannot overlap.

Metric: column x layer x wavenumber grid points per second over BOTH bands
(the JAX bench's metric).  The JSON line also gives the first step's time,
the peak device memory, and an estimate of the Voigt kernels' work: one
census per K1 / K2 launch of a step (:mod:`grtcode_tpu_torch.kernel_bench`:
samples by Humlicek region, operations per sample, the bytes each launch
must move), summed into operations and into the launches' least times on
the card (``kernel_bound_ms_per_step``).  ``est_tflops`` is those
operations per second of step time and ``est_share_of_f32_peak`` their
share of the card's f32 peak: the Voigt kernels' share, not the step's.
They are device rates and are left out on the CPU.  ``--profile`` traces
2 steps with ``torch.profiler`` and reports the kernels' measured time,
the device's busy time and its idle share of the steps' wall time.

Left out: the JAX bench's ``--shared-hw`` (one near-core window per band,
``shared_near_hw``) pads a TPU kernel signature; the CUDA kernels take the
window as an argument, so the port has no such option.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from . import constants, examples
from .kernel_bench import PEAK_F32_OPS, band_prep, card_line, k1_bound, \
    k2_bound
from .solvers.longwave import longwave_fluxes
from .solvers.rayleigh import rayleigh_tau
from .solvers.shortwave import shortwave_fluxes
from .utils import curtis_godson as cg
from .utils import graphs
from .utils.interp import block_trapezoid_weights, trapezoid_uniform

# The reference processes 1800 columns (100 sites x 18 experiments) through
# the same two-band configuration on 10 GAEA C5 nodes (128-core AMD) within
# the 15-minute SLURM budget (run-rfmip-irf.sh:18-28,104-125) => 1800 x
# (32491 + 50000) x 60 points / 9000 s ~= 9.9e5 grid points/s per node.
REF_POINTS_PER_S = 9.9e5
UNIT = "column*layer*wavenumber points/s (LW+SW)"
# The CUDA kernels' symbols in a profiler trace.
KERNEL_SYMBOLS = ("voigt_line_sample_kernel", "voigt_bins_kernel")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(smoke: bool = False, batch_size: int | None = None,
          lw_method: str = "line_sample", lw_res: float = 0.1, *, device):
    """The benchmark model and batch on ``device``: (lw_gas, sw_gas, solar,
    batch, B, nlayers), with ``batch`` numpy profiles; ``smoke`` shrinks
    the line counts 64x and the grids 8x."""
    return examples.rfmip_like(smoke, batch_size, device=device,
                               lw_method=lw_method, lw_res=lw_res)


def lw_block_size(lw_gas, lw_blocks: int) -> tuple[int, int]:
    """(points per LW block, number of blocks): ``lw_blocks`` blocks of a
    whole number of the gas optics' block quantum."""
    q, n = lw_gas.block_quantum, lw_gas.grid.n
    blk = -(-(-(-n // lw_blocks)) // q) * q
    return blk, -(-n // blk)


def default_lw_blocks(n: int) -> int:
    """``--lw-blocks``'s default for an LW band of ``n`` points: stream
    once the band outgrows ~40k points (the 0.01 cm-1 regime) in blocks of
    ~32k; the default 0.1 configuration keeps the single-block step."""
    return max(1, -(-n // 32768)) if n > 40000 else 1


def make_step(lw_gas, sw_gas, solar, lw_blocks: int = 1):
    """``step(p_lev, t_lev, vmr, cfc_vmr, cia_vmr, mu, tsi, chain) -> (rlu,
    rld, rsu, rsd, chain)`` on the gas optics' device: the JAX bench's
    step, in its expression order, with its inputs as numpy arrays (ppmv)
    and ``chain`` a 0-d f32 tensor added to ``t_lev``.

    On a CUDA device the step is the JAX bench's ``jax.jit``: per input
    shapes, eager at the first call, captured as a CUDA graph at the
    second (:mod:`.utils.graphs`) and replayed after that, the numpy
    inputs copied into its static tensors before each replay
    (``step.cache`` holds the captured steps).  On the CPU, and
    under :func:`.utils.debug.disable_jit`, it runs eagerly."""
    dev = lw_gas.device
    f32 = torch.float32
    lwg, swg = lw_gas.grid, sw_gas.grid
    w_lw, w_sw = lwg.wavenumbers(dev), swg.wavenumbers(dev)
    blk_lw, nblk = lw_block_size(lw_gas, lw_blocks)

    def t32(a):
        return torch.as_tensor(a, dtype=f32, device=dev)

    def body(inputs):
        p_lev, t_lev, vmr, cfc_vmr, cia_vmr, mu32, tsi, chain = inputs
        t_lev = t_lev + chain
        vmrf = {k: v * 1e-6 for k, v in vmr.items()}
        cfcf = {k: v * 1e-6 for k, v in cfc_vmr.items()}
        ciaf = {k: v * 1e-6 for k, v in cia_vmr.items()}
        t_layers = 0.5 * (t_lev[:, :-1] + t_lev[:, 1:])
        t_surf = t_lev[:, -1] + 1.5
        B_ = p_lev.shape[0]

        if nblk == 1:
            tau_lw = lw_gas.optical_depth(p_lev, t_lev, vmrf, cfc_vmr=cfcf,
                                          cia_vmr=ciaf, check=False)
            flu, fld = longwave_fluxes(
                tau_lw, torch.zeros_like(tau_lw), t_surf, t_layers, t_lev,
                torch.ones((B_, w_lw.shape[0]), dtype=f32, device=dev), w_lw)
            del tau_lw
            rlu = trapezoid_uniform(flu, lwg.dw)
            rld = trapezoid_uniform(fld, lwg.dw)
        else:
            rlu = torch.zeros((B_, p_lev.shape[1]), dtype=f32, device=dev)
            rld = torch.zeros_like(rlu)
            for i in range(nblk):
                start = i * blk_lw
                tau_b = lw_gas.optical_depth(
                    p_lev, t_lev, vmrf, cfc_vmr=cfcf, cia_vmr=ciaf,
                    block_start=start, block_size=blk_lw, check=False)
                flu, fld = longwave_fluxes(
                    tau_b, torch.zeros_like(tau_b), t_surf, t_layers, t_lev,
                    torch.ones((B_, blk_lw), dtype=f32, device=dev),
                    lwg.wavenumbers(dev, start, blk_lw))
                del tau_b
                wts = block_trapezoid_weights(start, blk_lw, lwg.n, lwg.dw,
                                              device=dev)
                rlu = rlu + (flu * wts).sum(-1)
                rld = rld + (fld * wts).sum(-1)
        del flu, fld

        sw_vmr = {k: v for k, v in vmrf.items() if k in sw_gas.molecules}
        tau_sw = sw_gas.optical_depth(p_lev, t_lev, sw_vmr, cfc_vmr=cfcf,
                                      cia_vmr=ciaf, check=False)
        ray = rayleigh_tau(
            cg.number_densities(p_lev * constants.MB_TO_ATM), w_sw)
        tau_tot = tau_sw + ray
        del tau_sw
        omega = ray / torch.clamp(tau_tot, min=1e-30)
        del ray
        alb = torch.full((B_, w_sw.shape[0]), 0.15, dtype=f32, device=dev)
        fsu, fsd = shortwave_fluxes(
            tau_tot, omega, torch.zeros_like(tau_tot), mu32,
            torch.full_like(mu32, 0.5), alb, alb, tsi,
            solar.incident_flux)
        rsu = trapezoid_uniform(fsu, swg.dw)
        rsd = trapezoid_uniform(fsd, swg.dw)
        return rlu, rld, rsu, rsd, rlu[0, 0] * 1e-30

    cache = graphs.StepCache()

    def step(p_lev, t_lev, vmr, cfc_vmr, cia_vmr, mu, tsi, chain):
        inputs = (t32(p_lev), t32(t_lev),
                  {k: t32(v) for k, v in vmr.items()},
                  {k: t32(v) for k, v in cfc_vmr.items()},
                  {k: t32(v) for k, v in cia_vmr.items()}, t32(mu),
                  t32(tsi), chain)
        # The limits on the levels as given (chain, ~1e-30 K, cannot move
        # a layer across them).
        for gas in {g.method: g for g in (lw_gas, sw_gas)}.values():
            gas.check_limits(inputs[0], inputs[1])
        return cache((), body, inputs,
                     label=f"bench step ({len(p_lev)} columns, {nblk} LW "
                           "blocks)")

    step.cache = cache
    return step


def slice_batch(batch: dict, lo: int, hi: int) -> dict:
    """The columns [lo, hi) of a batch of numpy profiles."""
    return {k: ({m: a[lo:hi] for m, a in v.items()} if isinstance(v, dict)
                else v[lo:hi]) for k, v in batch.items()}


def step_args(batch: dict) -> tuple:
    """A batch as :func:`make_step`'s arguments before ``chain``."""
    return (batch["p_lev"], batch["t_lev"], batch["vmr"], batch["cfc_vmr"],
            batch["cia_vmr"], batch["mu"], batch["tsi"])


def chunked_step(step_fn, batch: dict, chunk: int | None):
    """(step, args): ``step(*args, chain)`` runs the batch through
    ``step_fn`` whole (``chunk`` None) or in column slices of ``chunk``,
    each slice handing its chain to the next, and returns the last
    slice's outputs."""
    if not chunk:
        return step_fn, step_args(batch)
    slices = [step_args(slice_batch(batch, lo, lo + chunk))
              for lo in range(0, batch["p_lev"].shape[0], chunk)]

    def step(chain):
        for s in slices:
            out = step_fn(*s, chain)
            chain = out[4]
        return out
    return step, ()


def kernel_work(lw_gas, sw_gas, batch: dict, lw_blocks: int = 1,
                chunk: int | None = None) -> dict:
    """What the Voigt kernels of one step compute: a census of every K1
    and K2 launch (each column slice of ``chunk`` columns, each molecule,
    each LW block; the SW band in one block), turned into operations and
    each launch's least time on the card (``kernel_bench.k1_bound`` /
    ``k2_bound``): ``{"launches": {kernel: n}, "ops", "bound_ms"}``."""
    B = batch["p_lev"].shape[0]
    size = chunk or B
    launches = {"voigt_line_sample": 0, "voigt_bins": 0}
    ops = bound = 0.0
    for lo in range(0, B, size):
        part = slice_batch(batch, lo, lo + size)
        for gas, blocks in ((lw_gas, lw_blocks), (sw_gas, 1)):
            blk, nblk = lw_block_size(gas, blocks)
            if nblk == 1:
                blk = gas.grid.n   # make_step's unblocked call
            bins = gas.method in ("wavenumber_sweep", "line_sweep")
            for mol in gas.molecules:
                prep, _, kw = band_prep(gas, mol, part, gas.device)
                for i in range(nblk):
                    if bins:
                        b = k2_bound(prep, gas._get_bin_ranges(mol),
                                     gas.bins,
                                     start_bin=i * blk // gas.bins.ppb,
                                     nbins=-(-blk // gas.bins.ppb))
                        launches["voigt_bins"] += 1
                    else:
                        b = k1_bound(prep, gas.chunk_ranges[mol],
                                     **dict(kw, num_wpoints=blk),
                                     start=i * blk)
                        launches["voigt_line_sample"] += 1
                    ops += b["ops"]
                    bound += b["bound_ms"]
                del prep
    return {"launches": launches, "ops": ops, "bound_ms": bound}


def sweep_batch(device: str = "cuda:0") -> dict:
    """Run the bench at B in {16, 32, 64} in subprocesses (a run that fails
    or runs out of memory must not end the sweep), falling back to
    ``--chunk 16`` column slices when a whole-batch run fails.  Prints ONE
    JSON line whose value is the best configuration's throughput."""
    results = {}
    for B in (16, 32, 64):
        # The chunked fallback only differs from the whole-batch run when
        # the chunk is smaller than the batch.
        variants = [[]] if B <= 16 else [[], ["--chunk", "16"]]
        for extra in variants:
            cmd = [sys.executable, "-m", "grtcode_tpu_torch.bench",
                   "--batch", str(B), "--device", device] + extra
            label = f"B={B}" + ("+chunk16" if extra else "")
            print(f"sweep: {' '.join(cmd[1:])}", file=sys.stderr)
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=3600, cwd=ROOT)
            except subprocess.TimeoutExpired:
                print(f"sweep: {label} timed out", file=sys.stderr)
                continue
            if proc.returncode == 0 and proc.stdout.strip():
                try:
                    data = json.loads(proc.stdout.strip().splitlines()[-1])
                    results[label] = data["value"]
                except (ValueError, KeyError) as e:
                    print(f"sweep: {label}: unparseable output ({e})",
                          file=sys.stderr)
                    continue
                print(f"sweep: {label}: {data['value'] / 1e6:.1f} M pts/s",
                      file=sys.stderr)
                break
            print(f"sweep: {label} failed (rc={proc.returncode}): "
                  f"{proc.stderr.strip().splitlines()[-1:]}",
                  file=sys.stderr)
    if not results:
        raise SystemExit("sweep: every configuration failed")
    best = max(results, key=results.get)
    result = {"metric": "gridpoints_per_s_per_chip", "value": results[best],
              "unit": UNIT, "vs_baseline": results[best] / REF_POINTS_PER_S,
              "best_config": best, "sweep": results}
    print(json.dumps(result))
    return result


def _profile_kernels(step, args, chain, iters: int = 2):
    """Trace ``iters`` steps with ``torch.profiler`` and return (Voigt
    kernels' ms per step, device-busy ms per step, wall ms per step, top
    device ops), or None when the trace has no CUDA track (the CPU)."""
    if chain.device.type != "cuda":
        print("profile: no CUDA device track on the CPU; the profiled_* "
              "keys are left out", file=sys.stderr)
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(chain.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        c = chain
        for _ in range(iters):
            c = step(*args, c)[4]
        torch.cuda.synchronize(chain.device)
        wall_ms = 1e3 * (time.perf_counter() - t0) / iters
    # Each kernel's own device time, once (aten ops and host ranges, whose
    # device time is that of the kernels they launched, are skipped): the
    # kernels of one stream do not overlap, so their sum is the busy time.
    per_step = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        if e.self_device_time_total > 0:
            per_step[e.key] = per_step.get(e.key, 0.0) + \
                e.self_device_time_total / 1e3 / iters
    if not per_step:
        print("profile: the trace had no device ops; the profiled_* keys "
              "are left out", file=sys.stderr)
        return None
    kernel_ms = sum(v for n, v in per_step.items()
                    if any(s in n for s in KERNEL_SYMBOLS))
    top = sorted(per_step.items(), key=lambda kv: -kv[1])[:6]
    return kernel_ms, sum(per_step.values()), wall_ms, top


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=None,
                    help="columns per step (default 32; smoke 4)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="process the batch in column slices of this size "
                         "(bounds device memory at large B)")
    ap.add_argument("--sweep-batch", action="store_true",
                    help="benchmark B in {16,32,64} (subprocesses), report "
                         "the best")
    ap.add_argument("--method", default="line_sample",
                    choices=["line_sample", "wavenumber_sweep",
                             "line_sweep"],
                    help="LW gas-optics method (SW stays line_sample: "
                         "binned wings lose at 1 cm-1 resolution)")
    ap.add_argument("--lw-res", type=float, default=0.1,
                    help="LW grid resolution [cm-1] (production: 0.01)")
    ap.add_argument("--profile", action="store_true",
                    help="trace 2 steps with torch.profiler and report the "
                         "Voigt kernels' measured time")
    ap.add_argument("--lw-blocks", type=int, default=None,
                    help="stream the LW band in this many spectral blocks "
                         "inside one step (default: 1 up to 40,000 points, "
                         "else blocks of ~32k points)")
    ap.add_argument("--device", default="cuda:0",
                    help="torch device (default cuda:0; 'cpu' to run "
                         "without a GPU)")
    return ap


def main(argv=None, *, device=None) -> dict:
    """Run the bench (``device`` overrides ``--device``); prints ONE JSON
    line and returns it as a dict."""
    opts = parser().parse_args(argv)
    dev = torch.device(opts.device if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {dev}: no CUDA device; pass --device "
                         "cpu to run on the CPU")
    if opts.sweep_batch:
        return sweep_batch(str(dev))
    cuda = dev.type == "cuda"
    print(f"bench device: {dev}" + (f" ({card_line()})" if cuda else ""),
          file=sys.stderr)

    lw_gas, sw_gas, solar, batch, B, nlayers = build(
        opts.smoke, opts.batch, lw_method=opts.method, lw_res=opts.lw_res,
        device=dev)
    chunk = opts.chunk if opts.chunk and opts.chunk < B else None
    lw_blocks = opts.lw_blocks or default_lw_blocks(lw_gas.grid.n)
    n_lines = sum(m.num_lines for m in lw_gas.molecules.values()) + \
        sum(m.num_lines for m in sw_gas.molecules.values())
    print(f"catalog: {n_lines} lines, B={B}, layers={nlayers}, "
          f"lw n={lw_gas.grid.n} ({opts.method}"
          + (f", {lw_blocks} blocks" if lw_blocks > 1 else "")
          + f"), sw n={sw_gas.grid.n}"
          + (f", chunk={chunk}" if chunk else ""), file=sys.stderr)
    step_fn = make_step(lw_gas, sw_gas, solar, lw_blocks=lw_blocks)
    step, args = chunked_step(step_fn, batch, chunk)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(2 if cuda else 1):     # the warm-up; on the card, capture
        out = step(*args, torch.zeros((), dtype=torch.float32, device=dev))
    sync()
    compile_first_s = time.perf_counter() - t0
    what = "kernels loaded, warm-up, capture" if cuda else "kernels loaded"
    print(f"first step ({what}): {compile_first_s:.1f}s", file=sys.stderr)

    iters = 2 if opts.smoke else 10
    t0 = time.perf_counter()
    chain = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(iters):
        out = step(*args, chain)
        chain = out[4]
    sync()
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    del out

    points = B * nlayers * (lw_gas.grid.n + sw_gas.grid.n) * iters
    value = points / elapsed
    result = {"metric": "gridpoints_per_s_per_chip", "value": value,
              "unit": UNIT, "vs_baseline": value / REF_POINTS_PER_S,
              "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "ms_per_step": 1e3 * elapsed / iters,
              "compile_first_s": compile_first_s}
    if peak is not None:
        result["peak_hbm_gib"] = peak / 2 ** 30
    if opts.method != "line_sample":
        result["lw_method"] = opts.method
    if opts.lw_res != 0.1:
        # vs_baseline compares against the reference's 0.1 + 1.0 cm-1
        # production config; at other resolutions it is indicative only.
        result["lw_res"] = opts.lw_res
        result["lw_points"] = lw_gas.grid.n
    print(f"{iters} steps in {elapsed:.3f}s "
          f"({elapsed / iters * 1e3:.0f} ms/step)", file=sys.stderr)

    # The kernels' work, counted once, outside the timed window.
    t0 = time.perf_counter()
    work = kernel_work(lw_gas, sw_gas, batch, lw_blocks, chunk)
    print(f"census of {sum(work['launches'].values())} kernel launches: "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
    result["kernel_launches_per_step"] = work["launches"]
    result["kernel_bound_ms_per_step"] = work["bound_ms"]
    if cuda:
        tflops = work["ops"] * iters / elapsed / 1e12
        result["est_tflops"] = tflops
        result["est_share_of_f32_peak"] = tflops * 1e12 / PEAK_F32_OPS
        print(f"estimated {tflops:.2f} TFLOP/s in the Voigt kernels "
              f"({tflops * 1e12 / PEAK_F32_OPS:.1%} of the card's f32 "
              f"peak)", file=sys.stderr)
    else:
        print("est_tflops: a device rate, not measured on the CPU",
              file=sys.stderr)

    if opts.profile:
        prof = _profile_kernels(step, args, chain)
        if prof:
            k_ms, total_ms, wall_ms, top = prof
            result["profiled_kernel_ms_per_step"] = k_ms
            result["profiled_device_ms_per_step"] = total_ms
            # The device's idle share of the profiled steps' wall time.
            result["profiled_idle_share"] = 1.0 - total_ms / wall_ms
            if k_ms > 0:
                meas = work["ops"] / (k_ms * 1e-3) / 1e12
                result["profiled_tflops"] = meas
                result["profiled_share_of_f32_peak"] = \
                    meas * 1e12 / PEAK_F32_OPS
            print("profiled top device ops (ms/step): "
                  + ", ".join(f"{n[:60]}={v:.1f}" for n, v in top),
                  file=sys.stderr)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
