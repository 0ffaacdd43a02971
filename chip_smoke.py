#!/usr/bin/env python3
"""Smoke run of the PyTorch port (grtcode_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

builds the three CUDA kernels from csrc/ with nvcc (K1, line_sample Voigt;
K2, the bin-method Voigt; K3, DISORT's layer doubling) and drives the port's main paths,
``RadiationDriver(lw_gas, sw_gas, solar).run(atm)`` on a clean, clear
atmosphere with line_sample at LW 0.1 cm-1 and with the bin method at the
production LW 0.01 cm-1 streamed through 10 spectral blocks, the
all-sky step (aerosols, stochastic clouds, half the columns at night) at
LW 0.1, the CIRC app with both SW solvers, the line_sample step over
(columns x spectral) meshes of ranks with the all-sky cell's per-node
segments, the metrics, debug and C ABI modules, the library path
built by hand from the public imports, the RFMIP-IRF and cloudy ERA5
apps with their netCDF files read and written by the port's own HDF5 IO,
the float64 solver check, the scatter method (GasOptics(method="scatter"),
the independent line_sample sum K1 is held to), and the captured steps, in
seventeen phases (one line each).  Every driver step on the
card runs eagerly at the first call of its key (its warm-up), is captured
as a CUDA graph at the second and is replayed after that
(grtcode_tpu_torch/utils/graphs.py); the profiled steps, which read the
line-prep, cloud-optics and DISORT ranges, run eagerly under
debug.disable_jit:

  1. the card: name and power limit as nvidia-smi gives them (on a line
     of their own, then the phase line with the torch / CUDA versions and
     the clocks, temperature and power draw; phase 5 reads them again
     under load);
  2. the three kernels (one nvcc each), the native .par scanner and the
     C ABI shim (one g++ each) built at once, timed, with ptxas's register
     / spill report;
  3. K1 against its plain PyTorch version on the card: one
     synthetic molecule on the 1-3250 cm-1 grid at 0.1 cm-1, 4 x 54 rows,
     full block and a block with start > 0 at rtol 2e-6, atol 1e-12, two
     kernel runs bit-identical, every Humlicek region and the
     pure-Lorentz limit exercised;
  4. the reference-C golden (tests/data/driver_golden.txt, CSAF rows) at
     1e-4 with the golden test's floor rule;
  5. the full-width RFMIP-IRF configuration (examples.rfmip_like: 32 x 54
     rows, 32,491 + 50,000 points, 11 molecules): one untimed and three
     timed steps, 11 kernel launches per step, physical checks; then the
     kernel against the plain version at the main path's shapes (1,728
     rows; LW O2 on the 0.1 cm-1 grid with fsteps 250, SW H2O on the
     1.0 cm-1 grid with fsteps 25) at rtol 2e-6, atol 1e-12, timed, and
     LW O3 timed alone; each with its census (samples by Humlicek region,
     (line, tile) pairs by zone) and its bound
     (grtcode_tpu_torch.kernel_bench);
  6. K2 against its plain version on the card at rtol 2e-5 / atol 2e-6 x
     max: a synthetic molecule on 1-3250 cm-1 at 0.1 in both modes
     (bin_sweep, line_sweep), full band and a window at start_bin > 0; a
     light molecule at 30,000-30,060 cm-1 whose remote lines fall inside
     Humlicek regions 1-4; two kernel runs bit-identical;
  7. the reference-C bins golden (tests/data/bins_golden.txt) through
     GasOptics(method=...) on the card, both methods, rtol 2e-3 / atol
     1e-7;
  8. the full-width streamed bin-method step (examples.rfmip_like with
     lw_method="wavenumber_sweep", lw_res=0.01: 324,901 + 50,000 points,
     spectral_chunks=10): one untimed and three timed steps, 70 K2 and 40
     K1 launches per step and no plain launch, physical checks, a profiled
     step (each kernel's share, the line prep's, the idle share) and the
     step's host-device synchronisations by source line; then K2 against
     its plain version at the main path's shapes (1,728 rows, LW O2 at 0.01
     over one full LW block), timed, with its census and bound;
  9. the all-sky step: (a) the reference-C golden's 12 rows (CSAF at 1e-4,
     CS and AF at 1e-3) through examples.golden_case(sky="all"); (b)
     examples.allsky_like() (the phase-5 model with Angstrom aerosols, an
     ERA5-like cloud field in one stochastic subcolumn, 16 of 32 columns at
     night): one untimed and three timed steps of the three tiers, 18 K1
     launches per step (7 LW + 4 SW for the lit columns, 7 LW for the
     night ones) and no plain launch; (c) a profiled step: K1, line prep,
     cloud optics (the ``grtcode::cloud_optics`` range) and the rest, the
     idle share, and K1's bound on the step (one census per launch); (d) column_chunk=8 equal to the whole batch in every
     tier (rtol 2e-6 / atol 1e-6), AF unlike CSAF, night SW exactly 0, the
     step's cloud draws on the card bit-identical to the CPU's;
 10. the CIRC app (apps.circ.main on case 1) at its default grids (LW
     1-3,250 at 0.1, SW 1-50,000 at 1.0) on a HITRAN-scale .par written
     from examples.line_lists (430,000 records): (b) two-stream, timed
     with the .par parse apart (all 14 parses by the native scanner, none
     in Python; then one parse of the file's H2O lines by each path, in
     turns), 14 K1 launches and no plain launch,
     RSDTCSAF within 1.0 W m-2 of TSI mu0, fluxes finite and non-negative;
     (c) the same driver with the 16-stream DISORT: one untimed and three
     timed steps, one K3 launch a 2,048-point block of the SW band (25 a
     step) and none of the masked loop, RSDTCSAF equal to the
     two-stream's, RSU / RSD within the two-stream band, LW unchanged, a
     profiled step, peak memory; K1
     against its plain version on the app's own 54 rows (H2O in each band)
     at rtol 2e-6 / atol 1e-12; (d) DISORT's analytic cases on the card at
     tests/test_disort.py's bars, card against CPU (bar 1e-4 of the
     level's largest flux), and one block of 32 columns timed with its
     peak memory; (e) K3 against its plain version (the masked loop) on
     the card at the main path's blocks, 1 x 54 x 2,048, 1 x 54 x 848 and
     32 x 54 x 2,048 at 16 streams, counts 0-37: R, T, sr, st and d
     within DISORT_TOL of each layer's largest entry, one launch each,
     the needed steps equal, each timed with its bound (kernel_bench.
     k3_bound, from the needed doublings);
 11. the mesh and the segments: (a) a world of one NCCL rank on cuda:0,
     the line_sample cell of phase 5 on make_mesh(1, 1), bit-identical to
     run(); (b) two spawned ranks, both on cuda:0 in a gloo group (NCCL
     refuses two ranks on one GPU), the same cell on meshes (1 x 2),
     bit-identical to run(spectral_chunks=2), and (2 x 1), within rtol
     1e-6 of run(); then run_driver_segment writes two segments of the
     all-sky cell (each rank a node), combined byte-identical to the same
     segments in one process and within rtol 1e-6 of the whole batch;
     each run's wall time, peak memory and K1 launches per rank;
 12. the aux modules: Metrics over three line_sample steps (points/s as
     phase 5 counts them), a profiler_trace under build/ with its K1
     kernels, debug_mode on a clean step (no trap) and on one NaN
     temperature (a trap), and the C ABI through ctypes on cuda:0
     (grt_create_device(0)): H2O optical depth from a .par, LW fluxes and
     Rayleigh + gas SW fluxes, bit-identical to the port's direct calls;
 13. the library path: (a) phase 5's model and atmosphere through
     grtcode_tpu_torch.drive.clear_sky_step, the CSAF step built by hand
     from the public imports (GasOptics.optical_depth per band, 11 K1
     launches counted through the dispatcher, Optics.from_tau with its
     grid, rayleigh_optics, +, longwave_fluxes / shortwave_fluxes,
     trapezoid_uniform), timed with its peak memory, held against
     RadiationDriver.run on the same atmosphere within 1e-6 of each
     level's largest flux (bit-identity is the aim); (b) Optics.sample
     from the LW 0.1 grid to its 1.0 sub-grid equal to tau[..., ::10] on
     the card, as views; (c) the verify recipe's five physics invariants
     on one synthetic column (drive.physics_invariants), each value
     printed beside its bar;
 14. the apps with file IO (grtcode_tpu_torch/utils/hdf5.py, no h5py):
     (a) the h5py-written fixtures of tests/data/torch_ncio/ read bit for
     bit equal to their .npz values; (b) an RFMIP-IRF input at the real
     file's size (100 sites x 18 experiments x 61 levels,
     examples.write_rfmip_input) written by the port, apps.rfmip.main on
     phase 10's .par and tables at the default grids, experiment 0 over
     all sites (6,000 rows), -integrated -o: wall time with the parses
     apart, the step, the peak; 14 K1 launches (7 LW + 7 SW: the 80 lit
     sites' bucket is the whole batch, so it runs with the day mask, as
     in JAX) and no plain launch; the file read
     back equal to the run's fluxes bit for bit; the app's one run is
     the step's eager warm-up: a second run captures its graph and a
     third replays it, each equal to the app's fluxes bit for bit, the
     process reserving at most 1.15x what the app reserved; K1 against its plain
     version on LW O2 at the 6,000 rows (rtol 2e-6, atol 1e-12); (c) the
     cloudy ERA5 app (-sw, -liquid-path / -ice-path tables written by the
     port) on a 1 x 8 x 16-column, 37-level snapshot
     (examples.write_era5_inputs, half the columns at night): the file
     read back, written fluxes finite, variables only defined at the fill
     value with no storage; (d) the phase's wall time on a line of its
     own;
 15. the float64 check alone: x64_validate on the card (20 float64
     comparisons within 3e-8 of the f64 reference-C goldens);
 16. the scatter method (gas_optics/optical_depth.py): (a) each band of
     the full-width model (examples.rfmip_like: LW 366,000 lines on
     32,491 points at 0.1, SW 64,000 on 50,000 at 1.0) on SCATTER_COLUMNS
     (4) x 54 rows, by GasOptics(method="scatter") built from the same
     catalogs and by K1 (11 launches), each timed, with scatter's lines
     per step and peak memory, and the two band taus' distance; then each
     molecule's line sum by K1, by scatter in f32 and by scatter summed in
     float64: K1 within rtol 2e-6 / atol 1e-12 of the float64 sum beyond
     the f32 scatter's own distance from it (no f32 sum of thousands of
     lines a point holds 2e-6 of the exact one); (b) a column at T + 300
     K and p x 2, beyond the line_sample tables' limits: line_sample
     refuses it, naming method="scatter", and on its bottom rows each
     molecule's float64 scatter sum on the card equals the CPU's from the
     same inputs (rtol 2e-6 / atol 1e-12); (c) a RadiationDriver step
     with both bands on scatter at smoke size, card against CPU at 1e-4;
 17. the captured steps, read inside phases 5, 8, 9 and 10 for each
     of their paths (the driver at 0.1, streamed at 0.01, all-sky, CIRC
     two-stream and 16-stream DISORT): graph,
     from empty caches, the eager warm-up step and the step that captures,
     then graph, eager (debug.disable_jit), graph in turns, each timed;
     the replays bit-identical to the eager step (DISORT may instead hold
     the golden's 1e-4, cuBLAS and cuSOLVER choosing their algorithms at
     capture); no new capture; the K1 / K2 / K3 launches of a replayed
     step equal the eager step's; a profiled replay (busy, idle); no
     host-device sync inside a replay, and those of the whole step;
     warm-up and capture seconds; the memory the warm-up and the capture
     reserve (torch.cuda.max_memory_reserved, the allocator as the user
     has it) at most 1.15x what the eager step reserves.  Phase 14's
     RFMIP-IRF step is read in phase 14: the app's run is its warm-up,
     and a second run captures and a third replays, each bit-identical to
     the app's fluxes, the capture's reserve at most 1.15x the app's
     step's.

Prints a kernels JSON line and, last, ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero without that line; there is no CPU
fallback.  Details go to chiprun_out/chip_smoke.json.
"""
import json
import os
import sys
import tempfile
import time

import numpy as np

from grtcode_tpu_torch.kernel_bench import (band_prep, card_line,
                                            census_line_sample, clocks,
                                            cuda_ms, k1_bound, k2_bound)

TOL_KERNEL = dict(rtol=2e-6, atol=1e-12)   # tests/test_pallas.py:96
TOL_BIN_KERNEL = dict(rtol=2e-5, atol=2e-6)  # x max; test_bins_pallas.py:88
TOL_GOLDEN = 1e-4                          # tests/test_driver_golden.py:40
TOL_BINS_GOLDEN = dict(rtol=2e-3, atol=1e-7)  # tests/test_bins.py:59
TOL_GOLDEN_TIERS = 1e-3                    # tests/test_driver_golden.py:203
TOL_CHUNK = dict(rtol=2e-6, atol=1e-6)     # tests/test_framework.py:190
# A column shard against the whole batch: the reductions over the
# wavenumber axis may split their sums differently at another batch size.
TOL_MESH_COLUMNS = 1e-6
# Phase 13: the hand-built step against RadiationDriver.run, of each
# level's largest flux over the columns.
TOL_LIBRARY = 1e-6
# Phase 16: the columns of the full-width model on which K1 is held to the
# scatter sum.  Scatter evaluates every (row, line, offset) sample: 1.8e8
# samples a row at LW 0.1, so 32 columns take minutes for each sum.
SCATTER_COLUMNS = 4
# Phase 16 (b): the hot, dense column (T + 300 K, p x 2, as
# tests/test_torch_optical_depth.py), and its bottom rows that the CPU
# also computes.
HOT_DT, HOT_P = 300.0, 2.0
HOT_ROWS = {"LW": 1, "SW": 8}
MESH_TIMEOUT_S = 300.0   # phase 11's process groups, start to end
BUILD_DIR = os.path.join("build", "chip_smoke")
REPLACES = "grtcode_tpu/gas_optics/pallas_kernels.py:247"
SOURCE = "grtcode_tpu_torch/csrc/voigt_line_sample.cu"
REPLACES_K2 = "grtcode_tpu/gas_optics/bins_pallas.py:215"
SOURCE_K2 = "grtcode_tpu_torch/csrc/voigt_bins.cu"
SOURCE_K3 = "grtcode_tpu_torch/csrc/disort_doubling.cu"
KERNEL_NAMES = {"voigt_line_sample": "voigt_line_sample_kernel",
                "voigt_bins": "voigt_bins_kernel",
                "disort_doubling": "disort_doubling_kernel"}
# K3 against its plain version, of each layer's largest entry
# (tests/test_torch_gpu.py's DISORT_TOL).
DISORT_TOL = 1e-5


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def share_of_bound(got, want, rtol, atol):
    """(max |got - want|, worst |got - want| / (atol + rtol |want|), where
    the worst is and the two values there): the allclose rule, <= 1
    passes."""
    err = (got - want).abs()
    share = err / (atol + rtol * want.abs())
    i = int(share.argmax())
    idx = np.unravel_index(i, tuple(got.shape))
    where = (f"at {tuple(int(v) for v in idx)}: {float(got.flatten()[i]):.9e}"
             f" vs {float(want.flatten()[i]):.9e}")
    return float(err.max()), float(share.max()), where


def profile_step(step, eager=True):
    """Device time of one profiled step by kernel (torch.profiler): each
    CUDA kernel of the port's own and its share of the busy time, the
    kernels launched inside the cloud-optics and DISORT ranges, the
    device's idle share of the step's wall time, and the top kernels.
    The ranges are recorded only where the step's Python code runs, so
    the step runs eagerly (debug.disable_jit) unless ``eager`` is False
    (a replayed graph: kernels, busy and idle time, no ranges)."""
    import contextlib
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from grtcode_tpu_torch.utils import debug, metrics

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            (debug.disable_jit() if eager else contextlib.nullcontext()):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows = []
    prep_ms = prep_span_ms = 0.0
    prep_count = 0
    # The kernels launched inside each host-side range: every op below the
    # range's host event adds the kernels it launched itself, so each
    # kernel counts once.
    ranged = {metrics.CLOUD_OPTICS: ["cloud optics", 0.0, 0],
              metrics.DISORT: ["DISORT", 0.0, 0]}
    for e in prof.events():
        if e.name in ranged and e.device_type != DeviceType.CUDA:
            ranged[e.name][2] += 1
            below = list(e.cpu_children)
            while below:
                c = below.pop()
                ranged[e.name][1] += c.self_device_time_total / 1e3
                below.extend(c.cpu_children)
    for e in prof.key_averages():
        if e.key in ranged:
            continue
        if e.key == metrics.LINE_PREP:
            # The range appears twice: on the host, whose device time is
            # that of the kernels launched inside it, and as a device-side
            # annotation spanning first to last kernel, gaps included.
            if e.device_type == DeviceType.CUDA:
                prep_span_ms += e.device_time_total / 1e3
            else:
                prep_ms += e.device_time_total / 1e3
                prep_count += e.count
            continue
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue                             # kernels only, no aten ops
        us = e.self_device_time_total
        if us > 0:
            rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    if busy_ms == 0:
        return {"summary": "no device time in the trace (not measured)",
                "wall_ms": wall_us / 1e3}
    kernel_ms = {name: sum(r[1] for r in rows if sym in r[0])
                 for name, sym in KERNEL_NAMES.items()}
    shares = ", ".join(f"{name} {ms:.1f} ms ({ms / busy_ms:.1%} of busy)"
                       for name, ms in kernel_ms.items() if ms > 0)
    prep = (f"line prep ({prep_count} calls) {prep_ms:.1f} ms of kernels "
            f"({prep_ms / busy_ms:.1%} of busy) spanning {prep_span_ms:.1f} "
            f"ms on the device" if prep_ms > 0 else
            "line prep: no device time attributed (not measured)")
    for label, ms, count in ranged.values():
        if count:
            prep += (f", {label} ({count} calls) {ms:.1f} ms of kernels "
                     f"({ms / busy_ms:.1%} of busy)")
    cloud_ms, cloud_count = ranged[metrics.CLOUD_OPTICS][1:]
    disort_ms, disort_count = ranged[metrics.DISORT][1:]
    rest_ms = busy_ms - sum(kernel_ms.values()) - prep_ms - cloud_ms - \
        disort_ms
    launches = sum(r[2] for r in rows)
    summary = (f"device busy {busy_ms:.1f} ms of {wall_us / 1e3:.1f} ms wall "
               f"(idle {1 - busy_ms * 1e3 / wall_us:.1%}) in {launches} "
               f"kernel launches, {shares}, {prep}, "
               f"the rest {rest_ms:.1f} ms ({rest_ms / busy_ms:.1%} of busy)")
    return {"summary": summary, "wall_ms": wall_us / 1e3,
            "busy_ms": busy_ms, "idle_share": 1 - busy_ms * 1e3 / wall_us,
            "launches": launches,
            "kernel_ms": kernel_ms,
            "line_prep_ms": prep_ms, "line_prep_span_ms": prep_span_ms,
            "line_prep_calls": prep_count, "cloud_optics_ms": cloud_ms,
            "cloud_optics_calls": cloud_count, "disort_ms": disort_ms,
            "disort_calls": disort_count, "rest_ms": rest_ms,
            "top": [dict(name=n[:80], ms=v, count=c) for n, v, c in rows[:12]]}


def count_syncs(step):
    """The host-device synchronisations of one ``step()``, by the line
    that made them (``torch.cuda.set_sync_debug_mode``): at each, the host
    waits for the card to drain its queue, and the card then idles until
    the host has queued the next kernel."""
    import collections
    import warnings
    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    where = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return sum(where.values()), where.most_common(8)


def _flat(out):
    """The tensors of a step's result (FluxResults, dict or tuple) in a
    fixed order, by name."""
    import torch
    if hasattr(out, "tiers"):
        out = out.tiers
    if isinstance(out, torch.Tensor):
        return {"": out}
    items = out.items() if isinstance(out, dict) else enumerate(out)
    flat = {}
    for k, v in items:
        for sub, t in _flat(v).items():
            flat[f"{k}/{sub}" if sub else str(k)] = t
    return flat


def replay_syncs(step):
    """(host-device synchronisations inside the graph replays of one
    ``step()``, in the whole step, the whole step's sites): the replays'
    copies in, graph launches and clones out are watched apart."""
    import warnings
    import torch
    from grtcode_tpu_torch.utils import graphs

    call = graphs.CapturedStep.__call__
    inside = []

    def watched(self, inputs):
        outer = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return call(self, inputs)
            finally:
                torch.cuda.set_sync_debug_mode(outer)
                inside.extend(w for w in caught
                              if "synchroniz" in str(w.message))

    graphs.CapturedStep.__call__ = watched
    try:
        outside, sites = count_syncs(step)
    finally:
        graphs.CapturedStep.__call__ = call
    return len(inside), outside + len(inside), sites


def graph_turns(info, name, step, caches, tol=None):
    """Phase 17's reading of one path, taken in its own phase: ``step()``
    runs one step through the StepCaches ``caches``.  From empty caches:
    the warm-up step (eager) and the step that captures and replays, with
    the memory they reserve; then in turns: replay, the eager step
    (debug.disable_jit), replay; the replays bit-identical to the eager
    step (or, with ``tol`` = (bar, reason), within the path's golden bar
    for the reason given); no new capture; the K1 / K2 / K3 launches of
    each replayed step equal the eager step's; one more replay with its host
    syncs counted (none inside a replay).  The memory the warm-up and the
    capture reserve, at most 1.15x what the eager step reserves."""
    import torch
    from grtcode_tpu_torch.gas_optics import bins_kernel as bk
    from grtcode_tpu_torch.gas_optics import voigt_kernel as vk
    from grtcode_tpu_torch.solvers import disort
    from grtcode_tpu_torch.utils import debug

    def counts():
        return (vk.accumulate_voigt.launches,
                bk.accumulate_bins_kernel.launches,
                disort.layer_operators.launches)

    def entries():
        return [e for c in caches for e in c.entries.values()]

    def run(eager):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if eager:
            with debug.disable_jit():
                out = step()
        else:
            out = step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return (_flat(out), dt,
                tuple(a - b for a, b in zip(counts(), before)))

    def reserving():
        """Reset the peaks with the allocator's cache given back: (the
        bytes reserved, allocated) now."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_reserved(), torch.cuda.memory_allocated()

    for cache in caches:
        cache.clear()
    res0, alloc0 = reserving()
    _, warm_s, _ = run(False)            # the warm-up, eagerly
    check(not entries(), f"phase 17 {name}: a graph at the first call")
    _, capture_run_s, _ = run(False)     # captures and replays
    graph_res = torch.cuda.max_memory_reserved() - res0
    graph_peak = torch.cuda.max_memory_allocated() - alloc0
    n_entries = len(entries())
    check(n_entries > 0, f"phase 17 {name}: no captured graph")
    g1, tg1, lg1 = run(False)
    res0, alloc0 = reserving()
    eager, te, le = run(True)
    eager_res = torch.cuda.max_memory_reserved() - res0
    eager_peak = torch.cuda.max_memory_allocated() - alloc0
    g2, tg2, lg2 = run(False)
    check(len(entries()) == n_entries, f"phase 17 {name}: a replay "
          f"captured again ({n_entries} -> {len(entries())} graphs)")
    check(lg1 == lg2 == le, f"phase 17 {name}: K1 / K2 / K3 launches per "
          f"replayed step {lg1}, {lg2}, per eager step {le}")
    check(list(g2) == list(eager), f"phase 17 {name}: outputs differ")
    same = all(torch.equal(g1[k], eager[k]) and torch.equal(g2[k], eager[k])
               for k in eager)
    worst = 0.0
    if not same:
        check(tol is not None, f"phase 17 {name}: the replay is not "
              "bit-identical to the eager step")
        worst = max(worst_rel(g[k].cpu().numpy(), eager[k].cpu().numpy())
                    for g in (g1, g2) for k in eager)
        check(worst < tol[0], f"phase 17 {name}: replay vs eager worst rel "
              f"{worst:.2e} >= {tol[0]} ({tol[1]})")
    replay_profile = profile_step(step, eager=False)
    inside, whole, sites = replay_syncs(step)
    check(inside == 0, f"phase 17 {name}: {inside} host syncs inside the "
          "replays")
    ratio = graph_res / eager_res
    check(ratio <= 1.15, f"phase 17 {name}: the warm-up and the capture "
          f"reserve {graph_res / 2 ** 30:.2f} GiB, the eager step "
          f"{eager_res / 2 ** 30:.2f} GiB")
    got = dict(graph_ms=500.0 * (tg1 + tg2), eager_ms=1e3 * te,
               graph_s=[tg1, tg2], eager_s=te, warmup_s=warm_s,
               capture_run_s=capture_run_s,
               capture_s=sum(e.capture_s for e in entries()),
               graphs=n_entries, reserved_gib=graph_res / 2 ** 30,
               eager_reserved_gib=eager_res / 2 ** 30, reserved_ratio=ratio,
               peak_gib=graph_peak / 2 ** 30,
               eager_peak_gib=eager_peak / 2 ** 30,
               launches_per_step=list(lg2), bit_identical=same,
               worst_rel=worst, tol=None if tol is None else list(tol),
               replay_syncs=inside, step_syncs=whole, sync_sites=sites,
               replay_profile=replay_profile)
    info.setdefault("phase17", {})[name] = got
    print(f"phase 17 reading, {_turns_line(name, got)}", flush=True)
    return got


def _turns_line(name, r):
    """One path's phase 17 reading as text."""
    prof = r["replay_profile"]
    return (
        f"{name}: graph {r['graph_ms']:.1f} ms/step, eager "
        f"{r['eager_ms']:.1f} ({r['eager_ms'] / r['graph_ms']:.2f}x), "
        f"warm-up step {r['warmup_s']:.2f} s, {r['graphs']} graphs captured "
        f"in {r['capture_s']:.2f} s (capturing step {r['capture_run_s']:.2f}"
        f" s), reserved {r['reserved_gib']:.2f} GiB vs eager "
        f"{r['eager_reserved_gib']:.2f} ({r['reserved_ratio']:.3f}x), peak "
        f"{r['peak_gib']:.2f} GiB vs eager {r['eager_peak_gib']:.2f}, "
        + ("bit-identical" if r["bit_identical"] else
           f"worst rel {r['worst_rel']:.2e} < {r['tol'][0]} ({r['tol'][1]})")
        + f", K1/K2/K3 {r['launches_per_step']} a step, replay "
        + (f"busy {prof['busy_ms']:.1f} ms, idle {prof['idle_share']:.1%}"
           if "busy_ms" in prof else "profile not measured")
        + f", host syncs {r['replay_syncs']} inside the replays and "
        f"{r['step_syncs']} in the whole step")


def phase_graphs(info, card):
    """Phase 17: the captured steps.  Each path of phases 5, 8, 9 and 10
    was read by graph_turns in its own phase (graph and eager in turns,
    bit-identity, launches, host syncs, memory reserved), and phase 14's
    RFMIP-IRF step there; this phase checks that every path was read and
    prints them on one line."""
    want = ("driver 0.1", "driver streamed 0.01", "all-sky",
            "CIRC two-stream", "CIRC DISORT")
    got = info.get("phase17", {})
    check(sorted(got) == sorted(want), f"phase 17: paths read "
          f"{tuple(got)}, expected {want}")
    lines = [_turns_line(n, got[n]) for n in want]
    app = info.get("phase14", {}).get("rfmip")
    if app is not None:
        g, gib = app["graph"], 2 ** 30
        lines.append(
            f"RFMIP-IRF app (phase 14): eager step {app['step_s']:.3f} s, "
            f"graph capturing run {g['capture_run_s']:.3f} s, replay "
            f"{g['replay_s']:.3f} s, reserved {g['reserved_bytes'] / gib:.2f}"
            f" GiB vs the app's {app['reserved_bytes'] / gib:.2f} GiB")
    print(f"phase 17 captured steps ({card}): " + "; ".join(lines),
          flush=True)


def phase_card(info):
    import torch
    card = card_line()
    info["card"] = card
    info["torch"] = torch.__version__
    info["cuda"] = torch.version.cuda
    info["clocks_idle"] = clocks()
    print(card, flush=True)   # as nvidia-smi gives it: name, power limit
    print(f"phase 1 card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s); "
          f"SM / max SM / memory clock, temperature, power now: "
          f"{info['clocks_idle']}", flush=True)


def phase_build(info):
    """Every kernel of cuda_build.KERNELS (one nvcc each), the .par scanner
    and the C ABI shim (one g++ each), started together."""
    from concurrent.futures import ThreadPoolExecutor
    from grtcode_tpu_torch import bindings, native
    from grtcode_tpu_torch.cuda_build import KERNELS

    builds = {name: k.load for name, k in KERNELS.items()}
    builds.update(hitran_parser=native.available, grtcode_tpu_c=bindings.build)

    def timed(build):
        t0 = time.perf_counter()
        ok = build()
        return time.perf_counter() - t0, ok

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        done = dict(zip(builds, pool.map(timed, builds.values())))
    total = time.perf_counter() - t0
    check(done["hitran_parser"][1] is True,
          "the native .par scanner did not build (see the warning above)")
    secs = {name: s for name, (s, _) in done.items()}
    info["build_s"] = dict(secs, total=total)
    reports = []
    for name, k in KERNELS.items():
        info[f"build_log_{name}"] = k.build_log
        ptxas = " | ".join(ln.strip() for ln in k.build_log.splitlines()
                           if "registers" in ln or "spill" in ln)
        reports.append(f"{name} {secs[name]:.2f} s ({ptxas or 'cached'})")
    reports += [f"{name} {secs[name]:.2f} s (g++)"
                for name in ("hitran_parser", "grtcode_tpu_c")]
    print(f"phase 2 build: {total:.2f} s for all {len(builds)}: "
          + "; ".join(reports), flush=True)


def phase_kernel_vs_plain(info, dev):
    import torch
    from grtcode_tpu_torch import constants
    from grtcode_tpu_torch.gas_optics import lines, voigt_kernel as vk
    from grtcode_tpu_torch.gas_optics.gas_optics import GasOptics
    from grtcode_tpu_torch.gas_optics.hitran import synthetic_catalog
    from grtcode_tpu_torch.spectral import SpectralGrid
    from grtcode_tpu_torch.utils import curtis_godson as cg

    grid = SpectralGrid(1.0, 3250.0, 0.1)
    rng = np.random.default_rng(11)
    n_lines = 2000
    vnn = np.sort(rng.uniform(1.0, 3250.0, n_lines))
    cat = synthetic_catalog(
        1, vnn, 10.0 ** rng.uniform(-23.0, -19.0, n_lines),
        yair=rng.uniform(0.02, 0.11, n_lines),
        yself=rng.uniform(0.05, 0.4, n_lines),
        en=rng.uniform(0.0, 2800.0, n_lines),
        n=rng.uniform(0.35, 0.85, n_lines),
        d=rng.uniform(-0.01, 0.01, n_lines))
    gas = GasOptics(grid, device=dev)
    gas.add_catalog(cat)
    bound = gas.molecules[1]
    B, nlev = 4, 55
    p = np.linspace(0.01, 1013.0, nlev)[None, :] * np.ones((B, 1))
    t = np.linspace(210.0, 290.0, nlev)[None, :] + \
        rng.uniform(-5, 5, (B, nlev))
    x = rng.uniform(1e-5, 1e-2, (B, nlev))
    p_atm = torch.as_tensor(p, dtype=torch.float32, device=dev) * \
        constants.MB_TO_ATM
    t_lev = torch.as_tensor(t, dtype=torch.float32, device=dev)
    n_air = cg.number_densities(p_atm)
    pavg, tavg = cg.layer_pressures_temperatures(p_atm, t_lev)
    psavg, ns = cg.partial_pressures_and_densities(
        p_atm, torch.as_tensor(x, dtype=torch.float32, device=dev), n_air)
    rows = B * (nlev - 1)
    prep = lines.prepare(bound, grid, pavg.reshape(rows), tavg.reshape(rows),
                         psavg.reshape(rows))
    ns = ns.reshape(rows).contiguous()
    near = gas.near_steps[1]
    kw = dict(dw=float(grid.dw), fsteps=gas._fsteps, near=near,
              num_global=grid.n)
    ranges = gas.chunk_ranges[1]
    census = census_line_sample(prep, ranges, num_wpoints=grid.n,
                                **kw)["samples"]
    check(min(census["region0"], census["region1"], census["region2"],
              census["region3"], census["region4a"] + census["region4b"],
              census["lorentz"]) > 0,
          f"not every Humlicek region / Lorentz exercised: {census}")

    def run(fn, start, nw, **extra):
        tau = torch.zeros((rows, nw), dtype=torch.float32, device=dev)
        return fn(prep, ns, num_wpoints=nw, tau0=tau, start=start, **kw,
                  **extra)

    worst, worst_share = 0.0, 0.0
    blocks = [(0, grid.n), (100 * gas.tile, 50 * gas.tile)]
    for start, nw in blocks:
        got = run(vk.accumulate_voigt, start, nw, ranges=ranges)
        want = run(vk.voigt_line_sample_reference, start, nw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "kernel output not finite")
        check(float(want.abs().max()) > 0, "plain version is all zero")
        err, share, where = share_of_bound(got, want, **TOL_KERNEL)
        check(share <= 1.0, f"block start={start}: kernel vs plain "
              f"exceeds rtol 2e-6 / atol 1e-12 (max abs err {err:.3e}, "
              f"{share:.3f} of the bound {where})")
        worst, worst_share = max(worst, err), max(worst_share, share)
    again = run(vk.accumulate_voigt, 0, grid.n, ranges=ranges)
    first = run(vk.accumulate_voigt, 0, grid.n, ranges=ranges)
    torch.cuda.synchronize()
    check(torch.equal(again, first), "two kernel runs differ")
    info["phase3"] = dict(rows=rows, lines=int(bound.num_lines),
                          max_abs_err=worst, worst_share=worst_share,
                          region_census=census,
                          blocks=blocks)
    print(f"phase 3 kernel vs plain: {rows} rows x {bound.num_lines} lines, "
          f"blocks {blocks}: max abs err {worst:.3e}, at most "
          f"{worst_share:.3f} of the bound rtol 2e-6 / atol 1e-12, "
          f"bit-identical reruns, samples by class {census}", flush=True)
    return worst


def read_driver_golden():
    """tests/data/driver_golden.txt: row label -> per-level values."""
    golden, cur = {}, None
    with open(os.path.join("tests", "data", "driver_golden.txt")) as f:
        for line in f:
            line = line.strip()
            if line.startswith("nlev"):
                continue
            if line.startswith("r"):
                cur = line
                golden[cur] = []
            else:
                golden[cur].append(float(line))
    return {k: np.asarray(v) for k, v in golden.items()}


def worst_rel(ours, ref):
    """Worst |ours - ref| / max(|ref|, 1 % of max |ref|): the golden
    test's rule."""
    scale = np.maximum(np.abs(ref), 0.01 * np.abs(ref).max())
    return float((np.abs(ours - ref) / scale).max())


def phase_golden(info, dev):
    import torch
    from tools.goldens import driver_inputs
    from grtcode_tpu_torch import examples
    from grtcode_tpu_torch.spectral import SpectralGrid

    with tempfile.TemporaryDirectory() as d:
        driver, atm = examples.golden_case(
            d, driver_inputs.write_inputs(d),
            SpectralGrid(*driver_inputs.LW_GRID),
            SpectralGrid(*driver_inputs.SW_GRID), device=dev)
    res = driver.run(atm, integrated=True).tiers["csaf"]
    torch.cuda.synchronize()

    golden = read_driver_golden()
    worst = {}
    for var in ("rlu", "rld", "rsu", "rsd"):
        ref = golden[var]
        ours = res[var][0].cpu().numpy()
        check(ours.shape == ref.shape, f"{var}: shape {ours.shape}")
        worst[var] = worst_rel(ours, ref)
        check(worst[var] < TOL_GOLDEN,
              f"golden {var}: worst rel err {worst[var]:.2e}")
    info["phase4"] = worst
    print("phase 4 reference-C golden (CSAF): worst rel err "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f" < {TOL_GOLDEN}", flush=True)


def phase_full_width(info, dev, card):
    import torch
    from grtcode_tpu_torch import examples
    from grtcode_tpu_torch.framework.driver import RadiationDriver
    from grtcode_tpu_torch.gas_optics import voigt_kernel as vk

    t0 = time.perf_counter()
    lw_gas, sw_gas, solar, batch, B, nlayers = examples.rfmip_like(
        device=dev)
    atm = examples.atmosphere(batch)
    driver = RadiationDriver(lw_gas, sw_gas, solar)
    setup_s = time.perf_counter() - t0
    n_mol = len(lw_gas.molecules) + len(sw_gas.molecules)
    torch.cuda.reset_peak_memory_stats()

    # The main path, with every launch count starting at 0.
    vk.accumulate_voigt.launches = 0
    vk.voigt_line_sample_reference.launches = 0
    step_s = []
    res = None
    for i in range(4):
        before = vk.accumulate_voigt.launches
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = driver.run(atm, integrated=True).tiers["csaf"]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        if i == 3:
            under_load = clocks()
        check(vk.accumulate_voigt.launches - before == n_mol,
              f"step {i}: {vk.accumulate_voigt.launches - before} kernel "
              f"launches, expected {n_mol}")
    launches = vk.accumulate_voigt.launches
    plain_launches = vk.voigt_line_sample_reference.launches
    check(plain_launches == 0,
          f"the plain version ran {plain_launches} times on the main path")
    peak = torch.cuda.max_memory_allocated()

    for var, v in res.items():
        check(tuple(v.shape) == (B, nlayers + 1), f"{var}: shape {v.shape}")
        check(bool(torch.isfinite(v).all()), f"{var}: not finite")
    check(float(res["rld"][:, 0].abs().max()) == 0.0, "rld at TOA != 0")
    want = torch.as_tensor(batch["tsi"] * batch["mu"], dtype=torch.float32,
                           device=dev)
    rel = float(((res["rsd"][:, 0] - want).abs() / want).max())
    check(rel < 1e-4, f"rsd at TOA vs tsi*mu: rel err {rel:.2e}")
    check(bool((res["rlu"][:, 0] > 0).all()), "OLR not positive")

    ms = 1e3 * float(np.mean(step_s[2:]))   # after warm-up, capture
    rows = B * nlayers
    points = rows * (lw_gas.grid.n + sw_gas.grid.n)
    rate = points / (ms / 1e3)
    graph_turns(info, "driver 0.1", lambda: driver.run(atm, integrated=True),
                [driver._step_cache])
    breakdown = profile_step(lambda: driver.run(atm, integrated=True))

    # The kernel against the plain version at the main path's shapes: one
    # LW molecule (O2, small enough for the plain version) and one SW
    # molecule (H2O, the band's largest) at all 1,728 rows.
    o2 = full_rows_vs_plain(lw_gas, 7, batch, dev, kernel_reps=5,
                            plain_reps=2)
    sw_h2o = full_rows_vs_plain(sw_gas, 1, batch, dev, kernel_reps=5,
                                plain_reps=1)

    # The kernel alone on the largest molecule (LW O3): the plain version
    # takes tens of seconds there.
    prep, ns, kw = band_prep(lw_gas, 3, batch, dev)
    tau = torch.zeros((ns.shape[0], kw["num_wpoints"]), dtype=torch.float32,
                      device=dev)
    o3_ms = cuda_ms(lambda: vk.accumulate_voigt(
        prep, ns, lw_gas.chunk_ranges[3], tau0=tau, **kw), 2)
    o3_lines = prep.strength.shape[1]
    o3 = k1_bound(prep, lw_gas.chunk_ranges[3], **kw)
    del prep, tau

    info["phase5"] = dict(
        card=card, setup_s=setup_s, step_s=step_s, ms_per_step=ms,
        points_per_step=points, points_per_s=rate, peak_bytes=peak,
        launches=launches, B=B, nlayers=nlayers, clocks=under_load,
        nw=[lw_gas.grid.n, sw_gas.grid.n], lw_o2=o2, sw_h2o=sw_h2o,
        o3_lines=o3_lines, o3_kernel_ms=o3_ms, o3_bound=o3,
        profile=breakdown)
    print(f"phase 5 full width ({card}): B={B} x {nlayers} layers x "
          f"({lw_gas.grid.n} + {sw_gas.grid.n}) points, {n_mol} kernel "
          f"launches/step, {ms:.1f} ms/step (steps "
          f"{[round(s, 3) for s in step_s]} s; clocks after the last: "
          f"{under_load}), {rate:.4e} points/s, peak "
          f"{peak / 2 ** 30:.2f} GiB; kernel vs plain at {rows} rows within "
          f"rtol 2e-6 / atol 1e-12: {o2['summary']}; {sw_h2o['summary']}; "
          f"LW O3 ({o3_lines} lines) kernel {o3_ms:.2f} ms, bound "
          f"{o3['bound_ms']:.2f} ms by {o3['bound_by']} "
          f"({o3['bound_ms'] / o3_ms:.1%} of it reached); census "
          f"{census_summary(o3['census'])}; profiled step: "
          f"{breakdown['summary']}", flush=True)
    return launches, max(o2["max_abs_err"], sw_h2o["max_abs_err"]), o2


def census_summary(cen):
    """One line of a census: samples by class, zones, diverging warps."""
    samples = cen.get("samples") or cen["fine_samples"]
    parts = [", ".join(f"{k} {v:.4g}" for k, v in samples.items() if v)]
    if "zone_line_tiles" in cen:
        parts.append("(line, tile) x rows by zone " + ", ".join(
            f"{k} {v:.4g}" for k, v in cen["zone_line_tiles"].items()))
    else:
        parts.append(f"coarse samples {cen['coarse_total']:.4g}")
    parts.append(f"(row, warp, line) triples with diverging lanes in a "
                 f"one-output-per-thread walk {cen['diverging_warp_lines']:.4g}")
    return "; ".join(parts)


def full_rows_vs_plain(gas, mol, batch, dev, kernel_reps, plain_reps):
    """The kernel and the plain version on one molecule of a band at the
    main path's shapes: each into its own zeroed buffer, held to
    TOL_KERNEL, then timed plain, kernel, kernel, plain."""
    import torch
    from grtcode_tpu_torch.gas_optics import voigt_kernel as vk

    prep, ns, kw = band_prep(gas, mol, batch, dev)
    rows, n_lines = prep.strength.shape
    ranges = gas.chunk_ranges[mol]

    def zeros():
        return torch.zeros((rows, kw["num_wpoints"]), dtype=torch.float32,
                           device=dev)

    got = vk.accumulate_voigt(prep, ns, ranges, tau0=zeros(), **kw)
    want = vk.voigt_line_sample_reference(prep, ns, tau0=zeros(), **kw)
    torch.cuda.synchronize()
    label = f"{gas.grid.dw:g} cm-1 band, molecule {mol} ({n_lines} lines)"
    check(bool(torch.isfinite(got).all()), f"{label}: kernel not finite")
    check(float(want.abs().max()) > 0, f"{label}: plain version all zero")
    err, share, where = share_of_bound(got, want, **TOL_KERNEL)
    check(share <= 1.0, f"{label}: kernel vs plain exceeds rtol 2e-6 / "
          f"atol 1e-12 (max abs err {err:.3e}, {share:.3f} of the bound "
          f"{where})")
    del got, want

    tau = zeros()
    plain_ms = [cuda_ms(lambda: vk.voigt_line_sample_reference(
        prep, ns, tau0=tau, **kw), plain_reps)]
    kernel_ms = [cuda_ms(lambda: vk.accumulate_voigt(
        prep, ns, ranges, tau0=tau, **kw), kernel_reps) for _ in range(2)]
    plain_ms.append(cuda_ms(lambda: vk.voigt_line_sample_reference(
        prep, ns, tau0=tau, **kw), plain_reps))
    k_ms, p_ms = float(np.mean(kernel_ms)), float(np.mean(plain_ms))
    bound = k1_bound(prep, ranges, **kw)
    return dict(
        rows=rows, lines=n_lines, nw=kw["num_wpoints"], fsteps=kw["fsteps"],
        near=kw["near"], max_abs_err=err, worst_share=share,
        kernel_ms=kernel_ms, plain_ms=plain_ms, ms=k_ms, plain_ms_mean=p_ms,
        **bound,
        summary=(f"{label} max abs err {err:.3e} ({share:.3f} of the "
                 f"allclose bound), kernel {k_ms:.2f} ms vs plain "
                 f"{p_ms:.2f} ms, bound {bound['bound_ms']:.3f} ms by "
                 f"{bound['bound_by']} ({bound['bound_ms'] / k_ms:.1%} of "
                 f"it reached); census {census_summary(bound['census'])}"))


def lcg_lines(n_lines=40):
    """The bins-golden harness's LCG line list (tools/goldens/
    bins_harness.c, as tests/test_gasoptics_pipeline.py reproduces it):
    uint32 wraparound is the LCG's modulus."""
    v0, s0, yair, yself, en, nexp, iso = (np.empty(n_lines) for _ in range(7))
    s = np.uint32(12345)
    with np.errstate(over="ignore"):
        for i in range(n_lines):
            r = []
            for _ in range(3):
                s = np.uint32(s * np.uint32(1103515245) + np.uint32(12345))
                r.append(float(s >> np.uint32(8)) / 16777216.0)
            r1, r2, r3 = r
            v0[i] = 150.0 + 200.0 * i / (n_lines - 1.0) + 2.0 * (r1 - 0.5)
            s0[i] = 1e-23 * 10.0 ** (3.0 * r2)
            yair[i] = 0.02 + 0.08 * r3
            yself[i] = 0.1 + 0.3 * r1
            en[i] = 2000.0 * r2
            nexp[i] = 0.4 + 0.4 * r3
            iso[i] = 1 + (i % 3)
    return v0, s0, yair, yself, en, nexp, iso.astype(np.int32)


def bin_molecule(dev, w0, wn, n_lines, seed, B, nlev, spread):
    """(GasOptics, PreparedLines, column densities) of one synthetic
    molecule on [w0, wn] at 0.1 cm-1, its lines spread ``spread`` cm-1
    past both ends, on B x (nlev - 1) rows (tests/test_bins_pallas.py's
    setup)."""
    import torch
    from grtcode_tpu_torch import constants
    from grtcode_tpu_torch.gas_optics import lines
    from grtcode_tpu_torch.gas_optics.gas_optics import GasOptics
    from grtcode_tpu_torch.gas_optics.hitran import synthetic_catalog
    from grtcode_tpu_torch.spectral import SpectralGrid
    from grtcode_tpu_torch.utils import curtis_godson as cg

    rng = np.random.default_rng(seed)
    vnn = np.sort(rng.uniform(w0 - spread, wn + spread, n_lines))
    cat = synthetic_catalog(
        1, vnn, rng.uniform(1e-22, 1e-19, n_lines),
        yair=rng.uniform(0.02, 0.1, n_lines),
        yself=rng.uniform(0.05, 0.4, n_lines),
        en=rng.uniform(0.0, 2000.0, n_lines),
        n=rng.uniform(0.4, 0.8, n_lines),
        d=rng.uniform(-0.02, 0.02, n_lines))
    gas = GasOptics(SpectralGrid(w0, wn, 0.1), device=dev)
    gas.add_catalog(cat)
    p = np.linspace(0.01, 1013.0, nlev)[None, :] * np.ones((B, 1))
    t = np.linspace(215.0, 288.0, nlev)[None, :] + \
        rng.uniform(-3, 3, (B, nlev))
    x = rng.uniform(1e-5, 1e-2, (B, nlev))

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    p_atm = f32(p) * constants.MB_TO_ATM
    pavg, tavg = cg.layer_pressures_temperatures(p_atm, f32(t))
    psavg, ns = cg.partial_pressures_and_densities(
        p_atm, f32(x), cg.number_densities(p_atm))
    rows = B * (nlev - 1)
    prep = lines.prepare(gas.molecules[1], gas.grid, pavg.reshape(rows),
                         tavg.reshape(rows), psavg.reshape(rows))
    return gas, prep, ns.reshape(rows).contiguous()


def remote_census(prep, ranges, bins):
    """Counts of remote (row, line, coarse point) samples per Humlicek
    region (0-4) and in the pure-Lorentz limit (5), by the plain version's
    limits."""
    import torch
    from grtcode_tpu_torch import constants
    from grtcode_tpu_torch.gas_optics.voigt import humlicek_region
    repwid = constants.SQRT_LN2 / prep.doppler
    y_true = repwid * prep.lorentz
    y = y_true.clamp(max=70.0)
    bnd = ranges.bounds()
    w_rel = bins.w_rel
    counts = torch.zeros(6, dtype=torch.int64, device=prep.strength.device)
    for j in range(bins.n):
        for lo, hi in ((bnd[2, j], bnd[3, j]), (bnd[4, j], bnd[5, j])):
            if hi <= lo:
                continue
            sl = slice(int(lo), int(hi))
            for k in range(3):
                x = ((float(w_rel[j, k])
                      - prep.center_idx[:, sl].to(torch.float32))
                     - prep.center_frac[:, sl]) * bins.wres * repwid[:, sl]
                region = torch.where(y_true[:, sl] >= 70.55, 5,
                                     humlicek_region(x.abs(), y[:, sl]))
                counts += torch.bincount(region.flatten(), minlength=6)
    return counts.tolist()


def phase_bin_kernel_vs_plain(info, dev):
    import torch
    from grtcode_tpu_torch.gas_optics import bins as bm
    from grtcode_tpu_torch.gas_optics import bins_kernel as bk

    heavy = bin_molecule(dev, 1.0, 3250.0, 2000, 11, B=4, nlev=55,
                         spread=0.0)
    light = bin_molecule(dev, 30000.0, 30060.0, 60, 11, B=3, nlev=7,
                         spread=10.0)
    cases = [("heavy", heavy, "bin_sweep", 0, None),
             ("heavy", heavy, "bin_sweep", 800, 400),
             ("heavy", heavy, "line_sweep", 0, None),
             ("heavy", heavy, "line_sweep", 2904, 88),   # past the band
             ("light", light, "bin_sweep", 0, None),
             ("light", light, "line_sweep", 8, 40)]
    worst, worst_share, results = 0.0, 0.0, []
    census = None
    for label, (gas, prep, ns), mode, b0, nb in cases:
        ranges = bm.build_bin_ranges(gas._raw_bounds[1], gas.bins, mode=mode,
                                     remote_cutoff=gas.wcutoff)
        kw = dict(start_bin=b0, nbins=nb)
        got = bk.accumulate_bins_kernel(prep, ns, ranges, gas.bins, **kw)
        want = bm.accumulate_bins(prep, ns, ranges, gas.bins, **kw)
        torch.cuda.synchronize()
        for part, g, w in zip(("fine", "coarse"), got, want):
            check(bool(torch.isfinite(g).all()), f"{label} {mode}: kernel "
                  f"{part} not finite")
            scale = float(w.abs().max())
            check(scale > 0, f"{label} {mode} {part}: plain version all 0")
            err, share, where = share_of_bound(
                g, w, TOL_BIN_KERNEL["rtol"], TOL_BIN_KERNEL["atol"] * scale)
            check(share <= 1.0, f"{label} {mode} window ({b0}, {nb}) "
                  f"{part}: kernel vs plain exceeds rtol 2e-5 / atol 2e-6 x "
                  f"max (max abs err {err:.3e}, {share:.3f} of the bound "
                  f"{where})")
            worst, worst_share = max(worst, err), max(worst_share, share)
            results.append(dict(case=label, mode=mode, window=[b0, nb],
                                part=part, max_abs_err=err, share=share,
                                scale=scale))
        if label == "light" and census is None:
            census = remote_census(prep, ranges, gas.bins)
            check(sum(census[1:5]) > 0, f"light molecule: no remote sample "
                  f"in Humlicek regions 1-4: {census}")
        if b0 == 0 and nb is None and label == "heavy" and mode == \
                "bin_sweep":
            again = bk.accumulate_bins_kernel(prep, ns, ranges, gas.bins,
                                              **kw)
            torch.cuda.synchronize()
            check(torch.equal(again[0], got[0]) and
                  torch.equal(again[1], got[1]), "two K2 runs differ")
    info["phase6"] = dict(results=results, max_abs_err=worst,
                          worst_share=worst_share, remote_census=census)
    print(f"phase 6 K2 vs plain: {len(cases)} cases (both modes, windows at "
          f"start_bin > 0 and past the band, heavy {heavy[1].strength.shape} "
          f"and light molecule) within rtol 2e-5 / atol 2e-6 x max: max abs "
          f"err {worst:.3e}, at most {worst_share:.4f} of the bound; "
          f"bit-identical "
          f"reruns; light molecule remote samples per region 0-4 / Lorentz "
          f"{census}", flush=True)
    return worst


def phase_bins_golden(info, dev):
    from grtcode_tpu_torch import constants
    from grtcode_tpu_torch.gas_optics.gas_optics import GasOptics
    from grtcode_tpu_torch.gas_optics.hitran import synthetic_catalog
    from grtcode_tpu_torch.spectral import SpectralGrid

    nlev = 9
    data = np.loadtxt(os.path.join("tests", "data", "bins_golden.txt"))
    data = data.reshape(2, nlev - 1, -1)
    v0, s0, yair, yself, en, nexp, iso = lcg_lines()
    i = np.arange(nlev)
    p_atm = 1e-5 + (1.0 - 1e-5) * i / (nlev - 1.0)
    t = 215.0 + (288.0 - 215.0) * i / (nlev - 1.0)
    x = 1e-5 + 3e-3 * i / (nlev - 1.0)
    worst = {}
    for golden, method in zip(data, ("wavenumber_sweep", "line_sweep")):
        gas = GasOptics(SpectralGrid(100.0, 400.0, 0.1), line_chunk=64,
                        method=method, device=dev)
        gas.add_catalog(synthetic_catalog(
            1, v0, s0, yair=yair, yself=yself, en=en, n=nexp,
            d=np.zeros_like(v0), iso=iso))
        tau = gas.optical_depth(p_atm / constants.MB_TO_ATM, t,
                                {1: x}).cpu().numpy()
        check(tau.shape == golden.shape, f"{method}: shape {tau.shape}")
        # |tau - golden| over its bound atol + rtol |golden| (<= 1 passes).
        ratio = np.abs(tau - golden) / (TOL_BINS_GOLDEN["atol"]
                                        + TOL_BINS_GOLDEN["rtol"]
                                        * np.abs(golden))
        worst[method] = float(np.max(ratio))
        check(worst[method] <= 1.0, f"bins golden {method}: worst error "
              f"{worst[method]:.3f} of the bound rtol 2e-3 / atol 1e-7")
    info["phase7"] = worst
    print("phase 7 reference-C bins golden: worst error as a share of the "
          "bound rtol 2e-3 / atol 1e-7: " + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()),
          flush=True)


def phase_streamed_bins(info, dev, card):
    import torch
    from grtcode_tpu_torch import examples
    from grtcode_tpu_torch.framework.driver import RadiationDriver
    from grtcode_tpu_torch.gas_optics import bins as bm
    from grtcode_tpu_torch.gas_optics import bins_kernel as bk
    from grtcode_tpu_torch.gas_optics import voigt_kernel as vk
    from grtcode_tpu_torch.utils import debug

    S = 10
    t0 = time.perf_counter()
    lw_gas, sw_gas, solar, batch, B, nlayers = examples.rfmip_like(
        device=dev, lw_method="wavenumber_sweep", lw_res=0.01)
    atm = examples.atmosphere(batch)
    driver = RadiationDriver(lw_gas, sw_gas, solar)
    setup_s = time.perf_counter() - t0
    n_lw, n_sw = len(lw_gas.molecules), len(sw_gas.molecules)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def step():
        return driver.run(atm, integrated=True,
                          spectral_chunks=S).tiers["csaf"]

    # The streamed bin-method path, with every launch count starting at 0.
    counts = (bk.accumulate_bins_kernel, vk.accumulate_voigt,
              bm.accumulate_bins, vk.voigt_line_sample_reference)
    for fn in counts:
        fn.launches = 0
    step_s = []
    res = None
    for i in range(4):
        before = (bk.accumulate_bins_kernel.launches,
                  vk.accumulate_voigt.launches)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        if i == 3:
            under_load = clocks()
        k2 = bk.accumulate_bins_kernel.launches - before[0]
        k1 = vk.accumulate_voigt.launches - before[1]
        check((k2, k1) == (n_lw * S, n_sw * S),
              f"step {i}: {k2} K2 and {k1} K1 launches, expected "
              f"{n_lw * S} and {n_sw * S}")
    launches = {"voigt_bins": bk.accumulate_bins_kernel.launches,
                "voigt_line_sample": vk.accumulate_voigt.launches}
    plain = (bm.accumulate_bins.launches,
             vk.voigt_line_sample_reference.launches)
    check(plain == (0, 0), f"the plain versions ran {plain} times on the "
          "streamed bin-method path")
    peak = torch.cuda.max_memory_allocated()

    for var, v in res.items():
        check(tuple(v.shape) == (B, nlayers + 1), f"{var}: shape {v.shape}")
        check(bool(torch.isfinite(v).all()), f"{var}: not finite")
    check(float(res["rld"][:, 0].abs().max()) == 0.0, "rld at TOA != 0")
    want = torch.as_tensor(batch["tsi"] * batch["mu"], dtype=torch.float32,
                           device=dev)
    rel = float(((res["rsd"][:, 0] - want).abs() / want).max())
    check(rel < 1e-4, f"rsd at TOA vs tsi*mu: rel err {rel:.2e}")
    check(bool((res["rlu"][:, 0] > 0).all()), "OLR not positive")

    ms = 1e3 * float(np.mean(step_s[2:]))   # after warm-up, capture
    rows = B * nlayers
    points = rows * (lw_gas.grid.n + sw_gas.grid.n)
    rate = points / (ms / 1e3)
    graph_turns(info, "driver streamed 0.01", step, [driver._step_cache])
    breakdown = profile_step(step)

    def eager_step():
        with debug.disable_jit():
            return step()

    syncs, sync_sites = count_syncs(eager_step)
    size_lw = -(-(-(-lw_gas.grid.n // S)) // lw_gas.block_quantum) * \
        lw_gas.block_quantum
    o2 = bin_full_rows_vs_plain(lw_gas, 7, batch, dev,
                                nbins=size_lw // lw_gas.bins.ppb,
                                kernel_reps=5, plain_reps=1)
    info["phase8"] = dict(
        card=card, setup_s=setup_s, step_s=step_s, ms_per_step=ms,
        points_per_step=points, points_per_s=rate, peak_bytes=peak,
        launches=launches, B=B, nlayers=nlayers, clocks=under_load,
        nw=[lw_gas.grid.n, sw_gas.grid.n], spectral_chunks=S,
        block_lw=size_lw, bins=[lw_gas.bins.n, lw_gas.bins.ppb,
                                lw_gas.bins.last_ppb],
        lw_o2=o2, profile=breakdown, syncs=syncs, sync_sites=sync_sites)
    print(f"phase 8 streamed bin-method step ({card}): B={B} x {nlayers} "
          f"layers x ({lw_gas.grid.n} + {sw_gas.grid.n}) points in {S} "
          f"blocks (LW {size_lw}), {n_lw * S} K2 + {n_sw * S} K1 launches/"
          f"step, no plain launch, {ms:.1f} ms/step (steps "
          f"{[round(s, 3) for s in step_s]} s; clocks after the last: "
          f"{under_load}), {rate:.4e} points/s, peak {peak / 2 ** 30:.2f} "
          f"GiB; profiled step: {breakdown['summary']}; {syncs} host-device "
          f"synchronisations per step, most at {sync_sites[:3]}; K2 vs plain at "
          f"{rows} rows within rtol 2e-5 / atol 2e-6 x max: {o2['summary']}",
          flush=True)
    return launches, o2


def bin_full_rows_vs_plain(gas, mol, batch, dev, nbins, kernel_reps,
                           plain_reps):
    """K2 and its plain version on one molecule of the LW band over the
    first spectral block (``nbins`` bins) at the main path's rows: each
    into its own zeroed buffers, held to TOL_BIN_KERNEL, then timed plain,
    kernel, kernel, plain."""
    import torch
    from grtcode_tpu_torch.gas_optics import bins as bm
    from grtcode_tpu_torch.gas_optics import bins_kernel as bk

    prep, ns, _ = band_prep(gas, mol, batch, dev)
    rows, n_lines = prep.strength.shape
    ranges = gas._get_bin_ranges(mol)
    kw = dict(start_bin=0, nbins=nbins)

    def zeros():
        return (torch.zeros((rows, nbins * gas.bins.ppb), device=dev),
                torch.zeros((rows, nbins, bm.NIP), device=dev))

    def kernel(buf):
        return bk.accumulate_bins_kernel(prep, ns, ranges, gas.bins, **kw,
                                         tau0=buf[0], bins_tau0=buf[1])

    def plain(buf):
        return bm.accumulate_bins(prep, ns, ranges, gas.bins, **kw,
                                  tau0=buf[0], bins_tau0=buf[1])

    got, want = kernel(zeros()), plain(zeros())
    torch.cuda.synchronize()
    label = (f"{gas.grid.dw:g} cm-1 band, molecule {mol} ({n_lines} lines, "
             f"{nbins} bins of {gas.bins.ppb})")
    worst, worst_share = 0.0, 0.0
    for part, g, w in zip(("fine", "coarse"), got, want):
        check(bool(torch.isfinite(g).all()), f"{label}: kernel not finite")
        scale = float(w.abs().max())
        check(scale > 0, f"{label} {part}: plain version all zero")
        err, share, where = share_of_bound(g, w, TOL_BIN_KERNEL["rtol"],
                                           TOL_BIN_KERNEL["atol"] * scale)
        check(share <= 1.0, f"{label} {part}: kernel vs plain exceeds "
              f"rtol 2e-5 / atol 2e-6 x max (max abs err {err:.3e}, "
              f"{share:.3f} of the bound {where})")
        worst, worst_share = max(worst, err), max(worst_share, share)
    del got, want

    buf = zeros()
    plain_ms = [cuda_ms(lambda: plain(buf), plain_reps)]
    kernel_ms = [cuda_ms(lambda: kernel(buf), kernel_reps) for _ in range(2)]
    plain_ms.append(cuda_ms(lambda: plain(buf), plain_reps))
    k_ms, p_ms = float(np.mean(kernel_ms)), float(np.mean(plain_ms))
    bound = k2_bound(prep, ranges, gas.bins, **kw)
    cen = bound["census"]
    return dict(
        rows=rows, lines=n_lines, nbins=nbins, ppb=gas.bins.ppb,
        max_abs_err=worst, worst_share=worst_share, kernel_ms=kernel_ms,
        plain_ms=plain_ms, ms=k_ms, plain_ms_mean=p_ms, **bound,
        summary=(f"{label} max abs err {worst:.3e} (at most "
                 f"{worst_share:.4f} of the allclose bound), kernel "
                 f"{k_ms:.2f} ms vs plain {p_ms:.2f} ms, bound "
                 f"{bound['bound_ms']:.3f} ms by {bound['bound_by']} "
                 f"({bound['bound_ms'] / k_ms:.1%} of it reached); census "
                 f"{census_summary(cen)}"))


def phase_allsky(info, dev, card):
    """The all-sky path: the golden's three tiers, the full-width step,
    its profile and its checks.  Returns K1's launches on the step."""
    import torch
    from tools.goldens import driver_inputs
    from grtcode_tpu_torch import examples
    from grtcode_tpu_torch.clouds.lib import overlap_from_pressure
    from grtcode_tpu_torch.clouds.stochastic import cloudiness
    from grtcode_tpu_torch.gas_optics import voigt_kernel as vk
    from grtcode_tpu_torch.spectral import SpectralGrid
    from grtcode_tpu_torch.utils import prng

    # (a) The reference-C golden, every tier.
    with tempfile.TemporaryDirectory() as d:
        inputs = driver_inputs.write_inputs(d)
        inputs.update(aerosol=driver_inputs.aerosol(),
                      clouds=driver_inputs.clouds(),
                      pade=driver_inputs.pade_tables())
        gdriver, gatm = examples.golden_case(
            d, inputs, SpectralGrid(*driver_inputs.LW_GRID),
            SpectralGrid(*driver_inputs.SW_GRID), device=dev, sky="all")
    gres = gdriver.run(gatm, integrated=True).tiers
    torch.cuda.synchronize()
    golden = read_driver_golden()
    golden_worst = {}
    for sfx, tier in (("", "csaf"), ("_cs", "cs"), ("_af", "af")):
        tol = TOL_GOLDEN if tier == "csaf" else TOL_GOLDEN_TIERS
        for var in ("rlu", "rld", "rsu", "rsd"):
            ours = gres[tier][var][0].cpu().numpy()
            ref = golden[var + sfx]
            check(ours.shape == ref.shape, f"golden {var + sfx}: shape")
            golden_worst[var + sfx] = worst_rel(ours, ref)
            check(golden_worst[var + sfx] < tol, f"golden {var + sfx}: "
                  f"worst rel err {golden_worst[var + sfx]:.2e} >= {tol}")
    del gdriver, gatm, gres

    # (b) The full-width step, every launch count starting at 0.
    t0 = time.perf_counter()
    driver, atm = examples.allsky_like(device=dev)
    setup_s = time.perf_counter() - t0
    lw_gas, sw_gas = driver.lw_gas, driver.sw_gas
    B, nlayers = atm.batch, atm.num_layers
    lit = atm.cos_zenith > 0.0
    n_lit = int(lit.sum())
    check(0 < n_lit < B, f"{n_lit} of {B} columns lit: compaction is off")
    per_step = 2 * len(lw_gas.molecules) + len(sw_gas.molecules)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def step():
        return driver.run(atm, integrated=True)

    vk.accumulate_voigt.launches = 0
    vk.voigt_line_sample_reference.launches = 0
    step_s = []
    res = None
    for i in range(4):
        before = vk.accumulate_voigt.launches
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        if i == 3:
            under_load = clocks()
        check(vk.accumulate_voigt.launches - before == per_step,
              f"step {i}: {vk.accumulate_voigt.launches - before} K1 "
              f"launches, expected {per_step}")
    launches = vk.accumulate_voigt.launches
    check(vk.voigt_line_sample_reference.launches == 0,
          "the plain version ran on the all-sky path")
    peak = torch.cuda.max_memory_allocated()

    tiers = {t: {k: v.cpu().numpy() for k, v in fx.items()}
             for t, fx in res.tiers.items()}
    check(list(tiers) == ["csaf", "cs", "af"], f"tiers {list(tiers)}")
    want_top = atm.total_solar_irradiance[lit] * atm.cos_zenith[lit]
    for t, fx in tiers.items():
        for var, v in fx.items():
            check(v.shape == (B, nlayers + 1), f"{t} {var}: shape {v.shape}")
            check(np.isfinite(v).all(), f"{t} {var}: not finite")
        check(np.abs(fx["rld"][:, 0]).max() == 0.0, f"{t}: rld at TOA != 0")
        rel = np.abs(fx["rsd"][lit, 0] - want_top) / want_top
        check(rel.max() < 1e-4, f"{t}: rsd at TOA vs tsi*mu: {rel.max():.2e}")
        check((fx["rlu"][:, 0] > 0).all(), f"{t}: OLR not positive")
        # (d) Night columns get no shortwave at all.
        check(not fx["rsu"][~lit].any() and not fx["rsd"][~lit].any(),
              f"{t}: night SW != 0")
    check(not np.allclose(tiers["af"]["rlu"], tiers["csaf"]["rlu"]),
          "AF equals CSAF: the clouds did nothing")
    check((tiers["cs"]["rsd"][lit, -1] < tiers["csaf"]["rsd"][lit, -1]).all(),
          "aerosols did not dim the surface")
    ms = 1e3 * float(np.mean(step_s[2:]))   # after warm-up, capture
    points = B * nlayers * (lw_gas.grid.n + sw_gas.grid.n)
    rate = points / (ms / 1e3)

    graph_turns(info, "all-sky", step, [driver._step_cache])
    # (c) One profiled step, and K1's bound on the step: the sum of each
    # launch's (each LW molecule on the lit and on the night columns, each
    # SW molecule on the lit ones).
    breakdown = profile_step(step)
    k1_step_bound, bound_by = 0.0, []
    for gas, groups in ((lw_gas, (lit, ~lit)), (sw_gas, (lit,))):
        for cols in groups:
            part = {"p_lev": atm.level_pressure[cols],
                    "t_lev": atm.level_temperature[cols],
                    "vmr": {m: np.asarray(v)[cols]
                            for m, v in atm.ppmv.items()}}
            for mol in gas.molecules:
                prep, _, kw = band_prep(gas, mol, part, dev)
                b = k1_bound(prep, gas.chunk_ranges[mol], **kw)
                k1_step_bound += b["bound_ms"]
                bound_by.append(b["bound_by"])
                del prep
    check(len(bound_by) == per_step, "one bound per K1 launch")
    k1_ms = breakdown.get("kernel_ms", {}).get("voigt_line_sample", 0.0)

    # (d) Column chunks equal the whole batch; the draws equal the CPU's.
    chunked = driver.run(atm, integrated=True, column_chunk=8).tiers
    chunk_err = 0.0
    for t, fx in tiers.items():
        for var, v in fx.items():
            got = chunked[t][var].cpu().numpy()
            ok = np.abs(got - v) <= TOL_CHUNK["atol"] + TOL_CHUNK["rtol"] * \
                np.abs(v)
            check(ok.all(), f"column_chunk=8 {t} {var} differs from the "
                  f"whole batch (max abs {np.abs(got - v).max():.3e})")
            chunk_err = max(chunk_err, float(np.abs(got - v).max()))
    launches_after_checks = vk.accumulate_voigt.launches
    key = prng.split(prng.prng_key(driver.cloud_seed, dev),
                     driver.num_subcolumns)[0]
    keys = prng.fold_in(key, torch.arange(B, device=dev))
    kx, kr = prng.split(keys, 2).unbind(-2)
    draws = torch.cat([prng.uniform(kx, nlayers),
                       prng.uniform(kr, nlayers - 1)], -1)
    kx_c, kr_c = kx.cpu(), kr.cpu()
    draws_cpu = torch.cat([prng.uniform(kx_c, nlayers),
                           prng.uniform(kr_c, nlayers - 1)], -1)
    check(torch.equal(draws.cpu(), draws_cpu),
          "the cloud draws on the card differ from the CPU's")
    p_lay = 0.5 * (atm.level_pressure[:, :-1] + atm.level_pressure[:, 1:])
    overlap = overlap_from_pressure(torch.as_tensor(p_lay))
    same_cloudiness = bool(torch.equal(
        cloudiness(keys, overlap.to(dev), nlayers).cpu(),
        cloudiness(keys.cpu(), overlap, nlayers)))

    info["phase9"] = dict(
        card=card, golden_worst=golden_worst, setup_s=setup_s,
        step_s=step_s, ms_per_step=ms, points_per_step=points,
        points_per_s=rate, peak_bytes=peak, launches=launches,
        launches_per_step=per_step, B=B, lit=n_lit, nlayers=nlayers,
        clocks=under_load, nw=[lw_gas.grid.n, sw_gas.grid.n],
        profile=breakdown, k1_step_bound_ms=k1_step_bound,
        k1_bound_by={b: bound_by.count(b) for b in set(bound_by)},
        chunk_max_abs_err=chunk_err,
        chunk_launches=launches_after_checks - launches,
        draws_bit_identical=True, cloudiness_bit_identical=same_cloudiness)
    print(f"phase 9 all-sky step ({card}): golden 12 rows, worst rel err "
          f"CSAF {max(golden_worst[v] for v in ('rlu', 'rld', 'rsu', 'rsd')):.2e}"
          f" < {TOL_GOLDEN}, CS/AF "
          f"{max(v for k, v in golden_worst.items() if '_' in k):.2e} < "
          f"{TOL_GOLDEN_TIERS}; B={B} ({n_lit} lit) x {nlayers} layers x "
          f"({lw_gas.grid.n} + {sw_gas.grid.n}) points, 3 tiers, {per_step} "
          f"K1 launches/step, no plain launch, {ms:.1f} ms/step (steps "
          f"{[round(s, 3) for s in step_s]} s; clocks after the last: "
          f"{under_load}), {rate:.4e} points/s, peak {peak / 2 ** 30:.2f} "
          f"GiB; profiled step: {breakdown['summary']}; K1 bound on the "
          f"step {k1_step_bound:.2f} ms ({bound_by.count('operations')} of "
          f"{per_step} launches bound by operations; "
          f"{k1_step_bound / k1_ms if k1_ms else 0.0:.1%} of it reached); "
          f"column_chunk=8 "
          f"within rtol 2e-6 / atol 1e-6 of the whole batch (max abs "
          f"{chunk_err:.3e}); night SW 0; AF differs from CSAF; cloud draws "
          f"on the card bit-identical to the CPU's (cloudiness too: "
          f"{same_cloudiness})", flush=True)
    return launches


def write_hitran_par(path, lw_grid, sw_grid):
    """A HITRAN-scale .par file: the line lists of examples.rfmip_like
    (examples.line_lists: 366,000 LW lines of the 7 CIRC molecules over
    1-3,250 cm-1 and 64,000 SW lines over 1-50,000 cm-1, the benchmark's
    seeds) as 160-character HITRAN2012 records, sorted by line center.
    Returns the number of records."""
    from tools.goldens.driver_inputs import _record
    from grtcode_tpu_torch import examples

    recs = []
    for band in examples.line_lists(lw_grid, sw_grid).values():
        for mol, p in band.items():
            cols = [p[k].tolist() for k in ("vnn", "s0", "yair", "yself",
                                             "en", "n", "d")]
            recs.extend((v, _record(mol, "1", v, *rest))
                        for v, *rest in zip(*cols))
    recs.sort(key=lambda r: r[0])
    with open(path, "w") as f:
        f.write("".join(r[1] + "\n" for r in recs))
    return len(recs)


def chandrasekhar_h(omega, mu_eval, n_quad=96, iters=400):
    """Chandrasekhar's H-function for isotropic scattering, iterated to
    convergence in float64 (tests/test_disort.py's external oracle)."""
    x, w = np.polynomial.legendre.leggauss(n_quad)
    mu, wq = 0.5 * (x + 1.0), 0.5 * w
    H, s = np.ones(n_quad), np.sqrt(1.0 - omega)
    for _ in range(iters):
        H_new = 1.0 / (s + ((0.5 * omega) * (wq * mu * H)[None, :]
                            / (mu[:, None] + mu[None, :])).sum(axis=1))
        done = np.max(np.abs(H_new - H)) < 1e-14
        H = H_new
        if done:
            break
    return 1.0 / (s + ((0.5 * omega) * (wq * mu * H) / (mu_eval + mu)).sum())


def disort_analytic_cases(dev):
    """tests/test_disort.py's analytic cases on ``dev``, at its bars;
    returns the worst share of each bar."""
    import torch
    from grtcode_tpu_torch.solvers.disort import disort_shortwave, \
        gauss_streams

    mu0, tsi = 0.6, 1361.0

    def full(v, *shape):
        return torch.full(shape, v, dtype=torch.float32, device=dev)

    def run(tau, omega, g, albedo=0.2, nw=6, nstr=8, nlayers=4):
        up, dn = disort_shortwave(
            full(tau, nlayers, nw), full(omega, nlayers, nw),
            full(g, nlayers, nw), torch.tensor(mu0, device=dev),
            full(albedo, nw), torch.tensor(tsi, device=dev), full(1.0, nw),
            nstr=nstr, wchunk=8)
        return up.cpu().numpy().astype(np.float64), \
            dn.cpu().numpy().astype(np.float64)

    def rel(a, b):
        return float((np.abs(a - b) / np.abs(b)).max())

    share = {}
    up, dn = run(0.0, 0.0, 0.0, albedo=0.3)
    share["transparent"] = max(rel(dn, tsi * mu0), rel(up, tsi * mu0 * 0.3)) \
        / 1e-5
    up, dn = run(0.3, 0.0, 0.0, albedo=0.25, nstr=16)
    taus = 0.3 * np.arange(5)
    mu, w = gauss_streams(16)
    f_sfc = 0.25 * tsi * mu0 * np.exp(-taus[-1] / mu0)
    expect = f_sfc * np.array([np.sum(w * mu * np.exp(-(taus[-1] - t) / mu))
                               for t in taus]) / np.sum(w * mu)
    share["absorption_only"] = max(
        rel(dn[:, 0], tsi * mu0 * np.exp(-taus / mu0)) / 1e-5,
        rel(up[-1, 0], f_sfc) / 1e-5, rel(up[:, 0], expect) / 1e-4)
    up, dn = run(1.0, 1.0, 0.7, albedo=0.0, nstr=16)
    net = (dn - up)[:, 0]
    check(0.05 < up[0, 0] / dn[0, 0] < 0.95, "conservative: reflectance")
    share["conservative"] = rel(net, net[0]) / 5e-4
    one = run(1.0, 0.8, 0.5, albedo=0.15, nw=4, nstr=8, nlayers=1)
    two = run(0.5, 0.8, 0.5, albedo=0.15, nw=4, nstr=8, nlayers=2)
    share["layer_split"] = max(rel(a[[0, -1]], b[[0, -1]])
                               for a, b in zip(one, two)) / 2e-5
    for omega, mu_c in ((0.6, 0.5), (0.9, 0.8), (0.99, 0.4)):
        exact = 1.0 - chandrasekhar_h(omega, mu_c) * np.sqrt(1.0 - omega)
        nlayers, nw = 60, 2
        dtau = np.repeat((0.08 * 1.16 ** np.arange(nlayers))[:, None], nw, 1)
        up, _ = disort_shortwave(
            torch.as_tensor(dtau, dtype=torch.float32, device=dev),
            full(omega, nlayers, nw), full(0.0, nlayers, nw),
            torch.tensor(mu_c, device=dev), full(0.0, nw),
            torch.tensor(tsi, device=dev), full(1.0, nw), nstr=16,
            deltam=False, wchunk=2)
        got = float(up[0, 0]) / (tsi * mu_c)
        share[f"chandrasekhar_{omega}_{mu_c}"] = abs(got - exact) / (
            5e-3 * max(exact, 0.05))
    for case, v in share.items():
        check(v <= 1.0, f"DISORT {case} on the card: {v:.3f} of its bar")
    return share


def phase_circ_app(info, dev, card, d):
    """The CIRC app on the card: the HITRAN-scale .par, the app's default
    grids, two-stream through ``apps.circ.main``, then the same driver with
    the 16-stream DISORT, then DISORT's analytic cases and the card against
    the CPU.  The .par and the input tables are written into directory
    ``d`` (phase 14 reads them again).  Returns K1's launches on the app's
    run and the four DISORT steps (one count from 0), K1's largest error
    against the plain version on the app's driver, and K3's reading
    (:func:`disort_kernel_vs_plain`)."""
    import dataclasses
    import inspect
    import torch
    from tools.goldens import driver_inputs
    from grtcode_tpu_torch.apps import circ
    from grtcode_tpu_torch.gas_optics import gas_optics as go
    from grtcode_tpu_torch.gas_optics import voigt_kernel as vk
    from grtcode_tpu_torch.solvers import disort
    from grtcode_tpu_torch.solvers.disort import disort_shortwave
    from grtcode_tpu_torch.spectral import SpectralGrid

    t0 = time.perf_counter()
    driver_inputs.write_inputs(d)
    par = os.path.join(d, "hitran.par")
    n_records = write_hitran_par(par, SpectralGrid(1.0, 3250.0, 0.1),
                                 SpectralGrid(1.0, 50000.0, 1.0))
    write_s = time.perf_counter() - t0

    def path(name):
        return os.path.join(d, name)

    argv = [par, path("solar.csv"), "-h2o-ctm", path("h2o_ctm"), "-o3-ctm",
            path("o3_ctm.csv"), "-CFC-11", path("cfc11.csv"), "-CFC-12",
            path("cfc12.csv"), "-N2-N2", path("cia_n2n2.csv"), "-O2-N2",
            path("cia_o2n2.csv"), "-o", ""]

    # The .par parse, timed apart (with each parse's window and line
    # count), and the driver the app builds.
    parse_s, parsed, built = [], [], []
    parse, build_driver = go.parse_par_file, circ.build_driver

    def timed_parse(path, mol_id, w0, wn, **k):
        t = time.perf_counter()
        out = parse(path, mol_id, w0, wn, **k)
        parse_s.append(time.perf_counter() - t)
        parsed.append((wn, out.num_lines))
        return out

    def keep_driver(*a, **k):
        built.append(build_driver(*a, **k))
        return built[-1]

    go.parse_par_file, circ.build_driver = timed_parse, keep_driver
    # (b) The app, two-stream, with every launch and parse count starting
    # at 0.
    vk.accumulate_voigt.launches = 0
    vk.voigt_line_sample_reference.launches = 0
    parses = parse.parses
    parses.update(native=0, python=0)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = circ.main(argv, device=dev)
        torch.cuda.synchronize()
        app_s = time.perf_counter() - t0
        app_peak = torch.cuda.max_memory_allocated()
    finally:
        go.parse_par_file, circ.build_driver = parse, build_driver
    app_launches = vk.accumulate_voigt.launches
    check(vk.voigt_line_sample_reference.launches == 0,
          "the plain version ran in the CIRC app")
    parses = dict(parses)
    check(parses == {"native": 14, "python": 0},
          f"parses by path {parses}: expected all 14 native")
    # One parse of the file's H2O lines by the native scanner and by the
    # Python loop, in turns on this host.
    from grtcode_tpu_torch import native
    scan = {"native": [], "python": []}
    native_scan = native.parse_par_native
    for way in ("native", "python", "python", "native"):
        if way == "python":
            native.parse_par_native = lambda *a, **k: None
        try:
            t = time.perf_counter()
            parse(par, 1)
            scan[way].append(time.perf_counter() - t)
        finally:
            native.parse_par_native = native_scan
    driver = built[0]
    mols = {g: len(gas.molecules) for g, gas in
            (("lw", driver.lw_gas), ("sw", driver.sw_gas))}
    check(mols == {"lw": 7, "sw": 7}, f"molecules by band {mols}")
    per_run = mols["lw"] + mols["sw"]
    check(app_launches == per_run,
          f"{app_launches} K1 launches in the app, expected {per_run}")
    lines = {g: sum(n for wn, n in parsed if wn == gas.grid.wn)
             for g, gas in (("lw", driver.lw_gas), ("sw", driver.sw_gas))}
    two = {k: v.cpu().numpy().astype(np.float64)
           for k, v in res.tiers["csaf"].items()}
    check(list(res.tiers) == ["csaf"], f"tiers {list(res.tiers)}")
    nlev = two["rlu"].shape[1]
    for var, v in two.items():
        check(v.shape == (1, nlev) and np.isfinite(v).all(),
              f"app {var}: shape {v.shape} or not finite")
        check((v >= 0).all(), f"app {var}: negative flux")
    values = {name: float(res.variable(name)[0])
              for name in circ.CASE1_REFERENCE}
    check(abs(values["RSDTCSAF"] - 912.79) < 1.0,
          f"RSDTCSAF {values['RSDTCSAF']:.4f} vs TSI * mu0 912.79")

    # (c) The same driver with the 16-stream DISORT.
    atm = circ.case1_atmosphere()
    ddriver = dataclasses.replace(driver, sw_solver="disort",
                                  disort_streams=16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # K3: one launch a wavenumber block of the lit column's SW band, and
    # the masked loop never on the card.
    wchunk = inspect.signature(disort_shortwave).parameters["wchunk"].default
    k3_per_step = -(-ddriver.sw_gas.grid.n // wchunk)
    disort.layer_operators.launches = 0
    plain_loop = disort.layer_operators_plain

    def no_loop(dtau, *a, **k):
        check(dtau.device.type == "cpu", "the masked loop ran on the card")
        return plain_loop(dtau, *a, **k)
    disort.layer_operators_plain = no_loop
    step_s = []
    try:
        for i in range(4):
            before = (vk.accumulate_voigt.launches,
                      disort.layer_operators.launches)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            dres = ddriver.run(atm, integrated=True).tiers["csaf"]
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
            k1 = vk.accumulate_voigt.launches - before[0]
            k3 = disort.layer_operators.launches - before[1]
            check(k1 == per_run, f"DISORT step {i}: {k1} K1 launches, "
                  f"expected {per_run}")
            check(k3 == k3_per_step, f"DISORT step {i}: {k3} K3 launches, "
                  f"expected {k3_per_step}")
    finally:
        disort.layer_operators_plain = plain_loop
    launches = vk.accumulate_voigt.launches
    check(vk.voigt_line_sample_reference.launches == 0,
          "the plain version ran in the DISORT steps")
    peak = torch.cuda.max_memory_allocated()
    many = {k: v.cpu().numpy().astype(np.float64) for k, v in dres.items()}
    for var, v in many.items():
        check(np.isfinite(v).all() and (v >= 0).all(),
              f"DISORT {var}: not finite or negative")
    rsdt_rel = abs(many["rsd"][0, 0] - two["rsd"][0, 0]) / two["rsd"][0, 0]
    check(rsdt_rel < 1e-5, f"DISORT RSDTCSAF vs two-stream: {rsdt_rel:.2e}")
    band = {}
    for var in ("rsu", "rsd"):
        a, b = many[var][0], two[var][0]
        band[var] = float((np.abs(a - b) / (0.12 * np.abs(b).max()
                                            + 1e-3)).max())
        check(band[var] <= 1.0, f"DISORT {var} outside the two-stream band "
              f"({band[var]:.3f} of it)")
    for var in ("rlu", "rld"):
        check(np.array_equal(many[var], two[var]),
              f"DISORT changed the longwave {var}")
    ms = 1e3 * float(np.mean(step_s[2:]))   # after warm-up, capture
    graph_turns(info, "CIRC two-stream",
                lambda: driver.run(atm, integrated=True),
                [driver._step_cache])
    turns = graph_turns(
        info, "CIRC DISORT", lambda: ddriver.run(atm, integrated=True),
        [ddriver._step_cache], tol=(TOL_GOLDEN, "cuBLAS and cuSOLVER may "
                                    "pick other algorithms inside a capture"))
    check(turns["launches_per_step"][2] == k3_per_step,
          f"phase 17 CIRC DISORT: {turns['launches_per_step'][2]} K3 "
          f"launches a replayed step, expected {k3_per_step}")
    breakdown = profile_step(lambda: ddriver.run(atm, integrated=True))
    disort_share = breakdown.get("disort_ms", 0.0) / breakdown["busy_ms"] \
        if "busy_ms" in breakdown else None
    two_ms = cuda_ms(lambda: driver.run(atm, integrated=True), 3)
    # What DISORT adds to the step, as a share of it.
    added_share = (ms - two_ms) / ms
    # K1's bound on the run: the sum of its 14 launches' (one census each).
    part = {"p_lev": atm.level_pressure, "t_lev": atm.level_temperature,
            "vmr": dict(atm.ppmv)}
    k1_bound_ms, bound_by = 0.0, []
    for gas in (driver.lw_gas, driver.sw_gas):
        for mol in gas.molecules:
            prep, _, kw = band_prep(gas, mol, part, dev)
            b = k1_bound(prep, gas.chunk_ranges[mol], **kw)
            k1_bound_ms += b["bound_ms"]
            bound_by.append(b["bound_by"])
            del prep
    k1_ms = breakdown.get("kernel_ms", {}).get("voigt_line_sample", 0.0)
    # K1 against the plain version on the app's own driver and case-1
    # atmosphere: 54 rows, H2O in each band (the SW band at 1.0 cm-1 also
    # carries the LW lines).  The counts above were read before these.
    k1_vs_plain = [full_rows_vs_plain(gas, 1, part, dev, kernel_reps=3,
                                      plain_reps=1)
                   for gas in (driver.lw_gas, driver.sw_gas)]
    k1_err = max(r["max_abs_err"] for r in k1_vs_plain)

    # (d) DISORT's analytic cases on the card, and the card against the
    # CPU on the same optics (one column, 54 layers, 1,024 points).
    analytic = disort_analytic_cases(dev)
    rng = np.random.default_rng(10)
    nl, nw = 54, 1024
    optics = [torch.as_tensor(a, dtype=torch.float32) for a in (
        10.0 ** rng.uniform(-6, 2, (nl, nw)), rng.uniform(0, 1, (nl, nw)),
        rng.uniform(-0.2, 0.9, (nl, nw)), np.float64(atm.cos_zenith[0]),
        rng.uniform(0, 0.5, nw), np.float64(atm.total_solar_irradiance[0]),
        rng.uniform(0.5, 1.5, nw))]
    card_vs_cpu = 0.0
    for got, want in zip(disort_shortwave(*(a.to(dev) for a in optics)),
                         disort_shortwave(*optics)):
        want = want.numpy().astype(np.float64)
        err = np.abs(got.cpu().numpy() - want) / \
            np.abs(want).max(axis=-1, keepdims=True)
        card_vs_cpu = max(card_vs_cpu, float(err.max()))
    check(card_vs_cpu < 1e-4, f"DISORT card vs CPU: {card_vs_cpu:.2e} of "
          "the level's largest flux")
    # One wchunk block at the batched steps' width (32 columns, 54 layers,
    # 2,048 points, 16 streams): its peak memory bounds what DISORT adds to
    # a step of 32 lit columns, since the blocks run one after another.
    batched = [a.expand(32, *a.shape)[..., :2048].contiguous().to(dev)
               for a in optics[:-1]] + [optics[-1][:2048].to(dev)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    block_ms = cuda_ms(lambda: disort_shortwave(*batched), 1)
    block_peak = torch.cuda.max_memory_allocated() - base
    del batched
    # (e) K3 against the masked loop at the main path's blocks.
    k3 = disort_kernel_vs_plain(dev)

    info["phase10"] = dict(
        card=card, records=n_records, lines=lines, write_s=write_s,
        app_s=app_s, parse_s=sum(parse_s), parses=len(parse_s),
        parses_by_path=parses, h2o_parse_s=scan,
        app_launches=app_launches, values=values,
        reference=circ.CASE1_REFERENCE, nw=[driver.lw_gas.grid.n,
                                            driver.sw_gas.grid.n],
        disort_step_s=step_s, disort_ms_per_step=ms,
        two_stream_ms_per_step=two_ms, disort_peak_bytes=peak,
        disort_share=disort_share, added_share=added_share,
        profile=breakdown,
        disort_band_share=band, rsdt_rel=rsdt_rel, launches=launches,
        k1_ms=k1_ms, k1_bound_ms=k1_bound_ms,
        k1_bound_by={b: bound_by.count(b) for b in set(bound_by)},
        k1_vs_plain=k1_vs_plain, analytic_share=analytic,
        card_vs_cpu=card_vs_cpu, disort_b32_block_ms=block_ms,
        disort_b32_block_peak_bytes=block_peak, k3_per_step=k3_per_step,
        k3_profiled_ms=breakdown.get("kernel_ms", {}).get("disort_doubling"),
        k3=k3)
    table = ", ".join(
        f"{k} {v:.2f} (LBLRTM {circ.CASE1_REFERENCE[k]['lblrtm']})"
        for k, v in values.items())
    print(f"phase 10 CIRC app ({card}): {n_records} .par records written in "
          f"{write_s:.1f} s; circ.main (LW {driver.lw_gas.grid.n} + SW "
          f"{driver.sw_gas.grid.n} points, {lines['lw']} + {lines['sw']} "
          f"lines) {app_s:.1f} s wall of which the .par parse "
          f"{sum(parse_s):.2f} s ({parses['native']} parses by the native "
          f"scanner, {parses['python']} in Python; one parse of the file's "
          f"H2O lines, in turns: native {np.mean(scan['native']):.3f} s, "
          f"Python {np.mean(scan['python']):.3f} s), {app_launches} K1 "
          f"launches, no plain launch; {table}; 16-stream DISORT step "
          f"{ms:.1f} ms (steps {[round(v, 3) for v in step_s]} s, "
          f"{k3_per_step} K3 launches each, no masked loop) against "
          f"the two-stream step's {two_ms:.1f} ms ({added_share:.1%} of the "
          f"step added by DISORT), DISORT "
          f"{breakdown.get('disort_ms', 0.0):.1f} ms of the profiled step's "
          f"kernels ({disort_share if disort_share is None else f'{disort_share:.1%}'} of busy), "
          f"peak {peak / 2 ** 30:.2f} GiB, RSDTCSAF within {rsdt_rel:.1e} of "
          f"the two-stream's, rsu / rsd at {band['rsu']:.3f} / "
          f"{band['rsd']:.3f} of the two-stream band; profiled step: "
          f"{breakdown['summary']}; K1 bound on the run {k1_bound_ms:.2f} ms "
          f"({bound_by.count('operations')} of {per_run} launches by "
          f"operations; {k1_bound_ms / k1_ms if k1_ms else 0.0:.1%} of it "
          f"reached); K1 vs plain on the app's 54 rows within rtol 2e-6 / "
          f"atol 1e-12: {'; '.join(r['summary'] for r in k1_vs_plain)}; "
          f"analytic cases at most "
          f"{max(analytic.values()):.3f} of their bars; card vs CPU "
          f"{card_vs_cpu:.2e} of the level's largest flux (bar 1e-4); one "
          f"DISORT block of 32 columns x 54 layers x 2048 points "
          f"{block_ms:.1f} ms, peak {block_peak / 2 ** 30:.2f} GiB above "
          f"its inputs; K3 vs plain: {k3['summary']}", flush=True)
    return launches, k1_err, k3


def disort_kernel_vs_plain(dev):
    """Phase 10 (e): K3 (``disort.layer_operators``) against its plain
    version (``layer_operators_plain``, the masked loop) on the card at
    the main path's blocks at 16 streams: the CIRC cell's 2,048-point
    block and its 848-point tail on one column, and chip_smoke's block of
    32 columns; 54 layers, counts 0-37 (tau log-uniform over 1e-9-0.3, at
    every 8th wavenumber over 0.3-1e7, and 0, 1e-12, 1e-5, 2e-5, the
    clamp and beyond it), omega under 0.99 as tests/test_torch_gpu.py's
    inputs.  R, T, sr, st and d within DISORT_TOL of each layer's largest
    entry, one launch each, the needed steps equal; each block timed, K3
    and the masked loop, with K3's bound from its needed doublings."""
    import torch
    from grtcode_tpu_torch.kernel_bench import k3_bound
    from grtcode_tpu_torch.solvers import disort
    from grtcode_tpu_torch.utils import metrics

    nstr, h = 16, 8
    rng = np.random.default_rng(11)
    blocks = {}
    for B, nw in ((1, 2048), (1, 848), (32, 2048)):
        tau = 10.0 ** rng.uniform(-9, -0.5, (B, 54, nw))
        tau[..., ::8] = 10.0 ** rng.uniform(-0.5, 7, tau[..., ::8].shape)
        tau[:, 0, :6] = [0.0, 1e-12, 1e-5, 2e-5, 1e6, 1e12]
        f32 = [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (
            tau, rng.uniform(0, 0.99, tau.shape),
            rng.uniform(-0.2, 0.9, tau.shape), rng.uniform(0.05, 1.0, B))]
        sub = disort.sublayers(*f32[:3], nstr)
        mu0 = f32[3]
        args = (*sub, mu0, *disort.beam_vectors(mu0, nstr))
        counts = [metrics.DoublingCounts(dev) for _ in range(2)]
        before = disort.layer_operators.launches
        got = disort.layer_operators(*args, doublings=counts[0])
        want = disort.layer_operators_plain(*args, doublings=counts[1])
        torch.cuda.synchronize()
        launches = disort.layer_operators.launches - before
        check(launches == 1, f"K3 {B}x54x{nw}: {launches} launches")
        worst = worst_abs = 0.0
        for name, a, b in zip(("R", "T", "sr", "st", "d"), got, want):
            check(bool(torch.isfinite(a).all()),
                  f"K3 {B}x54x{nw}: {name} not finite")
            dims = tuple(range(2, b.dim()))
            scale = b.abs().amax(dim=dims, keepdim=True).clamp(min=1e-30)
            err = float(((a - b).abs() / scale).max())
            check(err < DISORT_TOL, f"K3 {B}x54x{nw}: {name} {err:.2e} of "
                  f"the layer's largest entry, bar {DISORT_TOL}")
            worst = max(worst, err)
            worst_abs = max(worst_abs, float((a - b).abs().max()))
        k = sub[3]
        kmin, kmax = int(k.min()), int(k.max())
        check(kmin == 0 and kmax == 37, f"K3 {B}x54x{nw}: counts "
              f"{kmin}-{kmax}, expected 0-37")
        read = [c.read() for c in counts]
        check(read[0]["needed"] == read[1]["needed"],
              f"K3 {B}x54x{nw}: needed {read[0]['needed']} vs the plain "
              f"loop's {read[1]['needed']}")
        del got, want
        ms = cuda_ms(lambda: disort.layer_operators(*args), 5)
        plain_ms = cuda_ms(lambda: disort.layer_operators_plain(*args), 1)
        bound = k3_bound(read[0]["needed"], k.numel(), h)
        blocks[f"{B}x54x{nw}"] = dict(
            max_rel_err=worst, max_abs_err=worst_abs, ms=ms,
            plain_ms=plain_ms,
            needed=read[0]["needed"], run=read[0]["run"],
            elements=k.numel(), **bound)
        del args, sub, f32
        torch.cuda.empty_cache()
    summary = "; ".join(
        f"{name} {b['max_rel_err']:.2e} of the layer's largest entry (bar "
        f"{DISORT_TOL}), {b['ms']:.3f} ms vs the masked loop's "
        f"{b['plain_ms']:.1f} ms, bound {b['bound_ms']:.3f} ms by "
        f"{b['bound_by']} ({b['bound_ms'] / b['ms']:.1%} of it reached), "
        f"needed {b['needed']} of {b['run']} run steps"
        for name, b in blocks.items())
    return dict(blocks=blocks, summary=summary,
                max_rel_err=max(b["max_rel_err"] for b in blocks.values()),
                max_abs_err=max(b["max_abs_err"] for b in blocks.values()))


def _run_on_rank(run, caches=()):
    """``run()`` timed on this rank after a barrier (when a group is up),
    with K1's launch counts and the device's peak memory from 0: (its
    result, {s, peak_bytes, k1_launches, plain_launches}).  Then the
    StepCaches ``caches`` are cleared: the ranks share one card, so each
    of a rank's runs is the eager first call of its key and holds no
    graph."""
    import torch
    import torch.distributed as dist
    from grtcode_tpu_torch.gas_optics import voigt_kernel as vk

    if dist.is_initialized():
        dist.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    vk.accumulate_voigt.launches = 0
    vk.voigt_line_sample_reference.launches = 0
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    got = dict(s=time.perf_counter() - t0,
               peak_bytes=torch.cuda.max_memory_allocated(),
               k1_launches=vk.accumulate_voigt.launches,
               plain_launches=vk.voigt_line_sample_reference.launches)
    for cache in caches:
        cache.clear()
    if caches:
        torch.cuda.empty_cache()
    return out, got


def _against(got, want):
    """(bit-identical, largest |got - want| / |want|, the columns that are
    bit-identical in every flux) of two {flux: (B, nlev)} dicts."""
    import torch
    rel, same = 0.0, None
    for k, w in want.items():
        d = (got[k] - w).abs()
        rel = max(rel, float(torch.where(w != 0, d / w.abs(), d).max()))
        cols = (d == 0).all(-1)
        same = cols if same is None else same & cols
    return bool(same.all()), rel, int(same.sum())


def _mesh_rank(rank, store, out_dir):
    """One of phase 11's two ranks, both on cuda:0 in one gloo group (NCCL
    refuses two ranks on one GPU: "Duplicate GPU detected"): the
    line_sample cell without a mesh and on meshes (1 x 2) and (2 x 1),
    then the all-sky cell's segments with each rank a node of its own.
    Rank 0 then runs the same two segments and the whole all-sky batch in
    one process without a group.  Writes out_dir/rank<r>.json."""
    import torch
    import torch.distributed as dist
    from grtcode_tpu_torch import examples
    from grtcode_tpu_torch.framework.driver import RadiationDriver
    from grtcode_tpu_torch.parallel import distributed, make_mesh

    torch.backends.cudnn.allow_tf32 = False
    dev = distributed.initialize(store, 2, rank, timeout_s=MESH_TIMEOUT_S)
    report = dict(rank=rank, device=str(dev), backend=dist.get_backend())
    try:
        t0 = time.perf_counter()
        lw_gas, sw_gas, solar, batch, _, _ = examples.rfmip_like(device=dev)
        driver = RadiationDriver(lw_gas, sw_gas, solar)
        atm = examples.atmosphere(batch)
        report["setup_s"] = time.perf_counter() - t0
        want = {}
        for S in (2, 1):
            want[S], report[f"single_S{S}"] = _run_on_rank(
                lambda: driver.run(atm, spectral_chunks=S).tiers["csaf"],
                [driver._step_cache])
        for C, S in ((1, 2), (2, 1)):
            mesh = make_mesh(C, S)
            got, run = _run_on_rank(
                lambda: driver.run(atm, mesh=mesh).tiers["csaf"],
                [driver._step_cache])
            run["identical"], run["max_rel"], run["identical_columns"] = \
                _against(got, want[S])
            report[f"mesh_{C}x{S}"] = run
        del driver, want, got
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        adriver, aatm = examples.allsky_like(device=dev)
        report["allsky_setup_s"] = time.perf_counter() - t0
        # From here on each rank is a node of its own, so the segments
        # are two; the group stays gloo, both ranks sharing cuda:0.
        os.environ["LOCAL_WORLD_SIZE"] = "1"
        _, report["segment"] = _run_on_rank(
            lambda: distributed.run_driver_segment(
                adriver, aatm, os.path.join(out_dir, "mesh"), "allsky"))
    finally:
        dist.destroy_process_group()
    if rank == 0:
        def single():
            for p in range(2):
                distributed.run_driver_segment(
                    adriver, aatm, os.path.join(out_dir, "single"),
                    "allsky", process_index=p, num_processes=2)
            return adriver.run(aatm).tiers
        whole, report["single_segments"] = _run_on_rank(single)
        np.savez(os.path.join(out_dir, "whole.npz"),
                 **{f"{t}_{k}": v.cpu().numpy() for t, fx in whole.items()
                    for k, v in fx.items()})
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def phase_mesh(info, dev, card):
    """The (columns x spectral) mesh and the segments on the card.
    Returns the line_sample cell (driver, atmosphere, B, nlayers) for
    phase 12 and K1's launches on the mesh runs and segments."""
    import torch
    import torch.distributed as dist
    from grtcode_tpu_torch import examples
    from grtcode_tpu_torch.framework.driver import (RadiationDriver,
                                                    _mesh_all_gather)
    from grtcode_tpu_torch.parallel import distributed, dryrun, make_mesh
    from grtcode_tpu_torch.parallel.mesh import COLUMNS_AXIS, SPECTRAL_AXIS

    os.makedirs(BUILD_DIR, exist_ok=True)
    out_dir = os.path.abspath(tempfile.mkdtemp(dir=BUILD_DIR))
    t_phase = time.perf_counter()
    lw_gas, sw_gas, solar, batch, B, nlayers = examples.rfmip_like(
        device=dev)
    driver = RadiationDriver(lw_gas, sw_gas, solar)
    atm = examples.atmosphere(batch)
    n_mol = len(lw_gas.molecules) + len(sw_gas.molecules)

    # (a) A world of one NCCL rank on cuda:0, make_mesh(1, 1).  A mesh
    # of one gathers nothing, so the mesh's all_gather of CUDA tensors
    # (no host copy under NCCL) is also called along each axis.
    distributed.initialize(f"file://{out_dir}/store_nccl", 1, 0,
                           timeout_s=MESH_TIMEOUT_S)
    try:
        backend = dist.get_backend()
        check(backend == "nccl", f"a world of one rank on {dev}: {backend}")
        want, single = _run_on_rank(lambda: driver.run(atm).tiers["csaf"])
        mesh = make_mesh(1, 1)
        got, one = _run_on_rank(
            lambda: driver.run(atm, mesh=mesh).tiers["csaf"])
        gathers = {}
        for axis in (COLUMNS_AXIS, SPECTRAL_AXIS):
            for k, v in got.items():
                parts, run = _run_on_rank(
                    lambda: _mesh_all_gather(mesh, axis, v))
                check(len(parts) == 1 and parts[0].device == dev
                      and parts[0].data_ptr() != v.data_ptr()
                      and torch.equal(parts[0].view(torch.int32),
                                      v.view(torch.int32)),
                      f"NCCL all_gather of {k} along {axis}: "
                      f"{[(p.device, p.shape) for p in parts]}")
                gathers[f"{axis}_{k}"] = run["s"]
    finally:
        dist.destroy_process_group()
    one["gather_s"] = gathers
    one["identical"], one["max_rel"], _ = _against(got, want)
    check(one["identical"], f"NCCL (1 x 1) mesh differs from run(): max rel "
          f"{one['max_rel']:.2e}")
    check(one["k1_launches"] == n_mol and one["plain_launches"] == 0,
          f"NCCL (1 x 1): {one['k1_launches']} K1 launches")
    del want, got
    # The two ranks below share the card: this process's graphs go first
    # (phases 12 and 13 warm up and capture the cell's again).
    driver.clear_cache()

    # (b) Two ranks on cuda:0 (gloo), spawned with a deadline.
    t0 = time.perf_counter()
    dryrun.spawn(_mesh_rank, 2, (f"file://{out_dir}/store_gloo", out_dir),
                 timeout_s=MESH_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    launches = one["k1_launches"]
    for rep in ranks:
        check(rep["backend"] == "gloo" and rep["device"] == str(dev),
              f"rank {rep['rank']}: {rep['backend']} on {rep['device']}")
        for key in ("mesh_1x2", "mesh_2x1", "segment"):
            run = rep[key]
            check(run["plain_launches"] == 0,
                  f"rank {rep['rank']} {key}: the plain version ran")
            launches += run["k1_launches"]
        for key in ("mesh_1x2", "mesh_2x1"):
            check(rep[key]["k1_launches"] == n_mol,
                  f"rank {rep['rank']} {key}: {rep[key]['k1_launches']} K1 "
                  f"launches, expected {n_mol}")
        check(rep["mesh_1x2"]["identical"], f"rank {rep['rank']}: (1 x 2) "
              f"differs from run(spectral_chunks=2): max rel "
              f"{rep['mesh_1x2']['max_rel']:.2e}")
        check(rep["mesh_2x1"]["max_rel"] <= TOL_MESH_COLUMNS,
              f"rank {rep['rank']}: (2 x 1) against run(): max rel "
              f"{rep['mesh_2x1']['max_rel']:.2e} > {TOL_MESH_COLUMNS}")
    combined = distributed.combine_column_segments(
        os.path.join(out_dir, "mesh"), "allsky")
    single_segs = distributed.combine_column_segments(
        os.path.join(out_dir, "single"), "allsky")
    check(sorted(combined) == sorted(single_segs) and len(combined) == 12,
          f"segment arrays {sorted(combined)}")
    for k, v in single_segs.items():
        check(combined[k].tobytes() == v.tobytes(),
              f"segments {k}: the two ranks' differ from one process's")
    with np.load(os.path.join(out_dir, "whole.npz")) as z:
        whole = {k: torch.as_tensor(z[k]) for k in z.files}
    seg_identical, seg_rel, _ = _against(
        {k: torch.as_tensor(v) for k, v in combined.items()}, whole)
    check(seg_rel <= TOL_MESH_COLUMNS, f"segments against the whole all-sky "
          f"batch: max rel {seg_rel:.2e} > {TOL_MESH_COLUMNS}")
    phase_s = time.perf_counter() - t_phase

    info["phase11"] = dict(card=card, nccl_1x1=one, nccl_single=single,
                           ranks=ranks, spawn_s=spawn_s, phase_s=phase_s,
                           segments_identical_to_whole=seg_identical,
                           segments_max_rel_to_whole=seg_rel,
                           launches=launches)

    def run_line(key):
        return "; ".join(
            f"rank {rep['rank']} {rep[key]['s'] * 1e3:.1f} ms, peak "
            f"{rep[key]['peak_bytes'] / 2 ** 30:.2f} GiB, "
            f"{rep[key]['k1_launches']} K1 launches" for rep in ranks)

    m21 = max(rep["mesh_2x1"]["max_rel"] for rep in ranks)
    cols21 = min(rep["mesh_2x1"]["identical_columns"] for rep in ranks)
    print(f"phase 11 mesh and segments ({card}): B={B} x {nlayers} layers x "
          f"({lw_gas.grid.n} + {sw_gas.grid.n}) points; (a) NCCL world of one "
          f"on {dev}, make_mesh(1, 1): {one['s'] * 1e3:.1f} ms (run() "
          f"{single['s'] * 1e3:.1f} ms), peak "
          f"{one['peak_bytes'] / 2 ** 30:.2f} GiB, {one['k1_launches']} K1 "
          f"launches, bit-identical to run(); NCCL all_gather of the 4 "
          f"fluxes along both axes on {dev}, bit-identical, "
          f"{sum(gathers.values()) * 1e3:.2f} ms for the 8; (b) 2 ranks on "
          f"{dev} (gloo), "
          f"spawned in {spawn_s:.1f} s (setup {ranks[0]['setup_s']:.1f} + "
          f"{ranks[0]['allsky_setup_s']:.1f} s a rank): mesh (1 x 2) "
          f"[{run_line('mesh_1x2')}] bit-identical to run(spectral_chunks=2) "
          f"on both ranks; mesh (2 x 1) [{run_line('mesh_2x1')}] against "
          f"run(): {cols21} of {B} columns bit-identical, max rel {m21:.2e} "
          f"(bar {TOL_MESH_COLUMNS}); run_driver_segment, all-sky cell, 2 "
          f"segments [{run_line('segment')}] combined byte-identical to the "
          f"same segments in one process "
          f"({ranks[0]['single_segments']['s'] * 1e3:.1f} ms with the whole "
          f"batch), against the whole batch "
          f"{'bit-identical' if seg_identical else f'max rel {seg_rel:.2e}'}"
          f"; {launches} K1 launches in all, none plain; phase "
          f"{phase_s:.1f} s", flush=True)
    return (driver, atm, B, nlayers), launches


def phase_aux(info, dev, card, cell):
    """Metrics, a profiler trace, debug mode and the C ABI on the card.
    Returns K1's launches on the steps and the ABI's optical depths."""
    import ctypes
    import dataclasses
    import torch
    from tools.goldens import driver_inputs
    from grtcode_tpu_torch import bindings
    from grtcode_tpu_torch.bindings import capi_impl
    from grtcode_tpu_torch.gas_optics import voigt_kernel as vk
    from grtcode_tpu_torch.solvers.longwave import longwave_fluxes
    from grtcode_tpu_torch.solvers.shortwave import shortwave_fluxes
    from grtcode_tpu_torch.spectral import SpectralGrid
    from grtcode_tpu_torch.utils import debug, metrics

    t_phase = time.perf_counter()
    driver, atm, B, nlayers = cell
    nw = driver.lw_gas.grid.n + driver.sw_gas.grid.n
    n_mol = len(driver.lw_gas.molecules) + len(driver.sw_gas.molecules)
    vk.accumulate_voigt.launches = 0
    vk.voigt_line_sample_reference.launches = 0

    # (a) Metrics: three steps, points counted as phase 5 counts them.
    m = metrics.Metrics()
    points = metrics.grid_points(B, nlayers, nw)
    for _ in range(3):
        with m.phase("line_sample step", points=points) as box:
            box["result"] = driver.run(atm)
    st = m.phases["line_sample step"]
    rate = m.points_per_second("line_sample step")
    check(st.calls == 3 and st.points == 3 * B * nlayers * nw
          and rate == st.points / st.seconds, f"metrics {st}")

    # (b) A profiler trace of one step, under build/.
    logdir = os.path.join(BUILD_DIR, "trace")
    with metrics.profiler_trace(logdir):
        driver.run(atm)
        torch.cuda.synchronize()
    trace_path = os.path.join(logdir, "trace.json")
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1_events = sum("voigt_line_sample_kernel" in e.get("name", "")
                    for e in kernels)
    check(k1_events == n_mol, f"trace: {k1_events} K1 kernels, expected "
          f"{n_mol}")

    # (c) Debug mode: no trap on the clean step, a trap on one NaN
    # temperature.
    t0 = time.perf_counter()
    with debug.debug_mode():
        driver.run(atm)
        torch.cuda.synchronize()
    debug_s = time.perf_counter() - t0
    t_lev = atm.level_temperature.copy()
    t_lev[3, 20] = np.nan
    trap = None
    try:
        with debug.debug_mode():
            driver.run(dataclasses.replace(atm, level_temperature=t_lev))
    except FloatingPointError as e:
        trap = str(e)
    check(trap is not None, "debug_mode let a NaN temperature through")
    launches = vk.accumulate_voigt.launches
    check(vk.voigt_line_sample_reference.launches == 0,
          "the plain version ran in phase 12")

    # (d) The C ABI through ctypes on cuda:0, with no device selected (the
    # default is the current CUDA device): H2O optical depth from the
    # golden's .par (one K1 launch per band), LW fluxes, Rayleigh + gas
    # optics and SW fluxes, each against the port's direct call; then
    # grt_create_device(0) selects cuda:0 and gives the same LW fluxes.
    lib = bindings.load()

    def handle(fn, *args):
        h = ctypes.c_int64()
        rc = getattr(lib, fn)(*args, ctypes.byref(h))
        check(rc == 0, f"{fn}: rc {rc}: {lib.grt_errstr()}")
        return h

    def ok(fn, *args):
        rc = getattr(lib, fn)(*args)
        check(rc == 0, f"{fn}: rc {rc}: {lib.grt_errstr()}")

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    def f32(a):
        return torch.as_tensor(np.array(a, np.float64), dtype=torch.float32,
                               device=dev)

    def same(got, want):
        return got.tobytes() == want.cpu().numpy().astype(
            np.float64).ravel().tobytes()

    ok("grt_initialize")
    check(capi_impl._default_device is None,
          f"a device was selected before phase 12: "
          f"{capi_impl._default_device}")
    p = np.ascontiguousarray(atm.level_pressure[0], np.float64)
    t = np.ascontiguousarray(atm.level_temperature[0], np.float64)
    ppmv = np.ascontiguousarray(atm.ppmv[1][0], np.float64)
    nlev = p.size
    vk.accumulate_voigt.launches = 0
    with tempfile.TemporaryDirectory() as d:
        driver_inputs.write_inputs(d)

        def gas_optics(grid_args):
            grid = handle("grt_create_spectral_grid",
                          *map(ctypes.c_double, grid_args))
            gas = handle("grt_create_gas_optics", grid, ctypes.c_int(nlev),
                         os.path.join(d, "synthetic.par").encode(), b"", b"")
            go_dev = capi_impl._get(gas.value)["go"].device
            check(go_dev == dev, f"gas optics on {go_dev} with no device "
                  f"selected")
            ok("grt_add_molecule", gas, ctypes.c_int(1), ctypes.c_double(0),
               ctypes.c_double(0))
            ok("grt_set_molecule_ppmv", gas, ctypes.c_int(1), ptr(ppmv))
            opt = handle("grt_create_optics", ctypes.c_int(nlev - 1), grid)
            ok("grt_calculate_optical_depth", gas, ptr(p), ptr(t), opt)
            return grid, opt

        lw_grid_args, sw_grid_args = driver_inputs.LW_GRID, \
            driver_inputs.SW_GRID
        lw_grid, lw_opt = gas_optics(lw_grid_args)
        sw_grid, gas_opt = gas_optics(sw_grid_args)
        solar = handle("grt_create_solar_flux", sw_grid,
                       os.path.join(d, "solar.csv").encode())
    abi_launches = vk.accumulate_voigt.launches
    check(abi_launches == 2, f"{abi_launches} K1 launches through the ABI")
    lw = capi_impl._get(lw_opt.value)
    grid = SpectralGrid(*lw_grid_args)
    emis = np.full(grid.n, 0.98)
    up, down = np.zeros(nlev * grid.n), np.zeros(nlev * grid.n)
    ok("grt_longwave_fluxes", lw_opt, ctypes.c_double(t[-1] + 1.5), ptr(t),
       None, ptr(emis), ptr(up), ptr(down))
    want = longwave_fluxes(
        f32(lw["tau"]), f32(lw["omega"]), f32(np.float32(t[-1] + 1.5)),
        f32(0.5 * (t[:-1] + t[1:])), f32(t), f32(emis),
        grid.wavenumbers(dev))
    check(same(up, want[0]) and same(down, want[1]),
          "LW fluxes through the ABI differ from the direct call")
    check(np.isfinite(up).all() and up.max() > 0, "LW fluxes through the ABI")
    ok("grt_use_device", handle("grt_create_device", ctypes.c_int(0)))
    check(capi_impl._default_device == dev,
          f"grt_create_device(0) gave {capi_impl._default_device}")
    up0, down0 = np.zeros_like(up), np.zeros_like(down)
    ok("grt_longwave_fluxes", lw_opt, ctypes.c_double(t[-1] + 1.5), ptr(t),
       None, ptr(emis), ptr(up0), ptr(down0))
    check(up0.tobytes() == up.tobytes() and down0.tobytes() == down.tobytes(),
          "LW fluxes on grt_create_device(0) differ from the default's")

    ray = handle("grt_create_optics", ctypes.c_int(nlev - 1), sw_grid)
    ok("grt_rayleigh_scattering", ray, ptr(p))
    both = handle("grt_create_optics", ctypes.c_int(nlev - 1), sw_grid)
    parts = np.array([gas_opt.value, ray.value], dtype=np.int64)
    ok("grt_add_optics", both,
       parts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), ctypes.c_int(2))
    sw = capi_impl._get(both.value)
    grid = SpectralGrid(*sw_grid_args)
    alb = np.full(grid.n, 0.15)
    mu, tsi = float(atm.cos_zenith[0]), float(atm.total_solar_irradiance[0])
    sw_up, sw_down = np.zeros(nlev * grid.n), np.zeros(nlev * grid.n)
    ok("grt_shortwave_fluxes", both, ctypes.c_double(mu),
       ctypes.c_double(0.5), ptr(alb), ptr(alb), ctypes.c_double(tsi),
       solar, ptr(sw_up), ptr(sw_down))

    def scalar(v):
        return f32(np.float32(v))

    want = shortwave_fluxes(
        f32(sw["tau"]), f32(sw["omega"]), f32(sw["g"]), scalar(mu),
        scalar(0.5), f32(alb), f32(alb), scalar(tsi),
        capi_impl._get(solar.value).incident_flux.to(dev))
    check(same(sw_up, want[0]) and same(sw_down, want[1]),
          "SW fluxes through the ABI differ from the direct call")
    check(np.isfinite(sw_down).all() and sw_down.max() > 0,
          "SW fluxes through the ABI")
    for h in (lw_opt, gas_opt, ray, both, solar, lw_grid, sw_grid):
        ok("grt_destroy", h)
    phase_s = time.perf_counter() - t_phase

    info["phase12"] = dict(
        card=card, metrics=dict(seconds=st.seconds, calls=st.calls,
                                points=st.points, points_per_s=rate),
        report=m.report(), trace=trace_path, trace_events=len(events),
        trace_kernels=len(kernels), trace_k1=k1_events, debug_s=debug_s,
        trap=trap, launches=launches, abi_launches=abi_launches,
        abi_nw=[lw["tau"].shape[1], sw["tau"].shape[1]], phase_s=phase_s)
    print(f"phase 12 aux modules ({card}): Metrics over 3 line_sample steps "
          f"{st.seconds / 3 * 1e3:.1f} ms a step, {rate:.4e} points/s "
          f"({points} points a step, phase 5's count; phase 5 "
          f"{info['phase5']['points_per_s']:.4e}); profiler_trace "
          f"{trace_path}: {len(events)} events, {len(kernels)} kernels, "
          f"{k1_events} K1; debug_mode: clean step {debug_s:.2f} s, no trap; "
          f"one NaN temperature trapped: {trap!r}; C ABI on {dev} with no "
          f"device selected: H2O optical depth ({abi_launches} K1 "
          f"launches), LW fluxes ({lw['tau'].shape[1]} points) and "
          f"Rayleigh + gas SW fluxes ({sw['tau'].shape[1]} points) "
          f"bit-identical to the port's direct calls; "
          f"grt_create_device(0) gives {capi_impl._default_device} and the "
          f"same LW fluxes; phase {phase_s:.1f} s", flush=True)
    return launches + abi_launches


def phase_library(info, dev, card, cell):
    """The library path on the card: the CSAF step by hand from the public
    imports against RadiationDriver.run, Optics.sample against striding,
    the verify recipe's invariants.  Returns K1's launches on the hand
    step."""
    import torch
    from grtcode_tpu_torch import Optics, SpectralGrid, drive
    from grtcode_tpu_torch.gas_optics import voigt_kernel as vk

    t_phase = time.perf_counter()
    driver, atm, B, nlayers = cell
    lw_gas, sw_gas, solar = driver.lw_gas, driver.sw_gas, driver.solar
    n_mol = len(lw_gas.molecules) + len(sw_gas.molecules)

    # (a) One untimed hand step, then one counted and timed, then the
    # driver's step on the same atmosphere.
    drive.clear_sky_step(lw_gas, sw_gas, solar, atm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    vk.accumulate_voigt.launches = 0
    vk.voigt_line_sample_reference.launches = 0
    t0 = time.perf_counter()
    hand = drive.clear_sky_step(lw_gas, sw_gas, solar, atm)
    torch.cuda.synchronize()
    hand_ms = 1e3 * (time.perf_counter() - t0)
    launches = vk.accumulate_voigt.launches
    plain = vk.voigt_line_sample_reference.launches
    peak = torch.cuda.max_memory_allocated()
    check(launches == n_mol, f"hand step: {launches} K1 launches, expected "
          f"{n_mol}")
    check(plain == 0, f"the plain version ran {plain} times on the hand step")
    t0 = time.perf_counter()
    run = driver.run(atm).tiers["csaf"]
    torch.cuda.synchronize()
    run_ms = 1e3 * (time.perf_counter() - t0)
    worst, identical = {}, True
    for var in ("rlu", "rld", "rsu", "rsd"):
        h, r = hand[var], run[var]
        check(tuple(h.shape) == tuple(r.shape) == (B, nlayers + 1)
              and h.device == dev, f"{var}: shape {tuple(h.shape)}")
        check(bool(torch.isfinite(h).all()), f"{var}: not finite")
        largest = r.abs().amax(dim=0).clamp_min(1e-30)
        worst[var] = float(((h - r).abs().amax(dim=0) / largest).max())
        identical = identical and torch.equal(h, r)
        check(worst[var] <= TOL_LIBRARY, f"hand step {var}: worst error "
              f"{worst[var]:.3e} of the level's largest flux")

    # (b) Optics.sample from the 0.1 grid to its 1.0 sub-grid.
    def vmr(ppmv):
        return {k: np.asarray(v, np.float64) * 1e-6 for k, v in ppmv.items()}

    gas = Optics.from_tau(lw_gas.optical_depth(
        atm.level_pressure, atm.level_temperature, vmr(atm.ppmv),
        cfc_vmr=vmr(atm.cfc_ppmv), cia_vmr=vmr(atm.cia_ppmv)), lw_gas.grid)
    coarse = SpectralGrid(lw_gas.grid.w0, lw_gas.grid.wn,
                          10 * lw_gas.grid.dw)
    sampled = gas.sample(coarse)
    for name in ("tau", "omega", "g"):
        t, full = getattr(sampled, name), getattr(gas, name)
        check(t.device == dev and t.data_ptr() == full.data_ptr()
              and torch.equal(t, full[..., ::10]),
              f"sample {name} differs from striding")
    check(sampled.grid == coarse and sampled.tau.shape[-1] == coarse.n,
          f"sample: grid {sampled.grid}, {tuple(sampled.tau.shape)}")
    sample_shape = tuple(sampled.tau.shape)
    del gas, sampled

    # (c) The verify recipe's invariants.
    checks = drive.physics_invariants(dev)
    failed = [c["name"] for c in checks if not c["ok"]]
    phase_s = time.perf_counter() - t_phase
    info["phase13"] = dict(
        card=card, hand_ms=hand_ms, run_ms=run_ms, peak_bytes=peak,
        launches=launches, worst=worst, bit_identical=identical,
        sample_shape=sample_shape, sample_dw=[lw_gas.grid.dw, coarse.dw],
        invariants=checks, phase_s=phase_s)
    print(f"phase 13 library path ({card}): hand-built CSAF step at B={B} x "
          f"{nlayers} layers, {launches} K1 launches, {hand_ms:.1f} ms "
          f"(RadiationDriver.run {run_ms:.1f} ms), peak "
          f"{peak / 2 ** 30:.2f} GiB; against run(): worst error "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" of the level's largest flux (bar {TOL_LIBRARY}), "
          f"{'bit-identical' if identical else 'not bit-identical'}; "
          f"Optics.sample {lw_gas.grid.dw} -> {coarse.dw} cm-1 "
          f"{sample_shape} equal to tau[..., ::10] as views; invariants: "
          + "; ".join(f"{c['name']} {c['value']:.4g} (bar {c['bar']})"
                      for c in checks)
          + f"; phase {phase_s:.1f} s", flush=True)
    check(not failed, f"physics invariants failed: {failed}")
    return launches


def _timed_build(build, steps):
    """``build`` (an app's ``build_driver``) whose drivers time each
    ``run`` to a synchronize and keep (seconds, driver, result, (args,
    keywords)) in ``steps``."""
    import torch

    def wrapper(*a, **k):
        driver = build(*a, **k)
        run = driver.run

        def timed_run(*ra, **rk):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = run(*ra, **rk)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t, driver, out, (ra, rk)))
            return out

        driver.run = timed_run
        return driver

    return wrapper


def _run_app(main, argv, dev, patch):
    """``main(argv, device=dev)`` with K1's counts and the device's peak
    from 0, the .par parses timed apart and ``patch`` (module, name,
    wrapper) applied: (wall s, parse s, parses, K1 launches, plain
    launches, peak bytes allocated, peak bytes reserved)."""
    import torch
    from grtcode_tpu_torch.gas_optics import gas_optics as go
    from grtcode_tpu_torch.gas_optics import voigt_kernel as vk

    parse, parse_s = go.parse_par_file, []

    def timed_parse(*a, **k):
        t = time.perf_counter()
        out = parse(*a, **k)
        parse_s.append(time.perf_counter() - t)
        return out

    module, name, wrapper = patch
    real = getattr(module, name)
    go.parse_par_file = timed_parse
    setattr(module, name, wrapper(real))
    vk.accumulate_voigt.launches = 0
    vk.voigt_line_sample_reference.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        main(argv, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        go.parse_par_file = parse
        setattr(module, name, real)
    return (wall, sum(parse_s), len(parse_s), vk.accumulate_voigt.launches,
            vk.voigt_line_sample_reference.launches,
            torch.cuda.max_memory_allocated(),
            torch.cuda.max_memory_reserved())


def phase_apps_io(info, dev, card, d):
    """Phase 14: the apps with file IO on the card, through the port's
    own netCDF-4 reader and writer (no h5py).  (a) The h5py-written
    fixtures of tests/data/torch_ncio/ against their .npz values; (b)
    RFMIP-IRF at full width on phase 10's .par and tables in ``d``: an
    input of 100 sites x 18 experiments x 61 levels written by the port,
    experiment 0 over all sites at the default grids, -integrated -o; the
    file read back equal to the run's fluxes; 14 K1 launches, none plain;
    K1 against the plain version on one LW launch at these 6,000 rows;
    (c) the cloudy ERA5 app (-sw, Pade tables written by the port) over
    1 x 8 x 16 columns of 37 levels, its file read back: written fluxes
    finite, variables only defined at the fill value with no storage.
    Returns K1's launches on both apps and its error against the plain
    version."""
    import torch
    from grtcode_tpu_torch import examples
    from grtcode_tpu_torch.apps import circ, era5, rfmip
    from grtcode_tpu_torch.clouds.pade import synthetic_pade_table
    from grtcode_tpu_torch.framework.driver import bucket_pad
    from grtcode_tpu_torch.gas_optics import voigt_kernel as vk
    from grtcode_tpu_torch.gas_optics.molecules import MoleculeId
    from grtcode_tpu_torch.utils import hdf5, ncio

    t_phase = time.perf_counter()

    # (a) The fixtures, bit for bit.
    data = os.path.join("tests", "data", "torch_ncio")
    expected = np.load(os.path.join(data, "expected.npz"))
    for key in expected.files:
        fname, _, name = key.partition("/")
        with hdf5.File(os.path.join(data, fname)) as f:
            got = np.asarray(f[name].read())
        want = expected[key]
        check(got.dtype == want.dtype and got.shape == want.shape
              and got.tobytes() == want.tobytes(),
              f"fixture {key}: read {got.dtype} {got.shape} unlike "
              f"{want.dtype} {want.shape} or not bit for bit")
    fixtures = len(expected.files)

    def path(name):
        return os.path.join(d, name)

    tables = ["-h2o-ctm", path("h2o_ctm"), "-o3-ctm", path("o3_ctm.csv")]

    # (b) RFMIP-IRF: experiment 0, all 100 sites, default grids.
    t0 = time.perf_counter()
    examples.write_rfmip_input(path("rfmip.nc"))
    rfmip_write_s = time.perf_counter() - t0
    out = path("rfmip_fluxes.nc")
    argv = [path("hitran.par"), path("solar.csv"), path("rfmip.nc"), "0"] \
        + tables + ["-CFC-11", path("cfc11.csv"), "-CFC-12",
                    path("cfc12.csv"), "-N2-N2", path("cia_n2n2.csv"),
                    "-O2-N2", path("cia_o2n2.csv"), "-integrated", "-o", out]
    atms, steps = [], []
    load = rfmip.load_atmosphere

    def keep_atm(*a, **k):
        atms.append(load(*a, **k))
        return atms[-1]

    rfmip.load_atmosphere = keep_atm
    try:
        wall, parse_s, parses, launches, plain, peak, app_res = _run_app(
            rfmip.main, argv, dev,
            (circ, "build_driver", lambda b: _timed_build(b, steps)))
    finally:
        rfmip.load_atmosphere = load
    check(plain == 0, "the plain version ran in the RFMIP-IRF app")
    (step_s, driver, res, (ra, rk)), = steps
    check(not driver._step_cache.entries, "the app's one run captured")
    atm = atms[0]
    rows = atm.batch * atm.num_layers
    check(rows == 6000, f"{rows} rows, expected 100 sites x 60 layers")
    # The recipe's zenith angles put every fifth site at 95 degrees: 80
    # lit sites round up to the whole batch's bucket, so (as in JAX) the
    # whole batch runs LW and SW with the day mask, not day compaction
    # (the lit sites' LW and SW, the night sites' LW alone).
    lit_sites = np.flatnonzero(np.asarray(atm.cos_zenith) > 0)
    night_sites = atm.batch - lit_sites.size
    compacted = 0 < night_sites and \
        bucket_pad(lit_sites, atm.batch).size < atm.batch
    mols = (len(driver.lw_gas.molecules), len(driver.sw_gas.molecules))
    want = mols[0] + mols[1] + (mols[0] if compacted else 0)
    check(mols == (7, 7) and launches == want,
          f"{launches} K1 launches in the RFMIP-IRF app, expected {want} "
          f"({mols} molecules, {night_sites} sites at night)")
    tiers = res.host()["csaf"]
    with ncio.Dataset(out) as nc:
        checked = 0
        for name, key in (("rlucsaf", "rlu"), ("rldcsaf", "rld"),
                          ("rsucsaf", "rsu"), ("rsdcsaf", "rsd")):
            got = nc.var(name, dtype=None)
            want = np.asarray(tiers[key], np.float32)
            check(got.dtype == np.float32 and np.array_equal(got, want),
                  f"RFMIP-IRF {name} read back unlike the run's fluxes")
            checked += 1
        for name, key, lev, _ in rfmip._REF_VARS:
            got = nc.var(name, dtype=None)
            want = np.asarray(tiers[key], np.float32)[:, lev]
            check(np.array_equal(got, want), f"RFMIP-IRF {name} read back "
                  "unlike the run's fluxes")
            checked += 1
        check(np.array_equal(nc.var("level_pressure", dtype=None),
                             np.asarray(atm.level_pressure, np.float32)),
              "RFMIP-IRF level_pressure read back unlike the input's")
        check(nc.attr("rlucsaf", "units") == "W m-2"
              and nc.dim_size("column") == 100, "RFMIP-IRF file metadata")
    for key, v in tiers.items():
        check(np.isfinite(v).all() and (v >= 0).all(),
              f"RFMIP-IRF {key}: not finite or negative")
    # The step's graph: the app's run was the eager warm-up of its key; a
    # second run captures and replays, a third replays.  Each equals the
    # app's fluxes, and the process reserves at most 1.15x what the app
    # reserved.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    graph_runs = []
    for _ in range(2):
        before = vk.accumulate_voigt.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = driver.run(*ra, **rk)
        torch.cuda.synchronize()
        graph_runs.append(time.perf_counter() - t0)
        got = again.host()["csaf"]
        check(vk.accumulate_voigt.launches - before == launches,
              f"RFMIP-IRF graph run: {vk.accumulate_voigt.launches - before}"
              f" K1 launches, the app's step {launches}")
        for key, v in tiers.items():
            check(np.array_equal(got[key], v), f"RFMIP-IRF graph run: {key} "
                  "differs from the app's eager step")
        del again, got
    graph_res = torch.cuda.max_memory_reserved()
    graph_peak = torch.cuda.max_memory_allocated()
    n_graphs = len(driver._step_cache.entries)
    capture_s = sum(e.capture_s for e in driver._step_cache.entries.values())
    check(n_graphs > 0, "RFMIP-IRF: no graph captured at the second run")
    check(graph_res <= 1.15 * app_res, f"RFMIP-IRF: the graph runs reserve "
          f"{graph_res / 2 ** 30:.2f} GiB, the app {app_res / 2 ** 30:.2f}")
    # K1 against the plain version on one LW launch at the app's rows,
    # with the driver's graph (the step's whole working set) freed first.
    driver.clear_cache()
    part = {"p_lev": atm.level_pressure, "t_lev": atm.level_temperature,
            "vmr": dict(atm.ppmv)}
    k1 = full_rows_vs_plain(driver.lw_gas, int(MoleculeId.O2), part, dev,
                            kernel_reps=3, plain_reps=1)
    check(k1["rows"] == 6000, f"K1 vs plain on {k1['rows']} rows")
    rfmip_run = dict(wall_s=wall, parse_s=parse_s, parses=parses,
                     step_s=step_s, peak_bytes=peak, launches=launches,
                     reserved_bytes=app_res, rows=rows,
                     graph=dict(capture_run_s=graph_runs[0],
                                replay_s=graph_runs[1], graphs=n_graphs,
                                capture_s=capture_s, reserved_bytes=graph_res,
                                peak_bytes=graph_peak),
                     night_sites=night_sites,
                     input_write_s=rfmip_write_s,
                     variables_checked=checked, nw=[driver.lw_gas.grid.n,
                                                    driver.sw_gas.grid.n])
    del driver, res, tiers, steps[:]

    # (c) ERA5 with clouds: 128 columns, -sw, Pade tables from files.
    era5_nc, ghg_nc = path("era5.nc"), path("ghg.nc")
    liquid, ice = path("liquid_pade.nc"), path("ice_pade.nc")
    t0 = time.perf_counter()
    examples.write_era5_inputs(era5_nc, ghg_nc)
    synthetic_pade_table(nbnd=16, w0=1.0, wn=50000.0, seed=0,
                         device="cpu").to_netcdf(liquid)
    examples.ice_pade_table(device="cpu").to_netcdf(ice)
    era5_write_s = time.perf_counter() - t0
    out = path("era5_fluxes.nc")
    argv = [path("hitran.par"), path("solar.csv"), era5_nc, ghg_nc,
            "-year", "1"] + tables + ["-sw", "-integrated", "-liquid-path",
                                      liquid, "-ice-path", ice, "-o", out]
    wall5, parse5, parses5, launches5, plain5, peak5, _ = _run_app(
        era5.main, argv, dev,
        (era5, "build_driver", lambda b: _timed_build(b, steps)))
    check(plain5 == 0, "the plain version ran in the ERA5 app")
    check(launches5 > 0, "K1 never launched in the ERA5 app")
    (step5, driver, res, _), = steps
    check(sorted(res.tiers) == ["af", "csaf"],
          f"ERA5 tiers {sorted(res.tiers)}, expected af and csaf")
    rows5 = res.tiers["csaf"]["rlu"].shape[0] * driver_layers(era5_nc)
    written, defined = [], []
    with ncio.Dataset(out) as nc:
        for name in nc.names():
            if name in ("time", "lat", "lon", "level", "layer",
                        "lw_wavenumber", "sw_wavenumber"):
                continue
            v = nc.var(name, dtype=None)
            if nc.allocated(name):
                check(np.isfinite(v).all(), f"ERA5 {name}: not finite")
                written.append(name)
            else:
                check((v == ncio.Writer.FILL_VALUE).all(),
                      f"ERA5 {name}: unwritten but not the fill value")
                defined.append(name)
        rsdt = nc.var("rsdtcsaf")
        night = int((rsdt == 0.0).sum())
        check(0 < night < rsdt.size, f"{night} of {rsdt.size} ERA5 columns "
              "at night: expected some, not all")
        # The clouds' effect: surface SW of the lit columns, and the OLR.
        day = rsdt > 0
        sw_effect = float(np.abs(nc.var("rsdsaf") - nc.var("rsdscsaf"))
                          [day].max())
        lw_effect = float(np.abs(nc.var("rlutaf") - nc.var("rlutcsaf"))
                          .max())
        check(sw_effect > 1.0, f"ERA5 clouds change the lit surface SW by "
              f"at most {sw_effect:.3g} W m-2")
    check(len(defined) > 0 and "rlutaf" in written,
          f"ERA5 written {written}, defined only {defined}")
    era5_run = dict(wall_s=wall5, parse_s=parse5, parses=parses5,
                    step_s=step5, peak_bytes=peak5, launches=launches5,
                    rows=rows5, input_write_s=era5_write_s,
                    written=written, defined_only=defined,
                    night_columns=night, cloud_sw_effect=sw_effect,
                    cloud_lw_effect=lw_effect)
    del driver, res, steps[:]
    phase_s = time.perf_counter() - t_phase
    info["phase14"] = dict(card=card, fixtures=fixtures, rfmip=rfmip_run,
                           era5=era5_run, k1_vs_plain=k1, phase_s=phase_s)
    gib = 2 ** 30
    print(f"phase 14 apps with the port's netCDF IO ({card}): {fixtures} "
          f"fixture datasets read bit for bit; RFMIP-IRF experiment 0, 100 "
          f"sites x 61 levels ({rows} rows), LW {rfmip_run['nw'][0]} + SW "
          f"{rfmip_run['nw'][1]} points: rfmip.main {wall:.2f} s wall, "
          f"of it {parses} .par parses {parse_s:.2f} s and the step "
          f"{step_s:.3f} s (eager: the key's first call), peak "
          f"{peak / gib:.2f} GiB, reserved {app_res / gib:.2f} GiB; its "
          f"graph: a second run captures {n_graphs} in {capture_s:.2f} s "
          f"({graph_runs[0]:.3f} s), a third replays ({graph_runs[1]:.3f} "
          f"s), both equal to the app's fluxes, peak {graph_peak / gib:.2f}"
          f" GiB, reserved {graph_res / gib:.2f} GiB "
          f"({graph_res / app_res:.3f}x the app's); {launches} K1 "
          f"launches ({night_sites} sites at night), none plain, "
          f"{checked} variables read back equal to "
          f"the run's fluxes; K1 vs plain at {k1['rows']} rows: "
          f"{k1['summary']}; ERA5 with clouds, {rows5} rows "
          f"({night} of 128 columns at night): era5.main {wall5:.2f} s "
          f"wall, {parses5} parses {parse5:.2f} s, step {step5:.3f} s, "
          f"peak {peak5 / gib:.2f} GiB, {launches5} K1 launches, none "
          f"plain, {len(written)} variables written and finite, "
          f"{len(defined)} only defined (fill value, no storage); clouds "
          f"change the lit surface SW by up to {sw_effect:.1f} and the OLR "
          f"by up to {lw_effect:.2f} W m-2",
          flush=True)
    print(f"phase 14 wall time {phase_s:.1f} s (inputs written "
          f"{rfmip_write_s + era5_write_s:.2f} s)", flush=True)
    return launches + launches5, k1["max_abs_err"]


def phase_x64(info, dev, card):
    """Phase 15: the float64 solver check (x64_validate) on the card."""
    import contextlib
    import io
    from grtcode_tpu_torch import x64_validate

    t_phase = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = x64_validate.main(["--device", str(dev)])
    lines = out.getvalue().strip().splitlines()
    check(rc == 0 and lines[-1].startswith("X64 OK"),
          "x64_validate on the card: " + "; ".join(lines))
    rels = [float(ln.split("max rel ")[1].split()[0]) for ln in lines[:-1]]
    check(len(rels) == 20 and max(rels) <= 10 * x64_validate.RTOL,
          f"x64_validate: {len(rels)} comparisons, worst {max(rels):.2e}")
    phase_s = time.perf_counter() - t_phase
    info["phase15"] = dict(card=card, x64=lines, phase_s=phase_s)
    print(f"phase 15 x64_validate ({card}): 20 comparisons, worst "
          f"{max(rels):.2e} <= {10 * x64_validate.RTOL:.0e}; phase "
          f"{phase_s:.1f} s", flush=True)


def phase_scatter(info, dev, card, columns=SCATTER_COLUMNS):
    """Phase 16: GasOptics(method="scatter"), the JAX package's line_sample
    sum with no tables and no near-core split, on the card.

    (a) Each band of the full-width model (examples.rfmip_like: LW 7
    molecules, 366,000 lines on 32,491 points at 0.1; SW 4, 64,000 on
    50,000 at 1.0) on ``columns`` x 54 rows: the band's tau by a scatter
    GasOptics built from the same catalogs and by K1 (line_sample, 11
    launches), each timed, with scatter's lines per step and peak memory,
    and K1's distance from it.  Then each molecule's line sum alone, by K1,
    by scatter in f32 (JAX's order) and by scatter summed in float64.  At
    thousands of lines a point an f32 sum in any order rounds away wing
    terms below half an ulp of its partial sum, so K1 is held within
    TOL_KERNEL of the float64 sum beyond the f32 scatter's own distance
    from it.  (b) A column at T + 300 K and p x 2: line_sample refuses it,
    naming method="scatter"; on its bottom rows each molecule's scatter
    sum, from the same inputs and summed in float64, on the card within
    TOL_KERNEL of the CPU's, and the lines-only band by scatter GasOptics
    on both.  (c) A RadiationDriver step with both bands on scatter at
    smoke size, card against CPU at TOL_GOLDEN.  Returns (K1 launches, K1's
    worst error against the float64 sums, its worst share of the bar,
    the band taus' worst share against the f32 scatter)."""
    import dataclasses
    import torch
    from grtcode_tpu_torch import examples
    from grtcode_tpu_torch.framework.driver import RadiationDriver
    from grtcode_tpu_torch.gas_optics import optical_depth as od
    from grtcode_tpu_torch.gas_optics import voigt_kernel as vk
    from grtcode_tpu_torch.gas_optics.lines import PreparedLines

    f32, f64, cpu = torch.float32, torch.float64, torch.device("cpu")
    t_phase = time.perf_counter()
    lw_gas, sw_gas, solar, batch, B, nlayers = examples.rfmip_like(
        device=dev)
    bands = {"LW": lw_gas, "SW": sw_gas}

    def first(n):
        """The batch's first ``n`` columns."""
        return {k: ({m: a[:n] for m, a in v.items()} if isinstance(v, dict)
                    else v[:n]) for k, v in batch.items()}

    cols = first(columns)
    rows = columns * nlayers

    def gas_args(gas, b, d):
        def t32(a):
            return torch.as_tensor(a, dtype=f32, device=d)
        return ((t32(b["p_lev"]), t32(b["t_lev"]),
                 {m: t32(b["vmr"][m]) * 1e-6 for m in gas.molecules}),
                dict(cfc_vmr={k: t32(v) * 1e-6
                              for k, v in b["cfc_vmr"].items()},
                     cia_vmr={k: t32(v) * 1e-6
                              for k, v in b["cia_vmr"].items()}))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def scatter_sum(gas, prep, ns, dtype):
        tau = torch.zeros((ns.shape[0], gas.grid.n), dtype=dtype,
                          device=ns.device)
        return od.optical_depth_line_sample(prep, ns, gas.grid,
                                            cutoff=gas.wcutoff,
                                            chunk=gas.line_chunk, tau0=tau)

    # (a) The main path, with every launch count starting at 0.
    vk.accumulate_voigt.launches = 0
    vk.voigt_line_sample_reference.launches = 0
    runs = {}
    for label, gas in bands.items():
        scatter = dataclasses.replace(gas, method="scatter")
        args, kw = gas_args(gas, cols, dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        tau_sc, sc_s = timed(lambda: scatter.optical_depth(*args, **kw))
        peak = torch.cuda.max_memory_allocated() - held
        before = vk.accumulate_voigt.launches
        tau_k1, k1_s = timed(lambda: gas.optical_depth(*args, **kw))
        launches = vk.accumulate_voigt.launches - before
        check(launches == len(gas.molecules), f"{label}: {launches} K1 "
              f"launches, expected {len(gas.molecules)}")
        check(tuple(tau_sc.shape) == (columns, nlayers, gas.grid.n),
              f"{label}: scatter tau shape {tuple(tau_sc.shape)}")
        check(bool(torch.isfinite(tau_sc).all()), f"{label}: scatter tau "
              "not finite")
        check(float(tau_sc.min()) >= 0 and float(tau_sc.max()) > 0,
              f"{label}: scatter tau not positive")
        err, share, where = share_of_bound(tau_k1, tau_sc, **TOL_KERNEL)
        n_lines = sum(g.num_lines for g in gas.molecules.values())
        runs[label] = dict(
            rows=rows, padded_lines=n_lines, nw=gas.grid.n,
            fsteps=gas._fsteps, line_chunk=gas.line_chunk,
            lines_per_step=od.lines_per_step(rows, gas._fsteps,
                                             gas.line_chunk),
            samples=rows * n_lines * (2 * gas._fsteps + 1),
            scatter_s=sc_s, k1_s=k1_s, scatter_peak_bytes=peak,
            k1_launches=launches, band_vs_f32_max_abs_err=err,
            band_vs_f32_share=share, band_vs_f32_where=where)
        del tau_sc, tau_k1, scatter
    k1_launches = vk.accumulate_voigt.launches

    # Each molecule's line sum alone, each into its own zeroed buffer.
    worst_err = worst_share = 0.0
    for label, gas in bands.items():
        mols = {}
        for mol in gas.molecules:
            prep, ns, kw = band_prep(gas, mol, cols, dev)
            k1 = vk.accumulate_voigt(
                prep, ns, gas.chunk_ranges[mol], tau0=torch.zeros(
                    (rows, gas.grid.n), dtype=f32, device=dev), **kw)
            s32 = scatter_sum(gas, prep, ns, f32)
            s64 = scatter_sum(gas, prep, ns, f64)
            del prep
            err, share, where = share_of_bound(k1, s64, **TOL_KERNEL)
            _, own, _ = share_of_bound(s32, s64, **TOL_KERNEL)
            _, k1_f32, _ = share_of_bound(k1, s32, **TOL_KERNEL)
            check(share <= 1.0 + own, f"{label} molecule {mol}: K1 is "
                  f"{share:.3f} of the rtol 2e-6 / atol 1e-12 bar from the "
                  f"float64 scatter sum (max abs err {err:.3e} {where}); "
                  f"the f32 scatter is {own:.3f}")
            mols[mol] = dict(k1_vs_f64=share, k1_max_abs_err=err,
                             f32_scatter_vs_f64=own, k1_vs_f32=k1_f32)
            worst_err, worst_share = max(worst_err, err), max(worst_share,
                                                              share)
            del k1, s32, s64
        runs[label]["molecules"] = mols
    torch.cuda.empty_cache()

    # (b) Beyond the line_sample tables' limits.
    one = first(1)
    hot_col = dict(one, p_lev=one["p_lev"] * HOT_P,
                   t_lev=one["t_lev"] + HOT_DT)
    hot = {}
    for label, gas in bands.items():
        args, kw = gas_args(gas, hot_col, dev)
        try:
            gas.optical_depth(*args, **kw)
            refused = None
        except ValueError as e:
            refused = str(e)
        check(refused is not None and 'method="scatter"' in refused,
              f"{label}: line_sample on the hot column: {refused!r}")
        n = HOT_ROWS[label] + 1
        bottom = {k: ({m: a[:, -n:] for m, a in v.items()}
                      if isinstance(v, dict) else v[:, -n:])
                  for k, v in hot_col.items() if k not in ("mu", "tsi")}
        # The lines-only band in f32, each device in its own order.
        band, secs = [], []
        for d in (dev, cpu):
            lines_only = dataclasses.replace(
                gas, method="scatter", device=d, h2o_ctm=None, o3_ctm=None,
                cfcs={}, cias=[])
            t0 = time.perf_counter()
            band.append(lines_only.optical_depth(*gas_args(gas, bottom,
                                                           d)[0]).cpu())
            secs.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(band[0]).all())
              and float(band[1].max()) > 0,
              f"{label}: hot scatter not finite or all zero")
        _, band_share, _ = share_of_bound(band[0], band[1], **TOL_KERNEL)
        # Each molecule from the same inputs (prepared on the CPU), summed
        # in float64 on both.
        mol_share = mol_err = 0.0
        for mol in gas.molecules:
            prep, ns, _ = band_prep(gas, mol, bottom, cpu)
            sums = [scatter_sum(gas, PreparedLines(
                *(t.to(d) for t in dataclasses.astuple(prep))), ns.to(d),
                f64).cpu() for d in (dev, cpu)]
            err, share, where = share_of_bound(*sums, **TOL_KERNEL)
            check(share <= 1.0, f"{label} molecule {mol}, hot rows: "
                  f"scatter on the card vs the CPU exceeds rtol 2e-6 / "
                  f"atol 1e-12 (max abs err {err:.3e}, {share:.3f} of the "
                  f"bound {where})")
            mol_share, mol_err = max(mol_share, share), max(mol_err, err)
        hot[label] = dict(rows=HOT_ROWS[label], f64_worst_share=mol_share,
                          f64_max_abs_err=mol_err, f32_band_share=band_share,
                          card_s=secs[0], cpu_s=secs[1],
                          tau_max=float(band[1].max()))
    del lw_gas, sw_gas, solar, batch, bands
    torch.cuda.empty_cache()

    # (c) The driver with both bands on scatter, card against CPU.
    before = vk.accumulate_voigt.launches
    outs = []
    for d in (dev, cpu):
        lw, sw, sol, b, _, _ = examples.rfmip_like(smoke=True, device=d)
        driver = RadiationDriver(dataclasses.replace(lw, method="scatter"),
                                 dataclasses.replace(sw, method="scatter"),
                                 sol)
        res = driver.run(examples.atmosphere(b), integrated=True)
        outs.append({k: v.cpu().numpy() for k, v in res.tiers["csaf"].items()})
    check(vk.accumulate_voigt.launches == before,
          "K1 launched in the scatter driver step")
    driver_err = {}
    for var in ("rlu", "rld", "rsu", "rsd"):
        got, want = outs[0][var], outs[1][var]
        check(np.isfinite(got).all(), f"scatter driver {var}: not finite")
        driver_err[var] = worst_rel(got, want)
        check(driver_err[var] <= TOL_GOLDEN, f"scatter driver {var}: card "
              f"vs CPU {driver_err[var]:.2e} > {TOL_GOLDEN}")
    plain = vk.voigt_line_sample_reference.launches
    check(plain == 0, f"K1's plain version ran {plain} times in phase 16")
    phase_s = time.perf_counter() - t_phase

    band_share = max(r["band_vs_f32_share"] for r in runs.values())
    info["phase16"] = dict(card=card, columns=columns, bands=runs, hot=hot,
                           driver_vs_cpu=driver_err,
                           k1_launches=k1_launches, phase_s=phase_s)
    parts = []
    for k, r in runs.items():
        m = r["molecules"].values()
        parts.append(
            f"{k} {r['rows']} rows x {r['padded_lines']} padded lines x "
            f"{r['nw']} points ({r['samples']:.3e} samples): scatter "
            f"{r['scatter_s']:.2f} s (line chunk {r['line_chunk']}, "
            f"{r['lines_per_step']} lines per step, peak "
            f"{r['scatter_peak_bytes'] / 2 ** 30:.2f} GiB) vs K1 "
            f"{r['k1_s']:.3f} s ({r['k1_launches']} launches); band tau, K1 "
            f"vs f32 scatter {r['band_vs_f32_share']:.3f} of the bar "
            f"({r['band_vs_f32_where']}); per molecule against the float64 "
            f"sum: K1 at most {max(v['k1_vs_f64'] for v in m):.3f}, the f32 "
            f"scatter {max(v['f32_scatter_vs_f64'] for v in m):.3f}, K1 vs "
            f"f32 scatter {max(v['k1_vs_f32'] for v in m):.3f}")
    parts += [f"hot {k} ({h['rows']} rows, tau max {h['tau_max']:.3e}) card "
              f"vs CPU: float64 sums {h['f64_worst_share']:.3f} of the bar, "
              f"f32 band {h['f32_band_share']:.3f} (card {h['card_s']:.2f} "
              f"s, CPU {h['cpu_s']:.2f} s)" for k, h in hot.items()]
    print(f"phase 16 scatter ({card}), {columns} of 32 columns: "
          + "; ".join(parts) + "; line_sample refuses the hot column, "
          "naming method=\"scatter\"; scatter driver step card vs CPU "
          "worst rel " + ", ".join(f"{k} {v:.2e}"
                                   for k, v in driver_err.items())
          + f" <= {TOL_GOLDEN}; phase {phase_s:.1f} s", flush=True)
    return k1_launches, worst_err, worst_share, band_share


def driver_layers(era5_path):
    """Layers of an ERA5 file's columns (its levels less one)."""
    from grtcode_tpu_torch.utils import ncio

    with ncio.Dataset(era5_path) as nc:
        return nc.shape("p")[1] - 1


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke run needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import grtcode_tpu_torch  # noqa: F401  (fails outside the repo)

    info = {}
    t0 = time.perf_counter()
    phase_card(info)
    phase_build(info)
    err3 = phase_kernel_vs_plain(info, dev)
    phase_golden(info, dev)
    k1_launches, err5, o2 = phase_full_width(info, dev, info["card"])
    torch.cuda.empty_cache()
    err6 = phase_bin_kernel_vs_plain(info, dev)
    phase_bins_golden(info, dev)
    launches8, o2_bins = phase_streamed_bins(info, dev, info["card"])
    torch.cuda.empty_cache()
    launches9 = phase_allsky(info, dev, info["card"])
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as app_dir:
        launches10, err10, k3 = phase_circ_app(info, dev, info["card"],
                                               app_dir)
        torch.cuda.empty_cache()
        cell, launches11 = phase_mesh(info, dev, info["card"])
        launches12 = phase_aux(info, dev, info["card"], cell)
        launches13 = phase_library(info, dev, info["card"], cell)
        del cell
        torch.cuda.empty_cache()
        launches14, err14 = phase_apps_io(info, dev, info["card"], app_dir)
    torch.cuda.empty_cache()
    phase_x64(info, dev, info["card"])
    torch.cuda.empty_cache()
    launches16, err16, share16, band16 = phase_scatter(info, dev,
                                                       info["card"])
    phase_graphs(info, info["card"])
    check("jax" not in sys.modules, "JAX was imported")
    check("h5py" not in sys.modules, "h5py was imported")
    info["seconds"] = time.perf_counter() - t0

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(info, f, indent=1, default=str)
    # K1 runs on every path (all 11 molecules at 0.1, the 4 SW molecules
    # in each block of the streamed one, 18 per all-sky step, 14 per CIRC
    # run, 11 per rank on a mesh, the segments', phase 12's and phase 13's
    # steps, phase 14's RFMIP-IRF and ERA5 apps, phase 16's bands beside
    # scatter); its launches are the nine counts.
    # Its scatter_* keys (phase 16): its worst against the float64 scatter
    # sum by molecule (error, share of the bar) and, the band's tau, against
    # the f32 scatter GasOptics.  K2 runs on phase 8's streamed
    # steps.
    # No PyTorch call computes a Voigt sum over a line list: library_ms is
    # null for both.  K3 runs in phase 10 only (the CIRC DISORT steps, their
    # captured replays and profile, the analytic cases, card against CPU,
    # the 32-column block and (e)): its launches are its dispatcher's count
    # since (c); ms, plain_ms and the bound are (e)'s CIRC block, 1 x 54 x
    # 2,048; no library call runs DISORT's doubling: library_ms null.
    from grtcode_tpu_torch.solvers import disort
    k3_cell = k3["blocks"]["1x54x2048"]
    print(json.dumps({"kernels": [
        {"name": "voigt_line_sample", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES,
         "launches": k1_launches + launches8["voigt_line_sample"]
         + launches9 + launches10 + launches11 + launches12 + launches13
         + launches14 + launches16,
         "max_abs_err": max(err3, err5, err10, err14), "ms": o2["ms"],
         "plain_ms": o2["plain_ms_mean"], "bound_ms": o2["bound_ms"],
         "bound_by": o2["bound_by"], "library_ms": None,
         "scatter_max_abs_err": err16, "scatter_worst_share": share16,
         "scatter_f32_band_share": band16},
        {"name": "voigt_bins", "route": "cuda", "source": SOURCE_K2,
         "replaces": REPLACES_K2,
         "launches": launches8["voigt_bins"],
         "max_abs_err": max(err6, o2_bins["max_abs_err"]),
         "ms": o2_bins["ms"], "plain_ms": o2_bins["plain_ms_mean"],
         "bound_ms": o2_bins["bound_ms"], "bound_by": o2_bins["bound_by"],
         "library_ms": None},
        {"name": "disort_doubling", "route": "cuda", "source": SOURCE_K3,
         "replaces": None, "launches": disort.layer_operators.launches,
         "max_abs_err": k3["max_abs_err"],
         "max_rel_err": k3["max_rel_err"], "ms": k3_cell["ms"],
         "plain_ms": k3_cell["plain_ms"], "bound_ms": k3_cell["bound_ms"],
         "bound_by": k3_cell["bound_by"], "library_ms": None,
         "blocks": k3["blocks"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
