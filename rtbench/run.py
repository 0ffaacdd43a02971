"""Run one cell of the port's benchmark once.

    python3 -m rtbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--smoke]

1. Find the configuration's shortwave reference (a missing one stops the
   run here).  Build the cell's deployment from the seed (line catalogs,
   tables, and the layout's profiles and surface spectra) and the
   program's ``RadiationDriver`` on ``cuda:0``; make the ``Atmosphere``
   of every call the traffic mix draws.
2. Warm up the cell's own keys: two calls for each number of lit
   columns the traffic holds (each key runs eagerly once, then is
   captured).  Everything up to the first timed call is ``setup_s``.
3. Time whole calls, ``RadiationDriver.run(atm, spectral_chunks=S)``
   and ``FluxResults.host()``, one after another for ``--seconds``
   (closed loop; the last call started in the window runs to its end).
   With ``--trace 1`` the window runs under ``torch.profiler``, the
   host-sync counter and the program's layer timing, and the per-layer
   metrics are read from them, from the program's spans and from its
   step-cache counts before and after the window.
4. Free the program, then check a sample of the computed columns drawn
   from the seed against the plain reference (``rtbench.check``).
5. Print one JSON line: ``correct``, ``attempted``, ``failed``,
   ``metrics``, ``device``, ``breakdown`` (traced), ``check``.

Without a CUDA device it exits 2 and prints no result.  ``--smoke`` runs
the whole command on the CPU at the configuration's smoke cuts, with the
port's plain kernels, and marks every metric "not measured": it is the
rehearsal before a chip run, not a measurement.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Kernel caches at fixed paths inside the checkout, so that only a cell's
# first run there builds and compiles.
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "rtbench",
                                              "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "rtbench",
                                                  "torch_extensions")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import census as census_mod  # noqa: E402
from . import check, deployment, traffic  # noqa: E402
from .reference import rt  # noqa: E402
from .spec import Spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "grtcode_tpu")
CENSUS_COLUMNS = 8      # columns counted at once (~0.5 GB a temporary)
PROGRAM_SPANS = "grtcode::"     # the prefix of the program's spans
NOT_MEASURED = "not measured"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="the CPU rehearsal at the smoke cuts")
    return ap.parse_args(argv)


def note(msg: str) -> None:
    print(f"rtbench: [{time.perf_counter() - T0:7.1f} s] {msg}",
          file=sys.stderr, flush=True)


def fail(code: int, msg: str):
    print(f"rtbench: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card() -> dict:
    """The card's name, count and power limit beside the published
    peaks the roofline shares are taken against."""
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1, "peak_f32_ops": census_mod.PEAK_F32_OPS,
           "peak_bytes_per_s": census_mod.PEAK_BYTES}
    proc = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                           "--format=csv,noheader,nounits", "-i", "0"],
                          capture_output=True, text=True)
    if proc.returncode == 0 and proc.stdout.strip():
        out["power_limit_w"] = float(proc.stdout.split()[0])
    return out


class Window:
    """The timed calls of one run and what they returned."""

    def __init__(self):
        self.calls, self.outputs, self.seconds = [], [], []
        self.failed = 0
        self.start = self.end = None


def run_window(program, driver, atms, call_list, S, seconds, syncs=None):
    """Closed-loop calls through the list (cycling) for ``seconds``."""
    w = Window()
    sync = torch.cuda.synchronize if torch.cuda.is_available() else \
        (lambda: None)
    sync()
    w.start = time.perf_counter()
    k = 0
    while time.perf_counter() - w.start < seconds:
        i = k % len(call_list)
        t = time.perf_counter()
        try:
            with torch.profiler.record_function("rtbench::run"):
                if syncs is not None:
                    with syncs:
                        res = program.run(driver, atms[i], S)
                else:
                    res = program.run(driver, atms[i], S)
            with torch.profiler.record_function("rtbench::host"):
                out = program.host(res)
            finite = all(np.all(np.isfinite(v)) for v in out.values())
        except Exception as err:       # a failed call counts, the run goes on
            print(f"rtbench: call {k} failed: {type(err).__name__}: {err}",
                  file=sys.stderr)
            out, finite = None, False
        w.end = time.perf_counter()
        w.seconds.append(w.end - t)
        w.calls.append(call_list[i])
        w.outputs.append(out)
        w.failed += 0 if finite else 1
        k += 1
    return w


def main(argv=None) -> dict:
    args = parse(argv)
    spec = Spec()
    cell = spec.workload(args.workload)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    limits = spec.limits(args.workload)
    try:
        rt.sw_solver(cfg)
    except ValueError as err:
        fail(2, str(err))
    if args.smoke:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < int(cell["chips"]):
            fail(2, f"{args.workload} needs {cell['chips']} CUDA device(s); "
                    f"found {torch.cuda.device_count()}")
        device = torch.device("cuda:0")
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    try:
        from . import program
    except ImportError as err:
        fail(2, f"the program under test cannot be imported: {err}")

    dep = deployment.build(cfg, args.seed, smoke=args.smoke)
    note("deployment built")
    S = int(mix["spectral_chunks"])
    driver = program.build_driver(dep, device)
    call_list = traffic.calls(mix, dep, args.seed)
    atms = [program.atmosphere(dep.columns(c.expts, c.sites, c.mu))
            for c in call_list]
    index = {id(c): i for i, c in enumerate(call_list)}
    note(f"driver and {len(atms)} atmospheres built")
    for c in traffic.warmup(call_list):
        program.call(driver, atms[index[id(c)]], S)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0
    note(f"warm-up done: setup {setup_s:.2f} s")

    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        from .trace import DeviceTrace, SyncCounter, WINDOW_RANGE
        before = {k: f.launches for k, f in program.LAUNCH_COUNTERS.items()}
        syncs = SyncCounter() if device.type == "cuda" else None
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        stats = program.step_stats(driver)
        with profile(activities=activities) as prof, program.layer_times():
            with torch.profiler.record_function(WINDOW_RANGE):
                w = run_window(program, driver, atms, call_list, S,
                               args.seconds, syncs)
        launches = {k: f.launches - before[k]
                    for k, f in program.LAUNCH_COUNTERS.items()}
        stats = difference(program.step_stats(driver), stats)
    else:
        w = run_window(program, driver, atms, call_list, S, args.seconds)
    peak = torch.cuda.max_memory_allocated(0) if device.type == "cuda" \
        else None
    note(f"window: {len(w.calls)} calls in {w.end - w.start:.2f} s")
    bad = forbidden_modules()
    if bad:
        fail(3, f"modules loaded in the run's process: {', '.join(bad)}")
    del driver, atms
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    result = {"correct": False, "attempted": len(w.calls),
              "failed": w.failed, "metrics": None, "device": None}
    if args.trace:
        trace = DeviceTrace(prof)
        del prof
        note(f"trace read: {len(trace.by_name)} device op names")
        counted = census_mod.Census(dep, device)
        for c in w.calls:
            for a in range(0, c.size, CENSUS_COLUMNS):
                s = slice(a, a + CENSUS_COLUMNS)
                counted.add(dep.columns(c.expts[s], c.sites[s], c.mu[s]))
        record = {
            "calls": len(w.calls), "call_wall_s": float(sum(w.seconds)),
            "window_s": trace.window_s, "busy_s": trace.busy_s,
            "device_ops": dict(trace.by_name) if device.type == "cuda"
            else {}, "syncs": syncs.total if syncs else None,
            "census": counted.kernels(), "launches": launches,
            "launches_agree": launches_agree(launches, dep, S, w.calls,
                                             device),
            "peak_f32_ops": census_mod.PEAK_F32_OPS,
            "layer_ms": {k: v / max(1, len(w.calls))
                         for k, v in stats.pop("layer_ms").items()},
            "layer_untimed": stats["untimed"],
            "host_spans": trace.host_spans(PROGRAM_SPANS),
            "step_stats": stats}
        note("census done")
        for k in ("layer_ms", "layer_untimed", "host_spans", "step_stats"):
            print(f"rtbench: {k} {json.dumps(record[k])}", file=sys.stderr)
        if syncs:
            print(f"rtbench: host syncs by line: {syncs.where.most_common(6)}",
                  file=sys.stderr)
        metrics = {}
        for m in spec.per_layer(args.workload):
            value = spec.reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        done = w.end - w.start
        values = {
            "columns_per_s": sum(c.size for c in w.calls) / done,
            "peak_mem_gib": None if peak is None else peak / 2 ** 30,
            "call_ms_p95": float(np.percentile(np.array(w.seconds) * 1e3,
                                               95)),
            "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end(args.workload)}
    if args.smoke:
        metrics = {k: {"value": NOT_MEASURED, "unit": v["unit"]}
                   for k, v in metrics.items()}
        result["device"] = {"platform": "cpu", "kind": "cpu (smoke run)",
                            "count": 0, "memory_peak_bytes": NOT_MEASURED}
    else:
        result["device"] = dict(card(), memory_peak_bytes=int(peak))
        if args.trace:
            result["device"].update(busy_s=trace.busy_s,
                                    window_s=trace.window_s)
    if args.trace and device.type == "cuda":
        result["breakdown"] = {"device_ops": trace.top_ops(),
                               "idle_gaps": trace.idle_by_host()}
    result["metrics"] = metrics

    numbers = reference_check(dep, w, int(mix["checked_columns"]),
                              args.seed, device)
    correct, table = check.judge(numbers, limits)
    result["correct"] = bool(correct and w.failed == 0 and w.calls)
    result["check"] = table          # last: each number beside its limit
    for name, (value, limit) in table.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return result


def difference(after: dict, before: dict) -> dict:
    """``after`` less ``before``, key by key, nested dicts too (a key
    missing before counts from 0)."""
    return {k: difference(v, before.get(k, {})) if isinstance(v, dict)
            else v - before.get(k, 0) for k, v in after.items()}


def launches_agree(got: dict, dep, S, calls, device):
    """Whether the dispatchers' launches equal the census's one launch per
    band, molecule and spectral block of each call (the shortwave of lit
    calls only), said on stderr.  None where it cannot be told: on the CPU
    (no kernel launches) or where a call was compacted (its two steps
    launch the longwave twice for one call's columns)."""
    if device.type != "cuda" or any(c.compacted for c in calls):
        print("rtbench: launches not compared (compacted calls or no card)",
              file=sys.stderr)
        return None
    expect = {"k1": 0, "k2": 0}
    for c in calls:
        for name, band in dep.bands.items():
            if name == "sw" and c.lit == 0:
                continue
            k = "k2" if band.method == "wavenumber_sweep" else "k1"
            expect[k] += len(band.lines) * S
    same = all(expect[k] == got[k] for k in expect)
    print(f"rtbench: launches census {expect} program {got} "
          f"({'equal' if same else 'differ: roofline shares withheld'})",
          file=sys.stderr)
    return same


def reference_check(dep, w: Window, count: int, seed: int, device) -> dict:
    """The gaps of a sample of the window's columns against the plain
    reference, computed one column at a time after the program is freed."""
    done = [i for i, out in enumerate(w.outputs) if out is not None]
    calls = [w.calls[i] for i in done]
    if not calls:
        return {f"{k}_gap": float("inf") for k in check.FLUXES}
    tips = rt.PartitionSums()
    pairs = []
    t = time.perf_counter()
    for i, j in traffic.checked(calls, count, seed):
        c = calls[i]
        ref = rt.column_fluxes(dep, dep.column(c.expts[j], c.sites[j],
                                               c.mu[j]),
                               device=device, tips=tips)
        prog = {k: v[j] for k, v in w.outputs[done[i]].items()}
        pairs.append((prog, ref))
    print(f"rtbench: reference on {len(pairs)} columns: "
          f"{time.perf_counter() - t:.1f} s", file=sys.stderr)
    return check.gaps(pairs)


if __name__ == "__main__":
    main()
