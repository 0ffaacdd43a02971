"""The readings that a cell's output limits are set from, in one process.

    python3 -m rtbench.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--calls N] [--smoke]

For each of ``--seeds``: the program's warm-up and ``--calls`` calls of
the cell's traffic, then the gaps of the columns a run would check
against the float64 reference (the lower readings).  For each of
``--control-seeds``: the control, the same reference computed in
bfloat16 (the nearest precision below the configuration's float32) on
the columns a run would check, against the float64 reference (the upper
readings).  One JSON line per seed on stdout, and a summary (largest
program gap and smallest control gap per number) in
``chiprun_out/calibrate_<cell>.json``.  The benchmark's own runs never
run the control.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import torch

from . import check, deployment, traffic
from .reference import rt
from .run import ROOT, Window, note
from .spec import Spec


def _columns(dep, calls, count, seed):
    return [(i, j, dep.column(calls[i].expts[j], calls[i].sites[j],
                              calls[i].mu[j]))
            for i, j in traffic.checked(calls, count, seed)]


def program_gaps(cfg, mix, seed, n_calls, device) -> dict:
    from . import program

    dep = deployment.build(cfg, seed, smoke=device.type == "cpu")
    S = int(mix["spectral_chunks"])
    driver = program.build_driver(dep, device)
    call_list = traffic.calls(mix, dep, seed)
    atms = [program.atmosphere(dep.columns(c.expts, c.sites, c.mu))
            for c in call_list]
    index = {id(c): i for i, c in enumerate(call_list)}
    for c in traffic.warmup(call_list):
        program.call(driver, atms[index[id(c)]], S)
    w = Window()
    for i in range(n_calls):
        k = i % len(call_list)
        w.calls.append(call_list[k])
        w.outputs.append(program.call(driver, atms[k], S))
    del driver, atms
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    tips = rt.PartitionSums()
    pairs = [({k: v[j] for k, v in w.outputs[i].items()},
              rt.column_fluxes(dep, col, device=device, tips=tips))
             for i, j, col in _columns(dep, w.calls, mix["checked_columns"],
                                       seed)]
    return check.gaps(pairs)


def control_gaps(cfg, mix, seed, n_calls, device,
                 dtype=torch.bfloat16) -> dict:
    dep = deployment.build(cfg, seed, smoke=device.type == "cpu")
    call_list = traffic.calls(mix, dep, seed)
    calls = [call_list[i % len(call_list)] for i in range(n_calls)]
    tips = rt.PartitionSums()
    pairs = [(rt.column_fluxes(dep, col, dtype=dtype, device=device,
                               tips=tips),
              rt.column_fluxes(dep, col, device=device, tips=tips))
             for _, _, col in _columns(dep, calls, mix["checked_columns"],
                                       seed)]
    return check.gaps(pairs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--calls", type=int, default=4)
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    spec = Spec()
    cell = spec.workload(args.workload)
    cfg, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    device = torch.device("cpu" if args.smoke else "cuda:0")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    out = {"workload": args.workload, "calls": args.calls, "program": {},
           "control": {}}
    for kind, seed_list, fn in (
            ("program", seeds, lambda s: program_gaps(
                cfg, mix, s, args.calls, device)),
            ("control", controls, lambda s: control_gaps(
                cfg, mix, s, args.calls, device))):
        for s in seed_list:
            t = time.perf_counter()
            try:
                g = fn(s)
            except Exception as err:      # a control that crashes has failed
                print(f"{kind} seed {s}: {type(err).__name__}: {err}",
                      file=sys.stderr)
                g = {f"{k}_gap": float("nan") for k in check.FLUXES}
            out[kind][s] = g
            note(f"{kind} seed {s}: {time.perf_counter() - t:.1f} s")
            print(json.dumps({"kind": kind, "seed": s, **g}), flush=True)
    names = [f"{k}_gap" for k in check.FLUXES]
    summary = {}
    for n in names:
        low = [g[n] for g in out["program"].values() if n in g]
        up = [g[n] for g in out["control"].values() if n in g]
        summary[n] = {"lower": max(low) if low else None,
                      "upper": min(up) if up else None}
    out["summary"] = summary
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"calibrate_{args.workload}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
