"""The device memory of one ``RadiationDriver`` step at full width on the
card: eager against the captured step, under the allocator setting given.

    python -m grtcode_tpu_torch.memory_probe [--batch B] [--expandable]

Builds ``examples.rfmip_like`` at full width with ``B`` columns (default
32) and runs, each from an emptied allocator cache with its peaks reset:
the step under :func:`.utils.debug.disable_jit`, then the step three times
through the driver's step cache (the eager warm-up, the capture and its
replay, a replay).  Prints one JSON line: for each, the bytes reserved at
the peak (``torch.cuda.max_memory_reserved``), allocated at the peak and
held after, in GiB, and the step's seconds; whether the replay equals the
eager step bit for bit.  ``--expandable`` turns on the allocator's
expandable segments before the first allocation; without it the process
starts with the allocator as the environment sets it, and the first
capture turns them on (:mod:`.utils.graphs`).  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

GIB = 2 ** 30


def _mark():
    """Empty the allocator's cache and reset its peaks: (bytes reserved,
    allocated) now."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_reserved(), torch.cuda.memory_allocated()


def _read(base):
    """The peaks and the hold since ``base`` (from :func:`_mark`), GiB."""
    res0, alloc0 = base
    return dict(reserved_gib=(torch.cuda.max_memory_reserved() - res0) / GIB,
                allocated_gib=(torch.cuda.max_memory_allocated() - alloc0)
                / GIB,
                held_gib=(torch.cuda.memory_reserved() - res0) / GIB)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--expandable", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("memory_probe: needs a CUDA device")
    if args.expandable:
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    from . import examples
    from .framework.driver import RadiationDriver
    from .utils import debug

    dev = torch.device("cuda", torch.cuda.current_device())
    lw, sw, solar, batch, _, _ = examples.rfmip_like(batch_size=args.batch,
                                                     device=dev)
    driver = RadiationDriver(lw, sw, solar)
    atm = examples.atmosphere(batch)
    out = dict(batch=args.batch, expandable=args.expandable,
               card=torch.cuda.get_device_name(dev))

    base = _mark()
    t0 = time.perf_counter()
    with debug.disable_jit():
        eager = driver.run(atm, integrated=True).tiers["csaf"]
    torch.cuda.synchronize()
    out["eager"] = dict(_read(base), s=time.perf_counter() - t0)

    base = _mark()
    steps = []
    for _ in range(3):                 # warm-up, capture and replay, replay
        t0 = time.perf_counter()
        got = driver.run(atm, integrated=True).tiers["csaf"]
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    out["graph"] = dict(_read(base), s=steps,
                        graphs=len(driver._step_cache.entries),
                        bit_identical=all(torch.equal(got[k], eager[k])
                                          for k in eager))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
