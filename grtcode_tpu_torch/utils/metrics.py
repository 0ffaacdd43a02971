"""Observability: phase timers, throughput counters, profiler traces (port
of grtcode_tpu/utils/metrics.py).

The reference's only tracing is its kernel-launch logging at INFO
verbosity (utilities/src/debug.h:281-282, 359-360).  Here the grid-points/s
metric is a first-class counter, phases are wall-clock timed after the
result's CUDA device has finished its queued work, and a context manager
wraps ``torch.profiler`` for on-demand traces in Chrome's trace format.

Everything here is host-side and costs nothing when unused.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time

import torch

log = logging.getLogger("grtcode_tpu_torch")


@dataclasses.dataclass
class PhaseStats:
    seconds: float = 0.0
    calls: int = 0
    points: int = 0

    @property
    def points_per_second(self) -> float:
        return self.points / self.seconds if self.seconds > 0 else 0.0


def _synchronize(result) -> None:
    """Wait for every CUDA device that holds a tensor of ``result`` (a
    tensor, or a dict / list / tuple / object with ``tiers`` of them)."""
    devices = set()
    todo = [result]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            todo.extend(x.values())
        elif isinstance(x, (list, tuple)):
            todo.extend(x)
        elif hasattr(x, "tiers"):
            todo.append(x.tiers)
    for d in devices:
        torch.cuda.synchronize(d)


class Metrics:
    """Accumulates named phase timings and grid-point throughput.

    >>> m = Metrics()
    >>> with m.phase("lw_fluxes", points=ncol * nlayers * nw) as box:
    ...     box["result"] = step(batch)   # or sync=the result
    >>> m.report()
    """

    def __init__(self):
        self.phases: dict[str, PhaseStats] = {}

    @contextlib.contextmanager
    def phase(self, name: str, points: int = 0, sync=None):
        """Time a phase; ``points`` adds column*layer*wavenumber work items
        to the throughput counter.  The clock is read after the CUDA
        devices of the phase's result (``box["result"]``, else ``sync``)
        have finished, so device time is included."""
        box = {}
        start = time.perf_counter()
        try:
            yield box
        finally:
            result = box.get("result", sync)
            if result is not None:
                _synchronize(result)
            dt = time.perf_counter() - start
            st = self.phases.setdefault(name, PhaseStats())
            st.seconds += dt
            st.calls += 1
            st.points += int(points)
            log.info("phase %s: %.3fs (%d pts, %.3g pts/s)", name, dt,
                     points, points / dt if dt > 0 else 0.0)

    def points_per_second(self, name: str) -> float:
        return self.phases[name].points_per_second

    def report(self) -> str:
        lines = [f"{'phase':<24}{'calls':>6}{'seconds':>10}{'pts/s':>12}"]
        for name, st in sorted(self.phases.items()):
            lines.append(f"{name:<24}{st.calls:>6}{st.seconds:>10.3f}"
                         f"{st.points_per_second:>12.3g}")
        return "\n".join(lines)


def grid_points(num_columns: int, num_layers: int, num_wavenumbers: int) -> int:
    """The north-star work unit: column x layer x wavenumber points
    (BASELINE.json driver metric)."""
    return int(num_columns) * int(num_layers) * int(num_wavenumbers)


@contextlib.contextmanager
def profiler_trace(logdir: str | None):
    """On-demand ``torch.profiler`` trace of host and CUDA activity,
    written to ``<logdir>/trace.json`` in Chrome's trace format (open in
    Perfetto or chrome://tracing); a None logdir is a no-op so callers can
    thread a CLI flag through."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("wrote profiler trace to %s", path)
