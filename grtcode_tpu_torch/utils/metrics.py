"""Observability: phase timers, throughput counters, profiler traces,
and the program's own spans and layers (port of
grtcode_tpu/utils/metrics.py).

The reference's only tracing is its kernel-launch logging at INFO
verbosity (utilities/src/debug.h:281-282, 359-360).  Here the grid-points/s
metric is a first-class counter, phases are wall-clock timed after the
result's CUDA device has finished its queued work, and a context manager
wraps ``torch.profiler`` for on-demand traces in Chrome's trace format.

Spans and layers.  The driver marks its host work with :func:`span`, a
``torch.profiler.record_function`` range (``SPANS``): a profiler records
it on every call, on the same clock as the device's kernels, so an idle
gap of the device falls under the span that made it.  The step's body
marks its parts with :func:`layer` (``LAYERS``), also a range, which a
profiler records only where the body's Python runs: an eager call or a
capture, never a replay.  While a CUDA graph is being captured a layer
also records a timing event at its entry and its exit; the events become
nodes of the graph, so every replay stamps them on the device.  Inside a
:func:`layer_times` block each captured step reads its previous replay's
stamps before it replays again, and the block reads the last replays on
leaving: the device milliseconds of each layer, summed into the step
cache's :class:`LayerTimes` (``RadiationDriver.step_stats()``).  Outside
the block nothing is read.

Everything here is host-side and costs nothing when unused, but for the
layers' timing events, which a capture records into its graph, and
:class:`DoublingCounts`, which the DISORT solver adds to on the device
(one reduction a wavenumber block; on the card the doubling kernel adds
the steps it runs itself).
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time

import torch

log = logging.getLogger("grtcode_tpu_torch")

# Host spans (RadiationDriver and its step cache), innermost last.
RUN = "grtcode::run"                        # RadiationDriver.run, run_columns
INPUTS = "grtcode::inputs"                  # the inputs' copies to the device
SURFACE_SPECTRA = "grtcode::surface_spectra"    # inside INPUTS
CHECK_LIMITS = "grtcode::check_limits"      # the line_sample limits, a sync
GATHER = "grtcode::gather"                  # rows and compaction buckets
SCATTER = "grtcode::scatter"                # compaction's scatter-back
STEP_EAGER = "grtcode::step_eager"          # a step run op by op
STEP_CAPTURE = "grtcode::step_capture"      # a step captured as a graph
STEP_REPLAY = "grtcode::step_replay"        # copies in, replay, clones out
SPANS = (RUN, INPUTS, SURFACE_SPECTRA, CHECK_LIMITS, GATHER, SCATTER,
         STEP_EAGER, STEP_CAPTURE, STEP_REPLAY)

# Device layers of a step's body; STEP holds the others and the time in
# none of them.
STEP = "grtcode::step"
LINE_PREP = "grtcode::line_prep"            # lines.prepare, per molecule
VOIGT = "grtcode::voigt"                    # K1, K2 or the scatter sum
ABSORBERS = "grtcode::absorbers"            # continua, CFC and CIA
BIN_INTERP = "grtcode::bin_interp"          # the bin methods' wings
LW_SOLVER = "grtcode::lw_solver"            # longwave_fluxes
INTEGRALS = "grtcode::integrals"            # spectral integrals, block sums
SW = "grtcode::sw"                          # Rayleigh, two-stream solver
CLOUD_OPTICS = "grtcode::cloud_optics"      # the all-sky tier's callback
DISORT = "grtcode::disort"                  # the discrete-ordinates solver
# Inside DISORT, per wavenumber block: the phase matrices, delta-M and
# the doublings; the surface, the adding passes and the flux sums.
DISORT_DOUBLING = "grtcode::disort_doubling"
DISORT_ADDING = "grtcode::disort_adding"
LAYERS = (STEP, LINE_PREP, VOIGT, ABSORBERS, BIN_INTERP, LW_SOLVER,
          INTEGRALS, SW, CLOUD_OPTICS, DISORT, DISORT_DOUBLING,
          DISORT_ADDING)

_capturing: list = []   # the layer events of each capture in progress
_reading: list = []     # each open layer_times() block's unread steps


def span(name: str):
    """The host span ``name`` (one of ``SPANS``): a profiler range."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def layer(name: str):
    """The device layer ``name`` (one of ``LAYERS``): a profiler range
    and, while a :func:`capturing_layers` capture runs on the current
    stream, a timing event at entry and one at exit, kept as ``(name,
    start, end)`` with the capture's events.  No two layers share an
    event."""
    with torch.profiler.record_function(name):
        if not (_capturing and torch.cuda.is_current_stream_capturing()):
            yield
            return
        start = torch.cuda.Event(enable_timing=True, external=True)
        start.record()
        yield
        end = torch.cuda.Event(enable_timing=True, external=True)
        end.record()
        _capturing[-1].append((name, start, end))


@contextlib.contextmanager
def capturing_layers():
    """Collects, in the list it yields, the ``(name, start, end)`` events
    of the layers that a graph capture inside the block records."""
    marks = []
    _capturing.append(marks)
    try:
        yield marks
    finally:
        _capturing.pop()


class LayerTimes:
    """Device milliseconds by layer, summed over the timed replays of
    captured steps; ``untimed`` counts replays whose events had not
    completed when the step replayed again."""

    def __init__(self):
        self.ms: dict = {}
        self.timed = 0
        self.untimed = 0

    def add(self, marks) -> None:
        """Add one replay's ``(name, start, end)`` events, all
        completed."""
        for name, start, end in marks:
            self.ms[name] = self.ms.get(name, 0.0) + start.elapsed_time(end)
        self.timed += 1


class LinePrepCounts:
    """Lines prepped (``prepped``) against the catalog lines they stand
    for (``catalog``), added once per molecule and spectral block where a
    step's Python runs: an eager call or a capture.  A replay repeats its
    capture's prep and adds nothing.  ``share`` is 1.0 where every block
    preps the whole catalog."""

    def __init__(self):
        self.prepped = 0
        self.catalog = 0

    def add(self, prepped: int, catalog: int) -> None:
        self.prepped += prepped
        self.catalog += catalog

    @property
    def share(self) -> float | None:
        return self.prepped / self.catalog if self.catalog else None


class DoublingCounts:
    """The discrete-ordinates solver's doubling steps: ``needed``, the
    steps each (column, layer, wavenumber) element's optical depth needs
    (its doubling count k), summed, against ``run``, the element-steps the
    solver issues: the masked loop on the CPU runs all of its steps on
    every element (:meth:`add`); the card's kernel runs each warp's
    elements in lockstep to the warp's largest count, and adds those
    element-steps itself at :meth:`run_ptr` (one atomic a warp), beside
    :meth:`add_needed`.
    Both are added on the device into an int64 tensor made outside any
    capture, so each replay of a captured step adds what its eager call
    added; :meth:`read` copies them to the host, a synchronisation, so it
    is read outside a step."""

    def __init__(self, device):
        self.counts = torch.zeros(2, dtype=torch.int64, device=device)

    def add(self, k: torch.Tensor, steps: int) -> None:
        """Add a block's doubling counts ``k`` (whole numbers in any
        dtype) and ``steps`` run for each of its elements."""
        self.counts[0].add_(k.sum(dtype=torch.int64))
        self.counts[1].add_(steps * k.numel())

    def add_needed(self, k: torch.Tensor) -> None:
        """Add a block's doubling counts ``k`` to ``needed`` alone."""
        self.counts[0].add_(k.sum(dtype=torch.int64))

    def run_ptr(self, device) -> int:
        """The device address of ``run`` (an int64), for a kernel on
        ``device`` that adds the steps it runs."""
        if self.counts.device != torch.device(device):
            raise ValueError(f"the counts are on {self.counts.device}, the "
                             f"kernel on {device}")
        return self.counts[1].data_ptr()

    def read(self) -> dict:
        needed, run = self.counts.tolist()
        return {"needed": needed, "run": run}


def unread_replays():
    """The innermost open :func:`layer_times` block's unread steps (a
    dict a step adds itself to after a replay), or None outside one."""
    return _reading[-1] if _reading else None


@contextlib.contextmanager
def layer_times():
    """Read the device time of each layer in the replays of captured
    steps inside the block.  Before each replay a step adds its previous
    replay's times if that replay's last event has completed (a query,
    which never blocks), else counts the replay untimed; on leaving, the
    block synchronises once and reads each step's last replay.  Outside
    such a block a replay reads nothing."""
    unread = {}
    _reading.append(unread)
    try:
        yield
    finally:
        _reading.pop()
        # A step of a nested block that the inner block read is no
        # longer unread here.
        steps = [step for step in unread.values() if step._unread]
        for device in {step.device for step in steps}:
            torch.cuda.synchronize(device)
        for step in steps:
            step.read_layers()


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
