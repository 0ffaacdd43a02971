"""The traced run's readings: host syncs and the profiler's trace.

``SyncCounter`` is a frozen copy of ``chip_smoke.py::count_syncs`` at
commit 64ee402 (``torch.cuda.set_sync_debug_mode("warn")`` around the
calls into the program).  ``DeviceTrace`` reads ``torch.profiler``'s
events (CUPTI), as ``grtcode_tpu_torch/bench.py::_profile_kernels`` does
at that commit, but from the raw events: each device operation's own
time by name, and the device's busy time as the union of the operations'
intervals inside the traced window, so it stays right if a program runs
work on a second stream; and the host seconds of the program's own spans
in the window.
"""
from __future__ import annotations

import collections
import os
import warnings

import numpy as np
import torch

WINDOW_RANGE = "rtbench::window"


class SyncCounter:
    """Counts the host-device synchronisations of the calls made inside
    ``with counter:``, by the line that made them: at each, the host waits
    for the card to drain its queue, and the card then idles until the
    host has queued the next kernel."""

    def __init__(self):
        self.where = collections.Counter()

    def __enter__(self):
        torch.cuda.synchronize()
        self._caught = warnings.catch_warnings(record=True)
        self._list = self._caught.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        try:
            torch.cuda.set_sync_debug_mode("default")
        finally:
            self._caught.__exit__(*exc)
        self.where.update(f"{os.path.relpath(w.filename)}:{w.lineno}"
                          for w in self._list
                          if "synchroniz" in str(w.message))
        return False

    @property
    def total(self) -> int:
        return sum(self.where.values())


def _union(spans: np.ndarray) -> tuple[float, list]:
    """(covered length, gaps as (start, end)) of [start, end) intervals
    sorted by start."""
    s, e = spans[:, 0], spans[:, 1]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    starts = s[idx]
    ends = run_end[np.r_[idx[1:] - 1, len(s) - 1]]
    return float((ends - starts).sum()), list(zip(ends[:-1], starts[1:]))


class DeviceTrace:
    """The device operations of a ``torch.profiler.profile`` run that
    held one ``WINDOW_RANGE`` span: ``window_s``, ``busy_s``, device
    seconds by operation name, and the idle gaps labelled by what the host
    was doing in them."""

    def __init__(self, prof):
        events = prof.profiler.kineto_results.events()
        window = [e for e in events if e.name() == WINDOW_RANGE]
        if not window:
            raise ValueError(f"the trace holds no {WINDOW_RANGE} span")
        w0 = window[0].start_ns()
        w1 = window[0].duration_ns()       # times from here on: ns from w0
        dev, host = [], []
        for e in events:
            if e.name() == WINDOW_RANGE:
                continue
            s = e.start_ns() - w0
            end = s + e.duration_ns()
            if end <= 0 or s >= w1:
                continue
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not e.is_user_annotation():      # not a range's mirror
                    dev.append((max(s, 0), min(end, w1), e.name()))
            else:
                host.append((s, end, e.name()))
        self.window_s = w1 * 1e-9
        self._w1 = w1
        self.by_name = collections.Counter()
        for s, e, name in dev:
            self.by_name[name] += (e - s) * 1e-9
        if dev:
            spans = np.array(sorted((s, e) for s, e, _ in dev), np.float64)
            covered, gaps = _union(spans)
            gaps = [(0.0, spans[0, 0])] + gaps + [(spans[:, 1].max(), w1)]
        else:
            covered, gaps = 0.0, [(0.0, w1)]
        self.busy_s = covered * 1e-9
        self._gaps = [(a, b) for a, b in gaps if b > a]
        self._host = host

    def host_spans(self, prefix: str) -> dict:
        """Host seconds by name of the spans and operations whose names
        start with ``prefix``, each clipped to the window, summed."""
        out = collections.Counter()
        for s, e, name in self._host:
            if name.startswith(prefix):
                out[name] += (min(e, self._w1) - max(s, 0)) * 1e-9
        return dict(out)

    def top_ops(self, n: int = 10) -> list:
        return [[name[:160], sec] for name, sec in
                self.by_name.most_common(n)]

    def idle_by_host(self, n: int = 10, longest: int = 2000) -> list:
        """Idle seconds of the ``longest`` idle gaps, summed by the
        innermost host operation running at each gap's midpoint."""
        gaps = sorted(self._gaps, key=lambda g: g[0] - g[1])[:longest]
        if not self._host:
            return [["host: no operation", sum((b - a) for a, b in gaps)
                     * 1e-9]][:n]
        hs = np.array([h[0] for h in self._host], np.float64)
        he = np.array([h[1] for h in self._host], np.float64)
        names = [h[2] for h in self._host]
        idle = collections.Counter()
        for a, b in gaps:
            mid = 0.5 * (a + b)
            inside = np.flatnonzero((hs <= mid) & (he >= mid))
            if inside.size:
                k = inside[np.argmin(he[inside] - hs[inside])]
                label = names[k][:160]
            else:
                label = "host: no operation"
            idle[label] += (b - a) * 1e-9
        return [[k, v] for k, v in idle.most_common(n)]
