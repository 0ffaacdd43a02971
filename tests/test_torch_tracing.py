"""The port's own tracing, on the CPU (grtcode_tpu_torch/utils/metrics.py):

* the driver's host spans: each once a call under its parent, for a
  one-band call and a compacted two-band call (whose two steps each
  check limits and run), and the layers of the step's body under
  ``grtcode::step``;
* ``metrics.layer``: a profiler range always, and a timing event at
  entry and at exit only while a capture runs;
* ``metrics.layer_times``: a captured step's replays add their layers'
  times when the last event has completed, count the replay untimed
  when it has not, and the block reads the last replay on leaving, with
  one synchronisation; outside the block nothing is read; a replay
  inside nested blocks is read once, by the innermost block;
* the names of the spans and layers.

The step cache's counts are in tests/test_torch_graph_step.py; a
captured step's layer times against the profiler's kernel times, on the
card, in tests/test_torch_gpu.py.
"""
import collections
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from grtcode_tpu_torch import examples  # noqa: E402
from grtcode_tpu_torch.framework.driver import RadiationDriver  # noqa: E402
from grtcode_tpu_torch.utils import graphs, metrics  # noqa: E402

PARENT = {metrics.RUN: None, metrics.INPUTS: metrics.RUN,
          metrics.SURFACE_SPECTRA: metrics.INPUTS,
          metrics.CHECK_LIMITS: metrics.RUN, metrics.GATHER: metrics.RUN,
          metrics.SCATTER: metrics.RUN, metrics.STEP_EAGER: metrics.RUN,
          metrics.STEP: metrics.STEP_EAGER}


@pytest.fixture(scope="module")
def model():
    lw, sw, solar, batch, _, _ = examples.rfmip_like(smoke=True,
                                                     device="cpu")
    return lw, sw, solar, examples.atmosphere(batch)


def _spans(fn):
    """(count, parent span) of each ``grtcode::`` range that ``fn()``
    records."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    seen = collections.Counter()
    for e in prof.events():
        if not e.name.startswith("grtcode::"):
            continue
        up = e.cpu_parent
        while up is not None and not up.name.startswith("grtcode::"):
            up = up.cpu_parent
        seen[(e.name, None if up is None else up.name)] += 1
    return seen


@pytest.mark.parametrize("case", ["one_band", "compacted_two_band"])
def test_driver_spans_once_a_call_under_their_parents(model, case):
    lw, sw, solar, atm = model
    if case == "one_band":
        driver, steps = RadiationDriver(lw), 1
    else:
        driver, steps = RadiationDriver(lw, sw, solar), 2
        mu = np.full(atm.batch, -0.4)
        mu[0] = 0.6                  # lit bucket 1 and night bucket 4
        atm = dataclasses.replace(atm, cos_zenith=mu)
    for _ in range(2):               # a second call records the same
        seen = _spans(lambda: driver.run(atm))
        want = {metrics.RUN: 1, metrics.INPUTS: 1,
                metrics.SURFACE_SPECTRA: 1, metrics.GATHER: 1,
                metrics.SCATTER: steps - 1, metrics.CHECK_LIMITS: steps,
                metrics.STEP_EAGER: steps, metrics.STEP: steps}
        for name, n in want.items():
            assert seen[(name, PARENT[name])] == n, name
        spans = {name for name, _ in seen if name in metrics.SPANS}
        assert spans == {k for k, n in want.items()
                         if n and k in metrics.SPANS}
        # The body's layers, each under the step.
        layers = collections.Counter()
        for (name, parent), n in seen.items():
            if name in metrics.LAYERS and name != metrics.STEP:
                assert parent == metrics.STEP, name
                layers[name] += n
        # The night step runs the longwave alone, the lit step both bands.
        mols = steps * len(lw.molecules) + (steps - 1) * len(sw.molecules)
        assert layers[metrics.LINE_PREP] == layers[metrics.VOIGT] == mols
        assert layers[metrics.LW_SOLVER] == steps
        assert layers[metrics.SW] == (2 if steps == 2 else 0)
    assert driver.step_stats()["eager"] == 2 * steps


class _Event:
    """torch.cuda.Event's stand-in: ``t`` is its stamp in ms."""

    made = []

    def __init__(self, enable_timing=False, external=False):
        assert enable_timing and external
        self.t, self.done, self.recorded = 0.0, True, 0
        _Event.made.append(self)

    def record(self):
        self.recorded += 1

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done
        return end.t - self.t


def test_layer_records_events_only_in_a_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    _Event.made = []
    with metrics.layer(metrics.VOIGT):       # no capture: no event
        pass
    assert not _Event.made
    with metrics.capturing_layers() as marks:
        with metrics.layer(metrics.STEP):
            with metrics.layer(metrics.LINE_PREP):
                pass
            with metrics.layer(metrics.VOIGT):
                pass
    assert [m[0] for m in marks] == [metrics.LINE_PREP, metrics.VOIGT,
                                     metrics.STEP]
    events = [e for m in marks for e in m[1:]]
    assert len(set(map(id, events))) == 6 == len(_Event.made)
    assert all(e.recorded == 1 for e in events)
    assert not metrics._capturing
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    with metrics.capturing_layers() as marks:   # not the capture stream
        with metrics.layer(metrics.STEP):
            pass
    assert not marks


def _timed_step(times):
    """A captured step (graph stubbed) with a step layer around a voigt
    layer; each replay stamps its events 100 ms after the last one's."""
    entry = graphs.CapturedStep.__new__(graphs.CapturedStep)
    entry.label, entry.signature = "step", graphs.signature(())
    entry._inputs, entry.static_outputs, entry.launches = [], (), {}
    entry.device, entry.times = torch.device("cpu"), times
    s0, v0, v1, s1 = (_Event(True, True) for _ in range(4))
    entry.layers = [(metrics.VOIGT, v0, v1), (metrics.STEP, s0, s1)]
    stamps = {"t": 0.0}

    def replay(_):
        t = stamps["t"]
        s0.t, v0.t, v1.t, s1.t = t, t + 1.0, t + 4.0, t + 5.5
        stamps["t"] += 100.0
    entry.graph = type("G", (), {"replay": replay})()
    return entry, s1


def test_layer_times_sums_skips_and_flushes(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    times = metrics.LayerTimes()
    entry, last = _timed_step(times)
    entry(())                                 # outside the block
    assert times.timed == times.untimed == 0 and not entry._unread
    with metrics.layer_times():
        entry(())                             # replay 1
        entry(())                             # reads 1, replays 2
        assert times.timed == 1 and not synced
        last.done = False                     # replay 2 still running
        entry(())                             # 2 untimed, replays 3
        assert (times.timed, times.untimed) == (1, 1)
        last.done = True
    assert synced == [torch.device("cpu")]    # one sync, then replay 3
    assert (times.timed, times.untimed) == (2, 1)
    assert times.ms == {metrics.VOIGT: 6.0, metrics.STEP: 11.0}
    assert not entry._unread and not metrics._reading
    entry(())                                 # outside again: no read
    assert times.timed == 2 and synced == [torch.device("cpu")]


def test_nested_layer_times_read_each_replay_once(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    times = metrics.LayerTimes()
    entry, _ = _timed_step(times)
    with metrics.layer_times():
        entry(())                             # replay 1, outer's to read
        with metrics.layer_times():
            entry(())                         # reads 1, replays 2
            assert times.timed == 1
        assert times.timed == 2 and len(synced) == 1   # inner reads 2
        assert not entry._unread
    assert times.timed == 2 and times.untimed == 0     # not read twice
    assert len(synced) == 1                   # nothing left to sync
    assert times.ms == {metrics.VOIGT: 6.0, metrics.STEP: 11.0}
    with metrics.layer_times():
        with metrics.layer_times():
            pass
        entry(())                             # replay 3, the outer's
    assert times.timed == 3 and len(synced) == 2


def test_layer_times_leaves_steps_without_layers_alone(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    times = metrics.LayerTimes()
    entry, _ = _timed_step(times)
    entry.layers = []                         # a step that captured none
    with metrics.layer_times():
        entry(())
        entry(())
    assert not synced and not entry._unread
    assert (times.timed, times.untimed, times.ms) == (0, 0, {})


def test_span_and_layer_names():
    names = metrics.SPANS + metrics.LAYERS
    assert len(set(names)) == len(names) == 21
    assert all(n.startswith("grtcode::") for n in names)
    # The three ranges profiles read by name keep their names.
    assert (metrics.LINE_PREP, metrics.CLOUD_OPTICS, metrics.DISORT) == (
        "grtcode::line_prep", "grtcode::cloud_optics", "grtcode::disort")


def _doublings_needed(tau, omega, g, nstr):
    """Each element's doubling count, worked out in float64 from its
    delta-M scaled optical depth: the least k >= 0 with tau / 2^k <= 1e-5,
    at most 37; and how many elements lie within 1e-4 of a step of log2,
    where the solver's float32 logarithm may round to the other side."""
    tau, omega, g = (np.asarray(a, np.float64) for a in (tau, omega, g))
    scaled = (1.0 - omega * g ** nstr) * tau
    q = np.log2(np.maximum(scaled, 1e-30) / 1e-5)
    k = np.clip(np.ceil(q), 0, 37)
    edge = (np.abs(q - np.round(q)) < 1e-4) & (q > -1.0) & (q < 37.0)
    return int(k.sum()), int(edge.sum())


def test_disort_counts_the_doublings_its_layers_need():
    """The solver's device counter against the counts worked out from its
    inputs, over three wavenumber blocks, each block's two layers once;
    a second call adds as much again."""
    from grtcode_tpu_torch.solvers.disort import disort_shortwave

    rng = np.random.default_rng(7)
    B, nl, nw, nstr = 2, 5, 40, 4
    tau = (10.0 ** rng.uniform(-7, 4, (B, nl, nw))).astype(np.float32)
    omega = rng.uniform(0, 1, (B, nl, nw)).astype(np.float32)
    g = rng.uniform(0, 0.9, (B, nl, nw)).astype(np.float32)
    args = [torch.as_tensor(a) for a in (tau, omega, g)] + [
        torch.tensor([0.5, 0.8]), torch.full((B, nw), 0.2),
        torch.tensor([1361.0, 1361.0]), torch.ones(nw)]
    counts = metrics.DoublingCounts("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        disort_shortwave(*args, nstr=nstr, wchunk=16, doublings=counts)
    ranges = collections.Counter(e.name for e in prof.events())
    assert ranges[metrics.DISORT_DOUBLING] == ranges[
        metrics.DISORT_ADDING] == 3
    needed, edge = _doublings_needed(tau, omega, g, nstr)
    got = counts.read()
    assert got["run"] == 37 * B * nl * nw
    assert abs(got["needed"] - needed) <= edge
    assert 0 < got["needed"] < got["run"]
    disort_shortwave(*args, nstr=nstr, wchunk=16, doublings=counts)
    assert counts.read() == {k: 2 * v for k, v in got.items()}


def test_lockstep_doublings_count_each_group_s_largest_count():
    """On the card the doubling kernel adds the element-steps its warps
    run in lockstep (each warp's largest count a member) to ``run``
    itself, at run_ptr; the wrapper adds ``needed`` alone.  Here: the
    address is run's and nothing else's, a counter on another device is
    refused, and the plain loop on the CPU still runs 37 steps an
    element (tests/test_torch_gpu.py holds the kernel's count to each
    warp's largest count)."""
    import ctypes
    from grtcode_tpu_torch.solvers import disort

    counts = metrics.DoublingCounts("cpu")
    k = torch.tensor([[0.0, 3, 1, 2, 5, 5, 0, 0, 7, 1]])
    counts.add_needed(k)
    assert counts.read() == {"needed": 24, "run": 0}
    ctypes.c_int64.from_address(counts.run_ptr("cpu")).value += 3 * 4 + 7
    assert counts.read() == {"needed": 24, "run": 19}
    with pytest.raises(ValueError, match="the kernel on cuda"):
        counts.run_ptr(torch.device("cuda", 0))

    rng = np.random.default_rng(3)
    tau, omega, g = (torch.as_tensor(a, dtype=torch.float32) for a in (
        10.0 ** rng.uniform(-7, 3, (2, 3, 9)), rng.uniform(0, 1, (2, 3, 9)),
        rng.uniform(0, 0.9, (2, 3, 9))))
    mu0 = torch.tensor([0.4, 0.9])
    sub = disort.sublayers(tau, omega, g, 4)
    plain = metrics.DoublingCounts("cpu")
    disort.layer_operators(*sub, mu0, *disort.beam_vectors(mu0, 4),
                           doublings=plain)
    assert plain.read() == {"needed": int(sub[3].sum()), "run": 37 * 54}


def test_driver_steps_read_the_disort_counts(model, monkeypatch):
    """An eager DISORT step of a lit column on the CPU: its doubling
    counts against those worked out from the optical depths it gave the
    solver, DISORT's two layers under its range once a block, and no
    counts where the shortwave is the two-stream solver."""
    import grtcode_tpu_torch.framework.driver as driver_mod

    lw, sw, solar, atm = model
    atm = dataclasses.replace(atm.subset(np.arange(1)),
                              cos_zenith=np.array([0.6]))
    seen = []

    def kept(tau, omega, g, *a, **k):
        seen.append((tau.numpy().copy(), omega.numpy().copy(),
                     g.numpy().copy()))
        return disort(tau, omega, g, *a, **k)
    disort = driver_mod.disort_shortwave
    monkeypatch.setattr(driver_mod, "disort_shortwave", kept)
    driver = RadiationDriver(lw, sw, solar, sw_solver="disort",
                             disort_streams=4)
    assert driver.step_stats()["disort"] == {"needed": 0, "run": 0}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        driver.run(atm)
    parents = collections.Counter()
    for e in prof.events():
        if e.name in (metrics.DISORT_DOUBLING, metrics.DISORT_ADDING):
            parents[(e.name, e.cpu_parent.name)] += 1
    blocks = -(-sw.grid.n // 2048)
    assert parents == {(metrics.DISORT_DOUBLING, metrics.DISORT): blocks,
                       (metrics.DISORT_ADDING, metrics.DISORT): blocks}
    (tau, omega, g), = seen
    needed, edge = _doublings_needed(tau, omega, g, 4)
    got = driver.step_stats()["disort"]
    assert got["run"] == 37 * tau.size
    assert abs(got["needed"] - needed) <= edge
    driver.run(atm)
    assert driver.step_stats()["disort"] == {k: 2 * v
                                             for k, v in got.items()}
    two_stream = RadiationDriver(lw, sw, solar)
    two_stream.run(atm)
    assert two_stream.step_stats()["disort"] == {"needed": 0, "run": 0}
