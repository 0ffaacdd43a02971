"""Captured steps: the port's counterpart of ``jax.jit``.

The JAX package compiles each step once per key and replays the program
after that, with no host round trip and no per-op dispatch inside it.
Here a step on a CUDA device runs eagerly at the first call of its key,
which is its warm-up, and is captured as a ``torch.cuda.CUDAGraph`` at the
second call and replayed after that (:class:`StepCache`,
:class:`CapturedStep`).  A step called once, as an app's run is, costs
what the eager step costs and holds no graph.  On the CPU, and on the
card under :func:`..utils.debug.disable_jit` or
:func:`..utils.debug.debug_mode`, every call runs eagerly.

A captured step owns:

  * static input tensors, which each call copies its inputs into (as JAX
    transfers a jitted function's arguments);
  * the graph, captured in a memory pool that the caller may share among
    its graphs (one driver's graphs share one pool: replays run one after
    another, and each replay's outputs are cloned before the next);
  * its outputs, cloned out after each replay;
  * the launches it captured of each dispatcher registered with
    :func:`count_launches`: a dispatcher's ``.launches`` count advances
    when its Python code runs, which a replay does not, so each replay
    adds the launches its graph holds;
  * the timing events of the layers it captured
    (:func:`.metrics.layer`), read inside a :func:`.metrics.layer_times`
    block into its cache's :class:`.metrics.LayerTimes`.

What a trace sees.  Host ranges inside a step (the layers of
:mod:`.metrics`) are recorded where the step's Python runs, at its eager
call and its capture; the device time of each layer comes from the
replays' timing events.  The cache's own spans (``grtcode::step_eager``,
``grtcode::step_capture``, ``grtcode::step_replay``) are recorded on
every call, and :attr:`StepCache.counts` counts its eager calls,
captures, replays and the graphs it dropped.

Memory.  A graph keeps its pool's memory for as long as it lives, so the
first capture of a process turns on the allocator's expandable segments
(unless ``PYTORCH_CUDA_ALLOC_CONF`` or ``PYTORCH_ALLOC_CONF`` names the
setting): with fixed segments a pool, like the eager step's cache, holds
about twice a full-width step's tensors.  ``torch.cuda.graph`` gives the
allocator's cached blocks back to the card before it captures, so the
pool takes the memory that the eager warm-up held, not memory beside
it.  A cache whose step runs out of memory (at its eager call or at a
capture) while it holds graphs drops them, gives their memory back and
runs the step once more; the dropped keys are captured again at their
next call.  :meth:`StepCache.clear` drops a cache's graphs on request.

The first-use work (the kernels' ``nvcc`` builds and ``ctypes`` loads, the
device tables the owners cache, cuBLAS's handles) happens in the eager
call, outside any graph.  A capture that fails for another reason raises,
naming the op where the error appeared; it never falls back to the eager
step.  Nothing in a captured step may copy from the host, synchronise or
branch on device data; :func:`device_constant` builds the constants such a
step needs once per device.
"""
from __future__ import annotations

import gc
import os
import time
import traceback
import warnings

import torch

from . import debug, metrics

_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))
_constants: dict = {}
_counted: list = []    # the dispatchers registered with count_launches
_allocator_set = False  # whether a capture has set the allocator


def device_constant(value, device, dtype=torch.float32) -> torch.Tensor:
    """``torch.tensor(value, dtype=dtype, device=device)`` (a number or a
    tuple of numbers), built once per device and then shared: the same
    bits as building it anew, with no host copy after the first call.
    Never write into the result."""
    device = torch.device(device)
    key = (value, dtype, device)
    out = _constants.get(key)
    if out is None:
        out = _constants[key] = torch.tensor(value, dtype=dtype,
                                             device=device)
    return out


def count_launches(fn):
    """Register ``fn``, a kernel's dispatcher that adds one to
    ``fn.launches`` where it launches its kernel, so that each replay of
    a graph adds the launches of ``fn`` that the graph captured.  Sets
    the count to 0; used as a decorator."""
    fn.launches = 0
    _counted.append(fn)
    return fn


def _expandable_segments() -> None:
    """Turn on the allocator's expandable segments, once a process,
    unless the user's allocator settings name them."""
    global _allocator_set
    if _allocator_set:
        return
    _allocator_set = True
    conf = (os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "") + ","
            + os.environ.get("PYTORCH_ALLOC_CONF", ""))
    if "expandable_segments" not in conf:
        with warnings.catch_warnings():     # renamed in later releases
            warnings.simplefilter("ignore", FutureWarning)
            torch.cuda.memory._set_allocator_settings(
                "expandable_segments:True")


def signature(tree):
    """A hashable description of a tree of tensors (nested dicts, tuples
    and lists, with None and plain values): its structure and each
    tensor's shape, dtype and device.  A graph replays only inputs of its
    own signature."""
    if isinstance(tree, torch.Tensor):
        return ("T", tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, dict):
        return ("D",) + tuple((k, signature(v)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return ("L",) + tuple(signature(v) for v in tree)
    return ("V", tree)


def _leaves(tree):
    """The tensors of a tree, in :func:`signature`'s order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _map(fn, tree):
    """``tree`` with each tensor ``t`` replaced by ``fn(t)``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _site(err: BaseException) -> str:
    """Where ``err`` was raised: the innermost frame of its traceback
    outside PyTorch and this module (else the innermost frame)."""
    frames = traceback.extract_tb(err.__traceback__)
    outside = [f for f in frames
               if not os.path.abspath(f.filename).startswith(_TORCH_DIR)
               and os.path.abspath(f.filename) != os.path.abspath(__file__)]
    frame = (outside or frames or [None])[-1]
    if frame is None:
        return "an unknown op"
    return f"{frame.filename}:{frame.lineno} in {frame.name} ({frame.line})"


def _abandon(capture, device, pool) -> None:
    """Undo what a failed ``torch.cuda.graph`` block leaves behind when
    its capture_end raises: the capture stream stays current, and the
    allocator keeps routing that stream's allocations into ``pool``."""
    from torch.cuda import memory

    if pool is not None:
        try:
            memory._cuda_endAllocateToPool(device.index, pool)
        except RuntimeError:
            pass         # the capture never began allocating to the pool
    if torch.cuda.current_stream(device) == capture.capture_stream:
        capture.stream_ctx.__exit__(None, None, None)


class CaptureError(RuntimeError):
    """A step that cannot be captured as a CUDA graph; ``first`` is the
    error where the capture failed."""

    def __init__(self, msg: str, first: BaseException):
        super().__init__(msg)
        self.first = first


class CapturedStep:
    """One captured step: ``entry(inputs)`` copies ``inputs`` (a tree of
    tensors of the captured signature) into the static inputs, replays
    the graph, adds its captured launches (``launches``, by registered
    dispatcher) to their counts and returns clones of its outputs.
    ``capture_s`` is the host seconds of its capture; ``layers`` the
    ``(name, start, end)`` timing events of the layers it captured,
    whose replays add to ``times`` inside a :func:`.metrics.layer_times`
    block.  ``fn`` must have run once on inputs of this signature
    outside any graph (its warm-up)."""

    _unread = False      # a replay inside a layer_times block not yet read

    def __init__(self, fn, inputs, *, pool=None, label: str = "step",
                 times: metrics.LayerTimes | None = None):
        self.device = device = _leaves(inputs)[0].device
        self.label, self.signature = label, signature(inputs)
        self.times = metrics.LayerTimes() if times is None else times
        counted = list(_counted)
        before = [f.launches for f in counted]
        self.static_inputs = _map(torch.clone, inputs)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.graph(self.graph, pool=pool)
        try:
            with metrics.capturing_layers() as self.layers, capture:
                self.static_outputs = fn(self.static_inputs)
        except Exception as err:
            _abandon(capture, device, pool)
            first = err
            while first.__context__ is not None:
                first = first.__context__
            raise CaptureError(
                f"CUDA graph capture of the {label} failed at "
                f"{_site(first)}: {type(first).__name__}: {first}",
                first) from err
        finally:
            after = [f.launches for f in counted]
            for f, b in zip(counted, before):
                f.launches = b
        self.capture_s = time.perf_counter() - t0
        self.launches = {f: a - b for f, a, b in zip(counted, after, before)}
        self._inputs = _leaves(self.static_inputs)

    def __call__(self, inputs):
        sig = signature(inputs)
        if sig != self.signature:
            raise ValueError(f"{self.label}: inputs {sig} do not match the "
                             f"captured graph's {self.signature}")
        for dst, src in zip(self._inputs, _leaves(inputs)):
            dst.copy_(src)
        self.read_layers()
        self.graph.replay()
        unread = metrics.unread_replays()
        if unread is not None and self.layers:
            self._unread = True
            unread[id(self)] = self
        for f, n in self.launches.items():
            f.launches += n
        return _map(torch.clone, self.static_outputs)

    def read_layers(self) -> None:
        """Add the last replay's layer times to ``times`` if its last
        event has completed, else count the replay untimed; nothing if
        that replay was read already or made outside a
        :func:`.metrics.layer_times` block."""
        if not self._unread:
            return
        self._unread = False
        if self.layers[-1][2].query():
            self.times.add(self.layers)
        else:
            self.times.untimed += 1


def _out_of_memory(err: BaseException) -> bool:
    """Whether ``err`` is the allocator's, or a capture's that failed on
    it."""
    if isinstance(err, CaptureError):
        err = err.first
    return isinstance(err, torch.cuda.OutOfMemoryError)


class StepCache:
    """Captured steps by key, all in one memory pool (JAX's
    ``_step_cache``): ``cache(key, fn, inputs, label)`` is ``fn(inputs)``.
    On the CPU and under :func:`..utils.debug.disable_jit` it runs
    eagerly.  On the card the key is ``key`` plus the inputs'
    :func:`signature`: its first call runs eagerly (the warm-up), its
    second captures a :class:`CapturedStep` and replays it, and later
    calls replay.

    ``counts`` adds one per call run eagerly (a key's warm-up, or any
    call on the CPU or under ``disable_jit``), per capture, per replay
    (the capturing call replays too) and per graph dropped when a step
    ran out of memory; ``times`` sums its steps' layer times
    (:func:`.metrics.layer_times`).  :meth:`stats` reads both."""

    def __init__(self):
        self.entries = {}      # key -> CapturedStep
        self.seen = set()      # keys whose eager warm-up has run
        self.pool = None
        self.counts = {"eager": 0, "captures": 0, "replays": 0,
                       "dropped": 0}
        self.times = metrics.LayerTimes()

    def stats(self) -> dict:
        """A copy of ``counts``, with the replays whose layers were timed
        (``timed``) or not (``untimed``) and the device ms of each layer
        summed over the timed ones (``layer_ms``)."""
        return dict(self.counts, timed=self.times.timed,
                    untimed=self.times.untimed,
                    layer_ms=dict(self.times.ms))

    def clear(self) -> None:
        """Drop every captured step and give their memory back to the card
        (``jax.clear_caches()``).  Each key runs its warm-up again."""
        held = bool(self.entries)
        self.entries.clear()
        self.seen.clear()
        self.pool = None
        if held:
            torch.cuda.empty_cache()

    @staticmethod
    def eager(inputs) -> bool:
        """Whether a step on ``inputs`` runs op by op."""
        return _leaves(inputs)[0].device.type != "cuda" or \
            debug.jit_disabled()

    def __call__(self, key, fn, inputs, label: str = "step"):
        if self.eager(inputs):
            return self._eager(fn, inputs)
        key = key + (signature(inputs),)
        try:
            return self._call(key, fn, inputs, label)
        except (torch.cuda.OutOfMemoryError, CaptureError) as err:
            if not (self.entries and _out_of_memory(err)):
                raise
        # Out of memory while this cache holds graphs: drop them, and the
        # failed call's frames, and run once more.
        self.counts["dropped"] += len(self.entries)
        self.entries.clear()
        self.pool = None
        gc.collect()
        torch.cuda.empty_cache()
        return self._call(key, fn, inputs, label)

    def _eager(self, fn, inputs):
        with metrics.span(metrics.STEP_EAGER):
            out = fn(inputs)
        self.counts["eager"] += 1
        return out

    def _replay(self, entry, inputs):
        with metrics.span(metrics.STEP_REPLAY):
            out = entry(inputs)
        self.counts["replays"] += 1
        return out

    def _call(self, key, fn, inputs, label):
        entry = self.entries.get(key)
        if entry is not None:
            return self._replay(entry, inputs)
        if key not in self.seen:
            out = self._eager(fn, inputs)       # the warm-up
            self.seen.add(key)
            return out
        _expandable_segments()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        try:
            with metrics.span(metrics.STEP_CAPTURE):
                entry = CapturedStep(fn, inputs, pool=self.pool,
                                     label=label, times=self.times)
        except CaptureError:
            # The allocator refuses further captures into the pool of a
            # failed one: later captures take a new pool.
            self.pool = None
            raise
        self.counts["captures"] += 1
        self.entries[key] = entry
        return self._replay(entry, inputs)
