"""Numerical-safety debug mode: NaN/Inf trapping and range guards (port of
grtcode_tpu/utils/debug.py).

The reference wraps every solver expression in floating-point exception
checks and guards its inputs with range macros (utilities/src/debug.h:
186-248, grtcode_config.h:60-99), compiled out with -DFAST.  Here:

  * ``debug_mode()`` — a ``torch.overrides.TorchFunctionMode`` that checks
    the floating-point outputs of every torch op and raises
    FloatingPointError at the first op that produces a NaN or Inf; the
    CUDA kernels, launched through ctypes and invisible to it, check
    their output tensors through :func:`check_kernel_output`;
  * ``validate_atmosphere()`` — host-side range guards over driver inputs
    mirroring the reference's temperature / probability / zenith limits,
    raising ValueError (GRTCODE_RANGE_ERR across the C ABI);
  * ``checked()`` — wraps a function so it returns ``(error, value)``
    instead of raising on a trapped value or a failed :func:`check`;
  * ``disable_jit()`` — the counterpart of ``jax.disable_jit()``: inside
    it a driver step on a CUDA device runs eagerly, op by op,
    instead of replaying its captured CUDA graph
    (:mod:`.graphs`); ``debug_mode()`` implies it, as JAX's
    ``debug_nans`` re-runs a step un-jitted.  It is the only way to an
    eager step on the card.

Production runs skip all of this, like the reference's -DFAST: each op
checked costs a host-device synchronisation.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from .. import constants

_active: list = []   # the debug modes entered, innermost last
_eager: list = []    # the disable_jit blocks entered


def _first_bad(value, nans: bool, infs: bool):
    """'NaN' or 'Inf' for the first floating tensor in ``value`` (a tensor
    or a tuple / list of them) that holds one, else None."""
    todo = [value]
    while todo:
        x = todo.pop()
        if isinstance(x, (tuple, list)):
            todo.extend(x)
        elif isinstance(x, torch.Tensor) and x.is_floating_point() \
                and x.numel():
            if nans and bool(torch.isnan(x).any()):
                return "NaN"
            if infs and bool(torch.isinf(x).any()):
                return "Inf"
    return None


class _TrapNonFinite(TorchFunctionMode):
    def __init__(self, nans: bool, infs: bool):
        super().__init__()
        self.nans, self.infs = nans, infs

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        bad = _first_bad(out, self.nans, self.infs)
        if bad is not None:
            raise FloatingPointError(
                f"{bad} produced by {getattr(func, '__name__', func)}")
        return out


@contextlib.contextmanager
def disable_jit():
    """Run every step inside the block eagerly on the card: no CUDA
    graph is captured or replayed (``jax.disable_jit()``).  The layers'
    profiler ranges inside a step (``grtcode::line_prep``,
    ``grtcode::voigt``, ... : :data:`.metrics.LAYERS`) are recorded only
    when its Python code runs, so a profile that reads the host ranges
    runs its step under this.  The layers' device times come from the
    replays instead (:func:`.metrics.layer_times`), which this block
    turns off."""
    _eager.append(True)
    try:
        yield
    finally:
        _eager.pop()


def jit_disabled() -> bool:
    """True inside :func:`disable_jit` or :func:`debug_mode`."""
    return bool(_eager or _active)


@contextlib.contextmanager
def debug_mode(nans: bool = True, infs: bool = True):
    """Raise FloatingPointError at the torch op (or CUDA kernel) that
    first produces a NaN (``nans``) or an Inf (``infs``) inside the
    block (debug.h:186-248 equivalent).  Expect a large slowdown.  Steps
    inside it run eagerly (it implies :func:`disable_jit`)."""
    mode = _TrapNonFinite(nans, infs)
    _active.append(mode)
    try:
        with mode:
            yield
    finally:
        _active.remove(mode)


def check_kernel_output(name: str, tensor: torch.Tensor) -> None:
    """Inside :func:`debug_mode`, raise FloatingPointError when a kernel's
    output ``tensor`` holds a trapped value; a no-op outside it."""
    if not _active:
        return
    mode = _active[-1]
    bad = _first_bad(tensor, mode.nans, mode.infs)
    if bad is not None:
        raise FloatingPointError(f"{bad} produced by the {name} kernel")


def _in_range(name, value, lo, hi):
    a = np.asarray(value)
    if a.size and (np.any(a < lo) | np.any(a > hi)):
        bad = float(a.min()) if np.any(a < lo) else float(a.max())
        raise ValueError(
            f"{name} value {bad} outside allowed range [{lo}, {hi}]")


def validate_atmosphere(atm) -> None:
    """Host-side range guards over an Atmosphere, mirroring the
    reference's config limits (grtcode_config.h:52-99): layer count,
    temperatures, pressures, probabilities, zenith cosines, solar flux.
    """
    nlayers = atm.level_pressure.shape[-1] - 1
    if not (1 <= nlayers <= constants.MAX_NUM_LAYERS):
        raise ValueError(
            f"number of layers {nlayers} outside [1, "
            f"{constants.MAX_NUM_LAYERS}]")
    for name in ("level_temperature", "layer_temperature",
                 "surface_temperature"):
        _in_range(name, getattr(atm, name), constants.MIN_TEMPERATURE,
                  constants.MAX_TEMPERATURE)
    _in_range("level_pressure", atm.level_pressure, 0.0, np.inf)
    if atm.cos_zenith is not None:
        _in_range("cos_zenith", atm.cos_zenith, -np.inf, 1.0)
    if atm.total_solar_irradiance is not None:
        _in_range("total_solar_irradiance", atm.total_solar_irradiance,
                  0.0, np.inf)
    if atm.cloud_fraction is not None:
        _in_range("cloud_fraction", atm.cloud_fraction, 0.0, 1.0)
    for vmr_dict in (atm.ppmv, atm.cfc_ppmv, atm.cia_ppmv):
        for k, v in (vmr_dict or {}).items():
            _in_range(f"ppmv[{k}]", v, 0.0, 1e6)


class CheckError(Exception):
    """A failed :func:`check` (checkify's user check)."""


def check(pred, msg: str) -> None:
    """Raise CheckError with ``msg`` unless ``pred`` (a bool or a boolean
    tensor, all of which must hold) is true."""
    if not bool(torch.as_tensor(pred).all()):
        raise CheckError(msg)


class Error:
    """What :func:`checked` returns beside the value: ``throw()``
    re-raises the trapped error, if there was one."""

    def __init__(self, exc: Exception | None = None):
        self.exc = exc

    def get(self) -> str | None:
        return None if self.exc is None else str(self.exc)

    def throw(self) -> None:
        if self.exc is not None:
            raise self.exc


def checked(fn):
    """``fn`` wrapped to run under :func:`debug_mode` and return ``(error,
    value)``: a NaN or Inf produced by an op, or a failed :func:`check`,
    becomes the error (value None) instead of an exception, and
    ``error.throw()`` raises it on the host (the port of checkify's
    float and user checks)."""
    def wrapped(*args, **kwargs):
        try:
            with debug_mode():
                return Error(), fn(*args, **kwargs)
        except (FloatingPointError, CheckError) as e:
            return Error(e), None
    return wrapped
