"""Radiative-transfer solvers: Planck, longwave, Rayleigh, solar flux,
shortwave (two-stream and discrete ordinates)."""
from .disort import disort_shortwave  # noqa: F401

__all__ = ["disort_shortwave"]
