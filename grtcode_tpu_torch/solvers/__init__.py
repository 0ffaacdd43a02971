"""Radiative-transfer solvers: Planck, longwave, Rayleigh, solar flux,
shortwave (two-stream and discrete ordinates)."""
from .planck import planck_law, effective_planck  # noqa: F401
from .longwave import longwave_fluxes  # noqa: F401
from .shortwave import shortwave_fluxes  # noqa: F401
from .rayleigh import rayleigh_optics  # noqa: F401
from .disort import disort_shortwave  # noqa: F401
from .solar_flux import SolarFlux  # noqa: F401
