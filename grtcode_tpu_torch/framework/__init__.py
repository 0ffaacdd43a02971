"""The radiation driver and its batched atmosphere."""
from .atmosphere import Atmosphere, pressure_interp_layers_to_levels
from .driver import FluxResults, RadiationDriver

__all__ = ["Atmosphere", "RadiationDriver", "FluxResults",
           "pressure_interp_layers_to_levels"]
