"""Host and device helpers: Curtis-Godson layer averages, interpolation
and trapezoid integration (the exports of grtcode_tpu/utils)."""
from .interp import (  # noqa: F401
    angstrom_exponent_sample,
    interpolate_piecewise,
    interpolate_to_grid_np,
    trapezoid_integral,
)
from .curtis_godson import (  # noqa: F401
    number_densities,
    layer_pressures_temperatures,
    partial_pressures_and_densities,
)
