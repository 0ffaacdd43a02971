"""Cloud physics (port of grtcode_tpu/clouds): stochastic subcolumns drawn
with jax.random's bits (:mod:`..utils.prng`), the integer-parameter
incomplete beta, Pade and Hu & Stamnes band optics, and the facade that
maps them onto the solver grids."""
from .beta import beta_inverse, beta_value
from .hu_stamnes import HuStamnesLiquidOptics
from .lib import CloudOpticsLib, ice_particle_size
from .pade import PadeCloudOptics
from .stochastic import cloudiness, overlap_parameter, sample_condensate

__all__ = ["beta_value", "beta_inverse", "overlap_parameter", "cloudiness",
           "sample_condensate", "PadeCloudOptics", "HuStamnesLiquidOptics",
           "CloudOpticsLib", "ice_particle_size"]
