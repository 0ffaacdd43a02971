"""grtcode_tpu_torch — the PyTorch / CUDA port of grtcode_tpu.

The clear-sky aerosol-free (CSAF) radiation step of the JAX package,
rebuilt on PyTorch for NVIDIA Hopper GPUs: HITRAN line prep, the
line_sample Voigt optical depth (a hand-written CUDA kernel,
:mod:`grtcode_tpu_torch.gas_optics.voigt_kernel`), water-vapor / ozone
continua, CFC and CIA cross sections, the four-stream longwave and the
delta-Eddington + adding shortwave solvers, and the batched driver.

Module paths mirror ``grtcode_tpu`` so each part has one obvious
reference.  The package imports torch and numpy only, never JAX: the host
code it needs (HITRAN parsing, TIPS tables, grid binding, range tables)
is carried here as a copy.
"""

__version__ = "0.1.0"

from .spectral import SpectralGrid  # noqa: F401,E402
from .optics import Optics, combine  # noqa: F401,E402
