"""Gas optics: line catalogs, line prep, the Voigt kernel, continua and
cross sections, and the GasOptics engine."""
from .gas_optics import GasOptics  # noqa: F401
from .hitran import LineCatalog, parse_par_file, synthetic_catalog  # noqa: F401
from .molecules import MoleculeId, CfcId, CiaId  # noqa: F401
from .voigt import voigt_line_shape  # noqa: F401
