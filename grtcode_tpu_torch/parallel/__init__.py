"""Multi-GPU and multi-process runs: (columns x spectral) meshes of
``torch.distributed`` ranks and the sharded clear-sky step (port of
grtcode_tpu/parallel).

The reference's scale-out story is SLURM scripts sharding the column
dimension plus post-hoc netCDF combiners (GRTworkflow/run-rfmip-irf.sh:
102-125, GRTworkflow/combiner.py).  Here a 2-D DeviceMesh of ranks splits
the columns, which are embarrassingly parallel, and each band's spectral
grid, whose per-block integrals are gathered and summed in block order;
:mod:`.distributed` adds the per-node segments.  Importing this package
starts no process group.
"""
from .mesh import make_mesh
from .clear_sky import ClearSkyRT

__all__ = ["make_mesh", "ClearSkyRT"]
