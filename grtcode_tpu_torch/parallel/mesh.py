"""The (columns x spectral) mesh of ranks (port of
grtcode_tpu/parallel/mesh.py).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group, one rank per device, with the dimension names
below.  Columns are the embarrassingly parallel batch axis (the
reference's per-node ``-x/-X`` slices, GRTworkflow/run-rfmip-irf.sh:
120-122); spectral ranks each compute one contiguous block of every
band's wavenumber grid.
"""
from __future__ import annotations

COLUMNS_AXIS = "columns"
SPECTRAL_AXIS = "spectral"


def make_mesh(n_columns: int | None = None, n_spectral: int = 1,
              devices=None, *, device_type: str = "cuda"):
    """A 2-D (``n_columns`` x ``n_spectral``) DeviceMesh with dimension
    names ("columns", "spectral"): rank ``devices[c * n_spectral + s]``
    holds coordinate (c, s).

    Args:
      n_columns: size of the columns axis; defaults to
        ``len(devices) // n_spectral``.
      n_spectral: size of the spectral axis.
      devices: the ranks, one per device (defaults to every rank of the
        default process group, which must be initialised).  C x S must
        equal their number.
      device_type: the ranks' device type, "cuda" (the default) or "cpu".
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "grtcode_tpu_torch.parallel.distributed."
                           "initialize() (or launch under torchrun) first")
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    if n_columns is None:
        n_columns = max(len(ranks) // n_spectral, 1)
    need = n_columns * n_spectral
    if need != len(ranks):
        raise ValueError(
            f"mesh {n_columns}x{n_spectral} needs {need} devices, "
            f"have {len(ranks)}")
    grid = [ranks[c * n_spectral:(c + 1) * n_spectral]
            for c in range(n_columns)]
    return DeviceMesh(device_type, grid,
                      mesh_dim_names=(COLUMNS_AXIS, SPECTRAL_AXIS))
