"""Multi-process execution: process-sliced columns + per-node segment
output (port of grtcode_tpu/parallel/distributed.py).

The reference scales across nodes embarrassingly: SLURM launches one
process per node with a ``-x/-X`` column slice, each writes its own
netCDF segment, and a combiner merges them afterwards
(GRTworkflow/run-rfmip-irf.sh:102-125, rfmip-irf/src/rfmip-irf.c:121-139).
Here:

  * :func:`initialize` forms the ``torch.distributed`` process group, one
    rank per device; ranks are grouped into nodes of ``LOCAL_WORLD_SIZE``
    ranks (``torchrun`` sets it; one node without it), and the node index
    takes the place of the SLURM array index;
  * each node takes its column slice (:func:`column_slice`) and runs the
    driver on a (columns x spectral) mesh of its own ranks
    (:func:`local_mesh`), so the spectral gathers stay inside a node;
  * one rank per node writes the node's segment file with explicit
    [col_start, col_stop) attributes and an idempotent done-marker
    (:class:`..utils.segments.SegmentManifest`), so a failed node is
    recovered by rerunning only its slice;
  * :func:`combine_column_segments` merges them (the reference's
    extra-tools/grtcode-results-combiner.c, GRTworkflow/combiner.py).
"""
from __future__ import annotations

import datetime
import logging
import os
import re

import numpy as np
import torch

from ..utils.segments import SegmentManifest

log = logging.getLogger("grtcode_tpu_torch")

_rank_device: list = []   # the device initialize() chose for this rank


def ranks_per_node() -> int:
    """Ranks on each node: ``LOCAL_WORLD_SIZE`` (torchrun's), else every
    rank of the group."""
    import torch.distributed as dist
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device=None,
               timeout_s: float = 600.0) -> torch.device:
    """Join the ``torch.distributed`` process group (idempotent) and
    return this rank's device.

    With no ``coordinator_address`` the group comes from torchrun's
    environment (``env://``); otherwise ``coordinator_address`` is an init
    method (``tcp://host:port``, ``file:///path``; a bare ``host:port``
    means TCP) and ``num_processes`` / ``process_id`` are the world size
    and this rank.  ``device="cpu"`` runs the rank on the CPU with the
    gloo backend.  Otherwise the rank runs on ``cuda:LOCAL_RANK`` (modulo
    the GPUs present) with NCCL when each rank of the node has a GPU of
    its own, and with gloo when several ranks share one (NCCL refuses two
    ranks on one GPU).  The choice follows from these inputs alone and is
    logged; nothing falls back.  ``timeout_s`` bounds the start-up and
    every collective.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return _rank_device[0]
    if coordinator_address is None:
        init, kw = "env://", {}
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    else:
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
        world, rank = int(num_processes), int(process_id)
        kw = dict(world_size=world, rank=rank)
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    local_rank = int(os.environ.get("LOCAL_RANK", rank % per_node))
    if device is not None and torch.device(device).type == "cpu":
        dev, backend, why = torch.device("cpu"), "gloo", "CPU ranks"
    else:
        n_gpus = torch.cuda.device_count()
        if n_gpus == 0:
            raise RuntimeError("initialize: no CUDA device (pass "
                               "device='cpu' to run the ranks on the CPU)")
        dev = torch.device("cuda", local_rank % n_gpus)
        torch.cuda.set_device(dev)
        if per_node <= n_gpus:
            backend, why = "nccl", "one GPU per rank"
        else:
            backend, why = "gloo", (f"{per_node} ranks share {n_gpus} "
                                    "GPU(s)")
    if backend == "nccl":
        kw["device_id"] = dev   # binds the communicator to this rank's GPU
    dist.init_process_group(backend, init_method=init,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    log.info("torch.distributed: rank %d of %d on %s, backend %s (%s)",
             rank, world, dev, backend, why)
    _rank_device[:] = [dev]
    return dev


def column_slice(num_columns: int, process_index: int, num_processes: int,
                 x: int = 0, X: int | None = None) -> tuple[int, int]:
    """This process's [start, stop) column range.

    ``x``/``X`` are the reference's inclusive global column bounds
    (rfmip-irf.c:121-139: -x defaults to 0, -X to num_columns-1); the
    selected range then splits near-evenly across processes with the
    remainder going to the lowest process indices (so every process gets
    within one column of the mean — the reference's fixed nodes-sized
    stripes leave the tail node underfilled instead).
    """
    X = num_columns - 1 if X is None else X
    if not (0 <= x <= X < num_columns):
        raise ValueError(f"column slice [{x}, {X}] outside [0, {num_columns})")
    total = X - x + 1
    base, rem = divmod(total, num_processes)
    start = x + process_index * base + min(process_index, rem)
    stop = start + base + (1 if process_index < rem else 0)
    return start, stop


def local_mesh(n_spectral: int = 1):
    """The (columns x spectral) mesh of this node's ranks: the
    ("columns", "spectral") slice of a (nodes x columns x spectral)
    DeviceMesh over every rank, so each node's collectives stay on its
    own ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from .mesh import COLUMNS_AXIS, SPECTRAL_AXIS

    per_node = ranks_per_node()
    if per_node % n_spectral:
        raise ValueError(f"{per_node} ranks per node do not split into "
                         f"{n_spectral} spectral blocks")
    device_type = _rank_device[0].type if _rank_device else "cuda"
    mesh = init_device_mesh(
        device_type, (dist.get_world_size() // per_node,
                      per_node // n_spectral, n_spectral),
        mesh_dim_names=("nodes", COLUMNS_AXIS, SPECTRAL_AXIS))
    return mesh[COLUMNS_AXIS, SPECTRAL_AXIS]


def _node():
    """(this node's index, the number of nodes, whether this rank writes
    the node's output) from the process group; (0, 1, True) without
    one."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return 0, 1, True
    per_node = ranks_per_node()
    rank = dist.get_rank()
    return rank // per_node, dist.get_world_size() // per_node, \
        rank % per_node == 0


def segment_path(out_dir: str, name: str, process_index: int) -> str:
    return os.path.join(out_dir, f"{name}.seg{process_index:05d}.npz")


def write_segment(out_dir: str, name: str, process_index: int,
                  col_start: int, col_stop: int, arrays: dict,
                  manifest: SegmentManifest | None = None) -> str:
    """One per-process segment file: arrays with a leading column axis plus
    the [col_start, col_stop) coverage attrs (era5.c:156-159 contract)."""
    os.makedirs(out_dir, exist_ok=True)
    path = segment_path(out_dir, name, process_index)
    np.savez(path, __col_start=np.int64(col_start),
             __col_stop=np.int64(col_stop),
             **{k: np.asarray(v) for k, v in arrays.items()})
    if manifest is not None:
        manifest.mark_done(f"{name}.seg{process_index:05d}", path,
                           col_start=int(col_start), col_stop=int(col_stop))
    return path


def combine_column_segments(out_dir: str, name: str) -> dict:
    """Merge every segment of ``name`` along the column axis.

    Validates that the segments tile [0, N) without gaps or overlaps
    (the reference combiner trusts the lon_start/lon_stop attrs the same
    way, era5/test/combine-segments.py:26-36).
    """
    pat = re.compile(re.escape(name) + r"\.seg(\d+)\.npz$")
    segs = []
    for fname in sorted(os.listdir(out_dir)):
        if pat.search(fname):
            with np.load(os.path.join(out_dir, fname)) as z:
                segs.append((int(z["__col_start"]), int(z["__col_stop"]),
                             {k: z[k] for k in z.files
                              if not k.startswith("__col_")}))
    if not segs:
        raise FileNotFoundError(f"no segments named {name} in {out_dir}")
    segs.sort(key=lambda s: s[0])
    expect = segs[0][0]
    for start, stop, _ in segs:
        if start != expect:
            raise ValueError(f"segment gap/overlap at column {start} "
                             f"(expected {expect})")
        expect = stop
    keys = segs[0][2].keys()
    return {k: np.concatenate([s[2][k] for s in segs], axis=0)
            for k in keys}


def _segment(out_dir, name, num_columns, n_spectral, process_index,
             num_processes, x, X, compute) -> str:
    """The per-node flow shared by the two entry points: this node's
    column slice, skipped when its done-marker exists, else
    ``compute(start, stop, mesh)`` -> {name: array} on the node's mesh
    (None without a process group), written by one rank per node.  Every
    rank makes the mesh and meets the final barrier whether its node
    skips or not, since both are collective over all ranks."""
    import torch.distributed as dist

    grouped = dist.is_initialized()
    node, nodes, writer = _node()
    pid = node if process_index is None else process_index
    nproc = nodes if num_processes is None else num_processes
    start, stop = column_slice(num_columns, pid, nproc, x=x, X=X)
    mesh = local_mesh(n_spectral) if grouped else None
    manifest = SegmentManifest(out_dir)
    seg_id = f"{name}.seg{pid:05d}"
    if manifest.is_done(seg_id):
        path = manifest.record(seg_id)["output"]
    else:
        arrays = compute(start, stop, mesh)
        path = segment_path(out_dir, name, pid)
        if writer:
            write_segment(out_dir, name, pid, start, stop, arrays,
                          manifest=manifest)
    if grouped:
        dist.barrier()   # every rank returns after the segments exist
    return path


def run_driver_segment(driver, atm, out_dir: str, name: str,
                       n_spectral: int = 1,
                       process_index: int | None = None,
                       num_processes: int | None = None,
                       x: int = 0, X: int | None = None,
                       integrated: bool = True,
                       column_chunk: int | None = None) -> str:
    """The per-node production flow for the full radiation driver: slice
    the Atmosphere -> three-tier run on the node's (columns x spectral)
    mesh -> one segment per node.

    The equivalent of the reference running its binaries per SLURM node
    with -x/-X column bounds (GRTworkflow/run-rfmip-irf.sh:102-125): every
    sky tier, stochastic clouds keyed on global column ids (so their
    realizations do not depend on the layout), spectral surfaces,
    spectral or integrated output.  The segment holds one array per
    (tier, flux) pair; ``combine_column_segments`` merges them into
    exactly the single-process run's bytes.  The segment index is the
    node, not the rank.  Without a process group the process is one node
    of one rank and streams its ``n_spectral`` blocks serially, which is
    the (1 x S) mesh's arithmetic.
    """
    def compute(start, stop, mesh):
        idx = np.arange(start, stop)
        res = driver.run(atm.subset(idx), integrated=integrated, mesh=mesh,
                         column_chunk=column_chunk, col_index=idx,
                         spectral_chunks=None if mesh else n_spectral)
        return {f"{tier}_{var}": d[var].cpu().numpy()
                for tier, d in res.tiers.items() for var in d}

    return _segment(out_dir, name, atm.batch, n_spectral, process_index,
                    num_processes, x, X, compute)


def run_process_segment(model, batch: dict, out_dir: str, name: str,
                        n_spectral: int = 1,
                        process_index: int | None = None,
                        num_processes: int | None = None,
                        x: int = 0, X: int | None = None,
                        integrated: bool = True) -> str:
    """The per-node production flow: slice -> the node's mesh step ->
    segment.

    ``model`` is a ClearSkyRT (or anything with ``.step(mesh,
    integrated)``); ``batch`` holds the global arrays (leading column
    axis), which this helper slices as a node reading only its own slice
    would.  Skips (idempotently) when the segment's done-marker exists.
    """
    num_columns = next(iter(batch.values())).shape[0]

    def compute(start, stop, mesh):
        local = {k: (v[start:stop] if hasattr(v, "shape") and v.shape
                     and v.shape[0] == num_columns else v)
                 for k, v in batch.items()}
        out = model.step(mesh=mesh, integrated=integrated)(local)
        return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in out.items()}

    return _segment(out_dir, name, num_columns, n_spectral, process_index,
                    num_processes, x, X, compute)
