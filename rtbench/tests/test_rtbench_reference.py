"""The plain reference against the port's RadiationDriver.run on the CPU
(the port's plain kernels) at a small cut: line_sample at LW 0.8, the bin
method at LW 0.08 streamed in blocks, a masked full batch and a call with
day compaction, each held to the limits of the benchmark's first cell."""
import numpy as np
import pytest

from rtbench import check, deployment, program
from rtbench.reference import rt
from rtbench.spec import Spec

from ._files import config

CUT = {"line_shrink": 256, "grid_coarsen": 8, "sites": 6, "experiments": 2}


def _gaps(name, columns, spectral_chunks):
    dep = deployment.build(dict(config(name), smoke=CUT), 31, smoke=True)
    expts, sites, mu = (np.array(v) for v in zip(*columns))
    cols = dep.columns(expts, sites, mu)
    driver = program.build_driver(dep, "cpu")
    out = program.call(driver, program.atmosphere(cols), spectral_chunks)
    tips = rt.PartitionSums()
    pairs = [({k: v[j] for k, v in out.items()},
              rt.column_fluxes(dep, dep.column(expts[j], sites[j], mu[j]),
                               tips=tips))
             for j in range(len(mu))]
    return check.gaps(pairs), pairs


@pytest.mark.parametrize("name,columns,chunks", [
    # 5 of 6 lit: the lit bucket is the batch, one masked step.
    ("rfmip_irf",
     [(0, s, m) for s, m in enumerate((0.9, 0.7, 0.1, -0.3, 0.5, 0.2))], 1),
    # 1 of 3 lit: day compaction, a lit bucket of 1 and a night one of 2.
    ("rfmip_irf", [(1, 4, -0.2), (0, 2, 0.8), (1, 0, -0.9)], 1),
    # The bin method, streamed in 3 blocks, 2 of 3 lit (masked).
    ("rfmip_irf_fine", [(0, 1, 0.85), (1, 3, -0.5), (1, 5, 0.3)], 3),
])
def test_reference_agrees_with_the_port(name, columns, chunks):
    gaps, pairs = _gaps(name, columns, chunks)
    spec = Spec()
    ok, table = check.judge(gaps, spec.limits(
        spec.data["workloads"][0]["name"]))
    assert ok, table
    for prog, ref in pairs:
        assert np.all(ref["rlu"] > 0)
    night = [p for (_, _, m), p in zip(columns, pairs) if m <= 0]
    for prog, ref in night:
        assert np.all(ref["rsd"] == 0) and np.all(prog["rsd"] == 0)
