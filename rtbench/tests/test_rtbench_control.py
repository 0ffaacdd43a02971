"""The control, the reference computed in bfloat16 (the nearest precision
below the configurations' float32) in the program's place, fails each
cell's comparison."""
import pytest
import torch

from rtbench import check, deployment
from rtbench.reference import rt
from rtbench.spec import Spec

CUT = {"line_shrink": 256, "grid_coarsen": 8, "sites": 2, "experiments": 1}


@pytest.mark.parametrize("cell", [c["name"]
                                  for c in Spec().data["workloads"]])
def test_the_bfloat16_control_fails(cell):
    spec = Spec()
    cfg = dict(spec.config(spec.workload(cell)["config"]), smoke=CUT)
    dep = deployment.build(cfg, 41, smoke=True)
    tips = rt.PartitionSums()
    pairs = []
    for site, mu in ((0, 0.6), (1, -0.4)):
        col = dep.column(0, site, mu)
        pairs.append((rt.column_fluxes(dep, col, dtype=torch.bfloat16,
                                       tips=tips),
                      rt.column_fluxes(dep, col, tips=tips)))
    ok, table = check.judge(check.gaps(pairs), spec.limits(cell))
    assert not ok, table
