"""PyTorch port, the served artifact's loops (samplers/ode.py::
exported_loops): for every solver with a step count (the one-step steppers,
the Adams loops, the self-conditioned loops, em and ddim) the exported
program (serving.py::export_sampler) holds one `while_loop` and as many
graph nodes at 30 steps as at 5: one step's graph, whatever the steps. 5 is
the least count that runs every loop (below 4 steps the Adams bootstraps
return before it). The narrow flagship of tests/test_torch_export.py
(EPiC, 2 layers, B=3, N=16) and a narrow configs/model/diffusion.yaml, on
the CPU.
"""

from __future__ import annotations

import pytest
import torch

from particle_fm_tpu_torch import serving as pserving
from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel
from tests.torch_port_helpers import YAML_FLAGSHIP

CASES = {  # name: (model changes, solver)
    "euler": ({}, "euler"),
    "rk4": ({}, "rk4"),
    "ab2": ({}, "ab2"),
    "ab3": ({}, "ab3"),
    "self_cond_euler": ({"self_cond": True}, "euler"),
    "self_cond_midpoint": ({"self_cond": True}, "midpoint"),
    "em": ({"loss_type": "diffusion", "diff_config": {"max_sr": 0.999, "min_sr": 0.02}}, "em"),
    "ddim": ({"loss_type": "diffusion", "diff_config": {"max_sr": 0.999, "min_sr": 0.02}},
             "ddim"),
}


def _nodes(exported) -> tuple[int, int]:
    """(nodes of the program, its loop's graphs included; while_loop calls)."""
    total = loops = 0
    for gm in exported.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:
                total += 1
                loops += node.op == "call_function" and "while_loop" in str(node.target)
    return total, loops


@pytest.mark.parametrize("case", list(CASES))
def test_graph_does_not_grow_with_the_steps(case):
    changes, solver = CASES[case]
    pm = FlowMatchingModel(**dict(YAML_FLAGSHIP, **changes))
    net = pm.init(seed=0, device="cpu")

    def nodes(steps):
        exported, _ = pserving.export_sampler(
            pm, net, batch_size=3, num_points=16, features=3, cond_dim=2, ode_solver=solver,
            ode_steps=steps, device="cpu")
        return _nodes(exported)

    at5 = nodes(5)
    assert at5 == nodes(30) and at5[1] == 1
