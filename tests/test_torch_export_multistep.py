"""PyTorch port, the served artifact (particle_fm_tpu_torch/serving.py) of
the loops that carry more than the state: ab2 and ab3 (after their
bootstrap steps, the previous fields), on the narrow flagship of
tests/test_torch_export.py (EPiC, 2 layers, B=3, N=16), and the
self-conditioned euler and midpoint loops (the data-endpoint estimate), on
the same network with `self_cond`; each one `while_loop` of one step
(samplers/ode.py::exported_loops). On the CPU the loaded artifact gives what
`make_serve_fn` gives for the same seeds, bit for bit (`torch.equal`), with
cond and mask, batch by batch and through `serve_batches`.

em and ddim: tests/test_torch_export_solvers.py; DOPRI5:
tests/test_torch_export_adaptive.py; on the card:
tests/test_torch_export_cuda.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from particle_fm_tpu_torch import serving as pserving
from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel
from tests.torch_port_helpers import YAML_FLAGSHIP, cloud

BS, N, STEPS = 3, 16, 5
MEANS = np.array([0.1, -0.2, 0.3], np.float32)
STDS = np.array([1.5, 0.5, 2.0], np.float32)
CASES = {  # name: (model, solver)
    "ab2": ("flagship", "ab2"),
    "ab3": ("flagship", "ab3"),
    "self_cond_euler": ("self_cond", "euler"),
    "self_cond_midpoint": ("self_cond", "midpoint"),
}


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, cfg, seed in (("flagship", YAML_FLAGSHIP, 1),
                            ("self_cond", dict(YAML_FLAGSHIP, self_cond=True), 2)):
        pm = FlowMatchingModel(**cfg)
        out[name] = (pm, pm.init(seed=seed, device="cpu"))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_artifact_is_make_serve_fn_bit_for_bit(models, case, tmp_path):
    model, solver = CASES[case]
    pm, net = models[model]
    _, meta = pserving.export_sampler(
        pm, net, batch_size=BS, num_points=N, features=3, cond_dim=2, use_mask=True,
        ode_solver=solver, ode_steps=STEPS, means=MEANS, stds=STDS, device="cpu",
        out_dir=str(tmp_path))
    fn, loaded = pserving.load_exported(str(tmp_path))
    assert loaded == meta and meta["ode_solver"] == solver and "step_noise" not in meta
    live = pserving.make_serve_fn(pm, net, batch_size=BS, ode_solver=solver, ode_steps=STEPS,
                                  has_cond=True, has_mask=True, means=MEANS, stds=STDS)
    _, m, c, _ = cloud(b=5, n=N, seed=1)
    for seed in (0, 7, 2**40 + 3):
        got, want = fn(seed, c[:BS], m[:BS]), live(seed, c[:BS], m[:BS])
        assert got.shape == (BS, N, 3) and torch.equal(got, want), seed
        assert bool(torch.isfinite(got).all())
    kw = dict(cond=c, mask=m, seed=11)
    np.testing.assert_array_equal(pserving.serve_batches(fn, meta, 5, **kw),
                                  pserving.serve_batches(live, live.meta, 5, **kw))
