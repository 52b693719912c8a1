"""PyTorch port, the served artifact (particle_fm_tpu_torch/serving.py) of
the diffusion samplers, em and ddim, on a narrow configs/model/diffusion.yaml
(EPiC, 2 layers, B=3, N=16, as the flagship of tests/test_torch_export.py);
each one `while_loop` of one step (samplers/ode.py::exported_loops). On the
CPU:

- the loaded artifact gives what `make_serve_fn` gives for the same seeds,
  bit for bit (`torch.equal`), with cond and mask; em also with guidance,
  and with two flows (each its slice of the step noise, the last flow's
  first, as the live sampler draws them);
- the em artifact, given the JAX package's prior and per-step noise (its
  draw function replaced by JAX's stream), holds against the JAX package's
  `make_serve_fn`/`serve_batches` run op by op, atol 1e-4 in physical units;
- an em artifact's meta.yaml has the JAX package's keys with the same values,
  `noise`, and `step_noise` (the program's second input).

The Adams and self-conditioned loops: tests/test_torch_export_multistep.py;
the DOPRI5 artifacts: tests/test_torch_export_adaptive.py; the graphs at 5
and 30 steps: tests/test_torch_export_graphs.py. On the card:
tests/test_torch_export_cuda.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu import serving as jserving
from particle_fm_tpu_torch import serving as pserving
from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel
from tests.torch_port_helpers import (YAML_FLAGSHIP, cloud, jax_noise, jax_sde_noise, model_pair,
                                      t)

BS, N, STEPS = 3, 16, 5
MEANS = np.array([0.1, -0.2, 0.3], np.float32)
STDS = np.array([1.5, 0.5, 2.0], np.float32)
DIFFUSION = dict(YAML_FLAGSHIP, loss_type="diffusion", criterion="huber",
                 diff_config={"max_sr": 0.999, "min_sr": 0.02})
CASES = {  # name: (model, solver, guidance_scale)
    "em": ("diffusion", "em", None),
    "em_guidance": ("diffusion", "em", 2.0),
    "em_two_flows": ("diffusion_two_flows", "em", None),
    "ddim": ("diffusion", "ddim", None),
}


@pytest.fixture(scope="module")
def models():
    """{name: (port model, network)}; the diffusion pair's JAX side under
    "jax_diffusion"."""
    jm, variables, pm, net = model_pair(DIFFUSION, fill=True)
    out = {"diffusion": (pm, net), "jax_diffusion": (jm, variables)}
    pm = FlowMatchingModel(**dict(DIFFUSION, n_transforms=2))
    out["diffusion_two_flows"] = (pm, pm.init(seed=3, device="cpu"))
    return out


def _export(models, case, steps=STEPS, out_dir=None):
    model, solver, guidance = CASES[case]
    pm, net = models[model]
    return pserving.export_sampler(
        pm, net, batch_size=BS, num_points=N, features=3, cond_dim=2, use_mask=True,
        ode_solver=solver, ode_steps=steps, means=MEANS, stds=STDS, guidance_scale=guidance,
        device="cpu", out_dir=out_dir)


@pytest.fixture(scope="module")
def artifacts(models, tmp_path_factory):
    """case -> (meta, (fn, meta) of load_exported), each exported and loaded
    once."""
    cache = {}

    def get(case):
        if case not in cache:
            out = tmp_path_factory.mktemp(case)
            _, meta = _export(models, case, out_dir=str(out))
            cache[case] = (meta, pserving.load_exported(str(out)))
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_artifact_is_make_serve_fn_bit_for_bit(models, artifacts, case):
    model, solver, guidance = CASES[case]
    pm, net = models[model]
    meta, (fn, loaded) = artifacts(case)
    assert loaded == meta and meta["ode_solver"] == solver
    live = pserving.make_serve_fn(pm, net, batch_size=BS, ode_solver=solver, ode_steps=STEPS,
                                  has_cond=True, has_mask=True, means=MEANS, stds=STDS,
                                  guidance_scale=guidance)
    _, m, c, _ = cloud(b=5, n=N, seed=1)
    for seed in (0, 7, 2**40 + 3):
        got, want = fn(seed, c[:BS], m[:BS]), live(seed, c[:BS], m[:BS])
        assert got.shape == (BS, N, 3) and torch.equal(got, want), seed
        assert bool(torch.isfinite(got).all())
    kw = dict(cond=c, mask=m, seed=11)
    np.testing.assert_array_equal(pserving.serve_batches(fn, meta, 5, **kw),
                                  pserving.serve_batches(live, live.meta, 5, **kw))


def test_em_artifact_matches_jax_given_the_same_noise(models, artifacts, monkeypatch):
    jm, variables = models["jax_diffusion"]
    _, mask, cond, _ = cloud(b=BS, n=N, seed=5)
    proto = dict(batch_size=BS, ode_solver="em", ode_steps=STEPS, has_cond=True, has_mask=True,
                 means=MEANS, stds=STDS, normalize_sigma=5.0)
    jfn = jserving.make_serve_fn(jm, variables, **proto)
    meta = {"batch_size": BS, "cond_dim": 2, "use_mask": True, "seed_scheme": "hash_v1"}
    with jax.disable_jit():
        ref = jserving.serve_batches(lambda s, c, m: jfn(jnp.uint32(s), c, m), meta, BS,
                                     cond=cond, mask=mask, seed=3)
    pmeta, (fn, _) = artifacts("em")
    seeds = []

    def noise_from_jax(seed, shape, n_steps, device):
        seeds.append(seed)
        eps = np.stack(jax_sde_noise(seed, shape, n_steps))
        return t(jax_noise(seed, shape)).to(device), t(eps).to(device)

    monkeypatch.setattr(pserving, "sde_noise", noise_from_jax)
    out = pserving.serve_batches(fn, pmeta, BS, cond=cond, mask=mask, seed=3)
    assert out.shape == ref.shape == (BS, N, 3)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, atol=1e-4)
    assert (out[mask[..., 0] == 0] == 0).all()
    assert seeds == [pserving.chunk_seed(3, 0)]


def test_em_meta_has_the_jax_keys_and_the_step_noise(models, artifacts):
    jm, variables = models["jax_diffusion"]
    pmeta, _ = artifacts("em")
    _, jmeta = jserving.export_sampler(
        jm, variables, batch_size=BS, num_points=N, features=3, cond_dim=2, use_mask=True,
        ode_solver="em", ode_steps=STEPS, means=MEANS, stds=STDS)
    assert set(pmeta) - set(jmeta) == {"noise", "step_noise"}
    assert {k: pmeta[k] for k in jmeta} == jmeta
    assert pmeta["noise"] == {"shape": [BS, N, 3], "draw": pserving.NOISE}
    assert pmeta["step_noise"] == {"shape": [STEPS, BS, N, 3], "draw": pserving.STEP_NOISE}
    ddim_meta, _ = artifacts("ddim")
    assert "step_noise" not in ddim_meta
