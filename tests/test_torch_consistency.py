"""PyTorch port, consistency distillation
(particle_fm_tpu_torch/training/consistency.py) held against the JAX package
on the CPU, on a narrow EPiC teacher with the sincos time embedding (the
JAX steps are jitted; see tests/test_torch_samplers_adaptive.py for why the
cosine embedding is not compared under jit):

- `time_grid` equals JAX's exactly; the boundary condition g(y, 0) = y holds
  exactly; the student at initialisation is the teacher's one Euler jump;
- two pinned steps of `distill_consistency` (the warm-up's lr 0, then the
  peak) and of `distill_direct`, with JAX's segments, times and noises
  handed to the port: losses within 1e-6 (relative), the student's and the
  target's parameters within 1e-5;
- `consistency_sample` at 1 and 2 steps given JAX's noise, within 1e-5;
- the guards raise as the JAX package's do (tests/test_consistency.py).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from particle_fm_tpu.training import consistency as jcons
from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel
from particle_fm_tpu_torch.training import consistency as cons
from tests.torch_port_helpers import YAML_FLAGSHIP, cloud, grads_by_name, model_pair, t

SINCOS = dict(YAML_FLAGSHIP, t_emb="sincos", frequencies=2, num_particles=8, hidden_dim=16,
              latent=4)
B = 4


@pytest.fixture(scope="module")
def pair():
    return model_pair(SINCOS, fill=0.1)


@pytest.fixture(scope="module")
def data():
    x, mask, cond, _ = cloud(b=12, n=8, seed=2)
    return x, mask, cond


def test_time_grid_equals_jax():
    for n, t_min in ((8, 0.01), (16, 0.002), (3, 0.5)):
        np.testing.assert_array_equal(cons.time_grid(n, t_min), jcons.time_grid(n, t_min))
    g = cons.time_grid(8, t_min=0.01)
    assert g[0] == 0.0 and g[-1] == 1.0 and len(g) == 9 and np.all(np.diff(g) > 0)


def test_boundary_condition_exact(pair, data):
    _, _, pm, net = pair
    _, mask, cond = data
    y = torch.randn(B, 8, 3, generator=torch.Generator().manual_seed(1)) * t(mask[:B])
    pm.fold_weight_norm(net)
    try:
        out = cons._g(net, torch.zeros(B), y, t(cond[:B]), t(mask[:B]))
    finally:
        pm.unfold_weight_norm(net)
    assert torch.equal(out, y)


def test_student_at_init_is_the_teachers_euler_jump(pair, data):
    _, _, pm, net = pair
    _, mask, cond = data
    m, c = t(mask[:B]), t(cond[:B])
    got = cons.consistency_sample(pm, net, torch.Generator().manual_seed(3), cond=c, mask=m)
    z = torch.randn(B, 8, 3, generator=torch.Generator().manual_seed(3)) * m
    with torch.no_grad():
        v = net(torch.ones(B), z, cond=c, mask=m)
    assert torch.equal(got, (z - v) * m)


def _jax_step_draws(seed, steps, shape, first):
    """Per step, the draws the JAX loop takes from split(PRNGKey(seed)):
    `first` (segments or times) from the step key's first half, then the
    noise from its second."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        out.append((np.asarray(first(k1)), np.asarray(jax.random.normal(k2, shape))))
    return out


def _replay(monkeypatch, draws, name):
    queue = iter(draws)
    pending = []

    def first(_gen, n, _arg, device):
        a, z = next(queue)
        pending.append(z)
        return torch.from_numpy(np.asarray(a)).to(device)

    monkeypatch.setattr(cons, name, first)
    monkeypatch.setattr(cons, "draw_noise", lambda _g, shape, dev: t(pending.pop(0)).to(dev))


def _held(port_net, jax_params):
    want = grads_by_name(jax_params)
    got = {k: v.detach().numpy() for k, v in port_net.state_dict().items()}
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)


KW = dict(steps=2, batch_size=B, lr=1e-2, warmup=1, huber_c=0.15, seed=4)


def test_distill_consistency_steps_match_jax(pair, data, monkeypatch):
    jm, variables, pm, net = pair
    x, mask, cond = data
    ref = jcons.distill_consistency(jm, variables, x, mask=mask, cond=cond, n_grid=4,
                                    target_ema=0.9, **KW)
    draws = _jax_step_draws(4, 2, (B, 8, 3), lambda k: jax.random.randint(k, (B,), 0, 4))
    _replay(monkeypatch, draws, "draw_segments")
    res = cons.distill_consistency(pm, net, x, mask=mask, cond=cond, n_grid=4, target_ema=0.9,
                                   **KW)
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-6)
    _held(res.net, ref.variables["params"])
    _held(res.target_net, ref.target_variables["params"])
    assert not any(torch.equal(a, b) for a, b in zip(res.net.parameters(), net.parameters()))


def test_distill_direct_steps_match_jax(pair, data, monkeypatch):
    jm, variables, pm, net = pair
    x, mask, cond = data
    ref = jcons.distill_direct(jm, variables, x, mask=mask, cond=cond, solver_steps=2, **KW)
    draws = _jax_step_draws(4, 2, (B, 8, 3),
                            lambda k: jax.random.uniform(k, (B,), np.float32, 0.002, 1.0))
    _replay(monkeypatch, draws, "draw_times")
    res = cons.distill_direct(pm, net, x, mask=mask, cond=cond, solver_steps=2, **KW)
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-6)
    _held(res.net, ref.variables["params"])
    assert res.target_net is res.net


@pytest.mark.parametrize("steps", [1, 2])
def test_consistency_sample_matches_jax(pair, data, monkeypatch, steps):
    jm, variables, pm, net = pair
    _, mask, cond = data
    rng = jax.random.PRNGKey(9)
    ref = np.asarray(jcons.consistency_sample(jm, variables, rng, cond=cond[:B],
                                              mask=mask[:B], steps=steps))
    kz, kr = jax.random.split(rng)
    noise = [np.asarray(jax.random.normal(kz, (B, 8, 3)))]
    for _ in range(steps - 1):
        kr, kz2 = jax.random.split(kr)
        noise.append(np.asarray(jax.random.normal(kz2, (B, 8, 3))))
    queue = iter(noise)
    monkeypatch.setattr(cons, "draw_noise", lambda _g, shape, dev: t(next(queue)).to(dev))
    got = cons.consistency_sample(pm, net, torch.Generator(), cond=t(cond[:B]),
                                  mask=t(mask[:B]), steps=steps).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert np.abs(got[mask[:B, :, 0] == 0]).max(initial=0.0) == 0.0


def test_guards(data):
    x, mask, _ = data
    diff = FlowMatchingModel(**dict(SINCOS, loss_type="diffusion"))
    with pytest.raises(ValueError, match="straight-interpolant"):
        cons.consistency_sample(diff, diff.init(device="cpu"), torch.Generator(),
                                mask=t(mask[:2]), steps=1)
    two = dataclasses.replace(FlowMatchingModel(**SINCOS), n_transforms=2)
    with pytest.raises(NotImplementedError, match="n_transforms=1"):
        cons.distill_consistency(two, two.init(device="cpu"), x, steps=1)
    normed = FlowMatchingModel(**dict(SINCOS, use_normaliser=True))
    with pytest.raises(NotImplementedError, match="normalisation"):
        cons.distill_direct(normed, normed.init(device="cpu"), x, steps=1)
