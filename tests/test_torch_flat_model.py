"""PyTorch port, the flat flow-matching model
(particle_fm_tpu_torch/models/flow_matching_flat.py) held against the JAX
package's `FlatFlowMatchingModel` with the JAX parameters carried across:
the flow's field (its own time ladder, arange(1, F+1) * pi), the FM-OT loss
of the chained flows and its gradients with t and the noise pinned, midpoint
sampling from the same z with one and two flows (each flow integrated on its
own, the last first), and log p(x), exact and Hutchinson with the same probe.

Tolerances: field 1e-6; loss 1e-6 relative, gradients 1e-5 of the largest;
samples 1e-4; log p 1e-4 relative.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.models.flow_matching_flat import FlatFlowMatchingModel as JaxFlat
from particle_fm_tpu_torch.models import flow_matching_flat as pflat
from particle_fm_tpu_torch.utils.from_jax import load_flax_params
from tests.torch_port_helpers import grads_by_name, pin_draws, t

F, C = 5, 1


def flat_pair(n_transforms=1, cond_dim=C, seed=0, **kw):
    """(jax model, its variables, port model, port network with the JAX weights)."""
    cfg = dict(features=F, n_transforms=n_transforms, cond_dim=cond_dim, **kw)
    jm = JaxFlat(**cfg)
    variables = jm.init(jax.random.PRNGKey(seed))
    pm = pflat.FlatFlowMatchingModel(**cfg)
    net = load_flax_params(pm.init(seed=seed, device="cpu"), jax.device_get(variables["params"]))
    return jm, variables, pm, net


def batch(b=6, cond_dim=C, seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(b, F) * 2.0 + 0.5).astype(np.float32)
    cond = rs.randn(b, cond_dim).astype(np.float32) if cond_dim else None
    return x, cond, rs.rand(b).astype(np.float32)


def jarr(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("cond_dim,freqs", [(C, 3), (0, 3), (2, 5)])
def test_field_matches_jax(cond_dim, freqs):
    jm, variables, pm, net = flat_pair(cond_dim=cond_dim, freqs=freqs)
    x, cond, ts = batch(cond_dim=cond_dim)
    ref = np.asarray(jm.module.apply(variables, jnp.asarray(ts), jnp.asarray(x), jarr(cond)))
    with torch.no_grad():
        out = net(t(ts), t(x), None if cond is None else t(cond)).numpy()
        scalar = net(torch.tensor(0.3), t(x), None if cond is None else t(cond)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    ref0 = np.asarray(jm.module.apply(variables, jnp.float32(0.3), jnp.asarray(x), jarr(cond)))
    np.testing.assert_allclose(scalar, ref0, atol=1e-6)
    assert np.abs(ref).max() > 0.05
    assert set(net.state_dict()) == {f"flow_0.net.mlp{i}.lin_{j}.{w}" for i in range(1, 5)
                                     for j in range(3) for w in ("weight", "bias")}


@pytest.mark.parametrize("n_transforms", [1, 2])
def test_loss_and_gradients_match_jax(monkeypatch, n_transforms):
    jm, variables, pm, net = flat_pair(n_transforms=n_transforms)
    x, cond, _ = batch(b=8)
    pin_draws(monkeypatch, b=8, shape=x.shape, n_normals=1, steps=2)

    def jloss(params):
        return jm.loss({"params": params}, jax.random.PRNGKey(0), jnp.asarray(x),
                       cond=jnp.asarray(cond), train=True)[0]

    ref, jgrads = jax.value_and_grad(jloss)(variables["params"])
    loss = pm.loss(net, torch.Generator(), t(x), None, t(cond), train=True)
    grads = torch.autograd.grad(loss, list(net.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-6)
    want = grads_by_name(jgrads)
    scale = max(np.abs(g).max() for g in want.values())
    for (name, _), g in zip(net.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), want[name], atol=1e-5 * scale, rtol=0, err_msg=name)
    # the loss normalises by the batch size, and so does accumulation
    assert float(pm.loss_accum_weight(t(x), None)) == 8.0
    # validation draws again: the second pinned pair
    with torch.no_grad():
        val = pm.loss(net, torch.Generator(), t(x), None, t(cond))
    jval = jm.loss(variables, jax.random.PRNGKey(1), jnp.asarray(x), cond=jnp.asarray(cond))[0]
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-6)


@pytest.mark.parametrize("n_transforms", [1, 2])
def test_sample_matches_jax_from_the_same_noise(n_transforms):
    jm, variables, pm, net = flat_pair(n_transforms=n_transforms)
    _, cond, _ = batch(b=7, seed=3)
    ref = np.asarray(jm.sample(variables, jax.random.PRNGKey(4), n_samples=7,
                               cond=jnp.asarray(cond), ode_steps=6))
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (7, F)))
    out = pm.integrate(net, t(z), t(cond), None, "midpoint", 6).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    assert np.abs(out - z).max() > 0.05
    # sample draws z from the generator it is handed, then integrates
    gen = torch.Generator().manual_seed(2)
    drawn = pm.sample(net, gen, cond=t(cond), ode_steps=6)
    z2 = torch.randn((7, F), generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(drawn, pm.integrate(net, z2, t(cond), None, "midpoint", 6),
                               atol=0, rtol=0)
    with pytest.raises(NotImplementedError, match="euler"):
        pm.sample(net, gen, cond=t(cond), ode_solver="euler")


@pytest.mark.parametrize("exact,n_transforms,cond_dim", [(True, 1, C), (True, 2, C),
                                                         (False, 1, C), (True, 1, 0)])
def test_log_prob_matches_jax(exact, n_transforms, cond_dim):
    jm, variables, pm, net = flat_pair(n_transforms=n_transforms, cond_dim=cond_dim)
    x, cond, _ = batch(b=4, cond_dim=cond_dim, seed=5)
    rng = jax.random.PRNGKey(9)
    ref = np.asarray(jm.log_prob(variables, jnp.asarray(x), jarr(cond), ode_steps=5, exact=exact,
                                 rng=rng))
    eps = None if exact else t(np.asarray(jax.random.normal(rng, x.shape)))
    out = pm.log_prob(net, t(x), None if cond is None else t(cond), ode_steps=5, exact=exact,
                      eps=eps).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4)
    with pytest.raises(ValueError, match="ode_steps >= 2"):
        pm.log_prob(net, t(x), None if cond is None else t(cond), ode_steps=1)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pflat.FlatFlowMatchingModel().init()
