"""PyTorch port, `FlowMatchingModel.sample` held against the JAX sampler with
the same noise z, at small widths of the two flagship variants, for
midpoint, euler and rk4, with and without classifier-free guidance, on
ragged masks.

The JAX sampler runs op by op (`jax.disable_jit`); see
tests/test_torch_port_sampler.py for why. Tolerance: atol 1e-4 (measured
maximum error 4.8e-7).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import GRAFT_FLAGSHIP, YAML_FLAGSHIP, cloud, jax_noise, model_pair, t

VARIANTS = {"yaml": YAML_FLAGSHIP, "graft": GRAFT_FLAGSHIP}


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    return model_pair(VARIANTS[request.param])


@pytest.mark.parametrize(
    "solver,guidance", [("midpoint", None), ("midpoint", 1.5), ("euler", None), ("rk4", 2.0)]
)
def test_sample_matches_jax(pair, solver, guidance):
    jm, variables, pm, net = pair
    _, mask, cond, _ = cloud(b=3, seed=2)
    seed = 7
    with jax.disable_jit():
        ref = np.asarray(jm.sample(variables, jax.random.PRNGKey(seed), cond=jnp.asarray(cond),
                                   mask=jnp.asarray(mask), ode_solver=solver, ode_steps=3,
                                   guidance_scale=guidance))
    z = jax_noise(seed, ref.shape, mask)
    out = pm.integrate(net, t(z), t(cond), t(mask), solver, 3, guidance).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    assert (out[mask[..., 0] == 0] == 0).all()
    assert not any(layer._kernel_weights is not None for layer in net.flows[0].net.layers())


def test_sample_draws_masked_noise_from_generator(pair):
    _, _, pm, net = pair
    _, mask, cond, _ = cloud(b=2, seed=4)
    run = lambda s: pm.sample(net, torch.Generator().manual_seed(s), cond=t(cond),
                              mask=t(mask), ode_steps=2)
    a, b, c = run(0), run(0), run(1)
    assert a.shape == (2, 16, 3) and torch.equal(a, b) and not torch.equal(a, c)
    assert (a.numpy()[mask[..., 0] == 0] == 0).all()
