"""PyTorch port, the sampler: models/cnf.py, samplers/ode.py and
models/flow_matching.py held against the JAX package, at small widths of the
two flagship variants (tests/torch_port_helpers.py).

The JAX sampler is run op by op (`jax.disable_jit`), which executes its
source's float32 arithmetic as written. Compiled, XLA folds the midpoint
stage time 1.0 + k*dt + 0.5*dt into k*dt + 0.99 and rounds some of those
times one ulp away, and the cosine embedding's e^31 frequency turns one ulp
of t into a different embedding (ROADMAP Queue 3). With the non-chaotic
sincos embedding the compiled JAX sampler is held as well.

Tolerances: vector field atol 1e-5; `sample` atol 1e-4 (measured maximum
error 4.8e-7 with the cosine embedding op by op, every solver, with and
without guidance).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.samplers import ode as jode
from particle_fm_tpu_torch.samplers import ode as pode
from tests.torch_port_helpers import (GRAFT_FLAGSHIP, YAML_FLAGSHIP, cloud, jax_noise,
                                      model_pair, t)

VARIANTS = {"yaml": YAML_FLAGSHIP, "graft": GRAFT_FLAGSHIP}


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    return model_pair(VARIANTS[request.param])


def test_vector_field_matches_jax(pair):
    jm, variables, pm, net = pair
    x, mask, cond, ts = cloud(seed=1)
    ref = np.asarray(jm.vector_field(variables, jnp.asarray(ts), jnp.asarray(x),
                                     cond=jnp.asarray(cond), mask=jnp.asarray(mask)))
    with torch.no_grad():
        out = pm.vector_field(net, t(ts), t(x), t(cond), t(mask))
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
        pm.fold_weight_norm(net)  # folded: the EPiC layers run the fused layer's plain version
        try:
            out = pm.vector_field(net, t(ts), t(x), t(cond), t(mask))
        finally:
            pm.unfold_weight_norm(net)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    assert (out.numpy()[mask[..., 0] == 0] == 0).all()


@pytest.mark.parametrize("ode_steps", [2, 6, 51, 100])
def test_time_grid_bit_identical(ode_steps):
    """t_k = t0 + f32(k) * dt and t_k + 0.5*dt in float32, as samplers/ode.py
    computes them (ode.py:39, :80), mirrored in numpy."""
    n = ode_steps - 1
    dt = (0.0 - 1.0) / n
    want = np.float32(1.0) + np.arange(n, dtype=np.float32) * np.float32(dt)
    want_half = want + np.float32(0.5 * dt)
    seen = []
    pode.odeint_fixed(lambda tt, x: seen.append(tt.clone()) or x, torch.zeros(1),
                      1.0, 0.0, ode_steps, "midpoint")
    got = torch.stack(seen).numpy()
    np.testing.assert_array_equal(got[0::2], want)
    np.testing.assert_array_equal(got[1::2], want_half)
    ts, pdt = pode.time_grid(1.0, 0.0, ode_steps)
    np.testing.assert_array_equal(ts.numpy(), want)
    assert pdt == dt


@pytest.mark.parametrize("method", ["euler", "midpoint", "heun", "rk4", "ab2", "ab3"])
def test_odeint_fixed_matches_jax_on_linear_drift(method):
    a = np.linspace(-1.0, 1.0, 6).astype(np.float32)
    drift_j = lambda tt, x: -jnp.asarray(a) * x + tt
    drift_p = lambda tt, x: -t(a) * x + tt
    x0 = np.ones(6, np.float32)
    with jax.disable_jit():
        ref = np.asarray(jode.odeint_fixed(drift_j, jnp.asarray(x0), 1.0, 0.0, 8, method))
    out = pode.odeint_fixed(drift_p, t(x0), 1.0, 0.0, 8, method).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_sample_matches_compiled_jax_with_sincos():
    jm, variables, pm, net = model_pair(dict(YAML_FLAGSHIP, t_emb="sincos", frequencies=6))
    _, mask, cond, _ = cloud(b=3, seed=3)
    seed = 11
    ref = np.asarray(jm.sample(variables, jax.random.PRNGKey(seed), cond=jnp.asarray(cond),
                               mask=jnp.asarray(mask), ode_solver="midpoint", ode_steps=6))
    out = pm.integrate(net, t(jax_noise(seed, ref.shape, mask)), t(cond), t(mask),
                       "midpoint", 6).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_unported_options_raise():
    from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel

    with pytest.raises(NotImplementedError):  # bfloat16 is ported, float16 is not
        FlowMatchingModel(dtype="float16")
    pm = FlowMatchingModel(hidden_dim=8, latent=4, layers=1)
    net = pm.init(device="cpu")
    with pytest.raises(NotImplementedError, match="rk45"):
        pm.integrate(net, torch.zeros(1, 4, 3), ode_solver="rk45")
