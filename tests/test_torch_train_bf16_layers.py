"""PyTorch port, training in bfloat16, the layers' backward against the JAX
package's, run op by op on the CPU, where the two round differently:

- `leaky_relu` under autograd is JAX's where(x >= 0, x, slope * x): its
  derivative at x = 0 is 1, where torch's leaky_relu takes the slope. A
  bfloat16 sum cancels to exactly 0 often enough to matter (a fault of the
  port, repaired): the gradient equals JAX's bit for bit in bfloat16 and
  float32, zeros included, and the forward is torch's leaky_relu's.
- Known difference: a bias's gradient (autodiff reduces the broadcast in
  bfloat16). XLA op by op on the CPU adds the bfloat16 cotangents in
  bfloat16, rounding as it goes; torch accumulates in float32 and rounds
  once. The port's is the exact sum rounded once, more than twice as close
  to the exact sum than JAX's, and equals JAX's once JAX's sums accumulate
  in float32 (`jax_reductions_in_float32`).
- Known difference: LayerNorm's input gradient. flax casts a bfloat16 x to
  float32 twice (for the statistics, for x - mean), and the transposes of
  the casts round two nearly cancelling parts of the gradient before their
  sum; torch rounds the sum once. With `flax_layer_norm_rounds_once` JAX's
  equals the port's, and the port's is the closer to float32.
"""

from __future__ import annotations

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu_torch.nets.common import LayerNorm, leaky_relu
from tests.torch_port_helpers import (flax_layer_norm_rounds_once, frob,
                                      jax_reductions_in_float32, t)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("slope", [0.01, 0.1])
def test_leaky_relu_gradient_matches_jax_at_zero(dtype, slope):
    rs = np.random.RandomState(0)
    x = rs.randn(64).astype(np.float32)
    x[::5] = 0.0  # exact zeros, as a cancelling bfloat16 sum gives
    c = rs.randn(64).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with jax.disable_jit():
        ref_out, vjp = jax.vjp(lambda a: jax.nn.leaky_relu(a, slope), jnp.asarray(x).astype(jdt))
        ref = vjp(jnp.asarray(c).astype(jdt))[0]
    xt = t(x).to(tdt).requires_grad_(True)
    out = leaky_relu(xt, slope)
    out.backward(t(c).to(tdt))
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(ref_out.astype(jnp.float32)))
    np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    assert np.array_equal(xt.grad.float().numpy()[::5], t(c).to(tdt).float().numpy()[::5])
    with torch.no_grad():  # serving: torch's leaky_relu, the same values
        np.testing.assert_array_equal(leaky_relu(xt, slope).float().numpy(),
                                      out.detach().float().numpy())


def _bias_grads(c):
    """d/db of sum(c * (y + b)) with b cast to bfloat16, JAX op by op."""
    with jax.disable_jit():
        return np.asarray(jax.grad(lambda b: jnp.sum(
            c * (jnp.zeros(c.shape, jnp.bfloat16) + b.astype(jnp.bfloat16)).astype(jnp.float32))
        )(jnp.zeros(c.shape[-1])))


def test_bias_gradient_known_difference(monkeypatch):
    c = np.random.RandomState(1).randn(96, 32).astype(np.float32)
    cb = torch.from_numpy(c).bfloat16()
    b = torch.zeros(32, requires_grad=True)
    (torch.zeros(96, 32, dtype=torch.bfloat16) + b.bfloat16()).float().mul(t(c)).sum().backward()
    port = b.grad.numpy()
    exact = cb.float().sum(0).numpy()
    ours = _bias_grads(c)
    np.testing.assert_array_equal(port, torch.from_numpy(exact).bfloat16().float().numpy())
    print(f"|port-exact| {frob(port - exact):.4g}, |jax-exact| {frob(ours - exact):.4g}")
    assert frob(port - exact) < frob(ours - exact) / 2
    jax_reductions_in_float32(monkeypatch)
    np.testing.assert_array_equal(_bias_grads(c), port)


def _layer_norm_input_grad(x, c, dtype):
    ln = flax_nn.LayerNorm(epsilon=1e-5, dtype=dtype)
    params = {"params": {"scale": jnp.asarray(np.linspace(0.5, 1.5, x.shape[-1], dtype=np.float32)),
                         "bias": jnp.zeros(x.shape[-1])}}
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda a: ln.apply(params, a), jnp.asarray(x).astype(dtype or jnp.float32))
        return np.asarray(vjp(jnp.asarray(c).astype(dtype or jnp.float32))[0].astype(jnp.float32))


def test_layer_norm_input_gradient_known_difference(monkeypatch):
    rs = np.random.RandomState(2)
    x = (rs.randn(64, 32) * 3 + 1).astype(np.float32)
    x = torch.from_numpy(x).bfloat16().float().numpy()  # bfloat16 values
    c = rs.randn(64, 32).astype(np.float32)
    ln = LayerNorm(32, eps=1e-5, dtype=torch.bfloat16)
    with torch.no_grad():
        ln.weight.copy_(torch.linspace(0.5, 1.5, 32))
    xt = t(x).bfloat16().requires_grad_(True)
    ln(xt).backward(t(c).bfloat16())
    port = xt.grad.float().numpy()
    ref32 = _layer_norm_input_grad(x, c, None)
    twice = _layer_norm_input_grad(x, c, jnp.bfloat16)
    flax_layer_norm_rounds_once(monkeypatch)
    once = _layer_norm_input_grad(x, c, jnp.bfloat16)
    print(f"|port-jax| {frob(port - twice):.4g}, |port-jax once| {frob(port - once):.4g}, "
          f"|jax-f32| {frob(twice - ref32):.4g}, |port-f32| {frob(port - ref32):.4g}")
    assert frob(port - once) < frob(port - twice) / 10
    assert frob(port - ref32) < frob(twice - ref32)
