"""PyTorch port, `FlowMatchingModel.log_prob` held against the JAX package
on the CPU: the exact trace (`torch.func.jacfwd` under `vmap`) and
Hutchinson's estimator with the JAX package's e handed in, on EPiC at a
small width with the sincos time embedding (the compiled JAX function is
the reference; see tests/test_torch_samplers_adaptive.py for why the cosine
embedding is not), for FM-OT, for diffusion's probability-flow drift and
for two flow transforms; the narrow droid transformer with a kernel
`attn_impl` on the CPU, where no kernel runs (`packed`: the einsum path in
both packages; `fused`, `flash`: JAX's Pallas kernels refuse the CPU outside
interpret mode, the port runs their plain versions, a known difference); and
the guards that raise where the JAX function raises. On the card, log_prob
raises where an attention kernel would launch: tests/test_torch_train_cuda.py.

Tolerance: log_prob rtol 1e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import YAML_FLAGSHIP, cloud, droid_configs, model_pair, t

SINCOS = dict(YAML_FLAGSHIP, t_emb="sincos", frequencies=2, num_particles=8)
MODELS = {
    "fm": SINCOS,
    "diffusion": dict(SINCOS, loss_type="diffusion", criterion="huber",
                      diff_config={"max_sr": 0.999, "min_sr": 0.02}),
    "two flows": dict(SINCOS, n_transforms=2),
}


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    return model_pair(MODELS[request.param], fill=0.1)


@pytest.mark.parametrize("exact", [True, False])
def test_log_prob_matches_jax(pair, exact):
    jm, variables, pm, net = pair
    x, mask, cond, _ = cloud(b=3, n=8, seed=4)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jm.log_prob(variables, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(mask),
                                 ode_steps=6, exact=exact, rng=key))
    eps = None if exact else t(np.asarray(jax.random.normal(key, x.shape)))
    out = pm.log_prob(net, t(x), t(cond), t(mask), ode_steps=6, exact=exact, eps=eps).numpy()
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(out, ref, rtol=1e-4)


def test_hutchinson_draws_from_the_generator_and_averages_to_the_trace():
    jm, variables, pm, net = model_pair(SINCOS, fill=0.1)
    x, _, cond, _ = cloud(b=2, n=8, seed=1)
    x = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    run = lambda s: pm.log_prob(net, t(x), t(cond), ode_steps=4, exact=False,
                                generator=torch.Generator().manual_seed(s))
    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))
    exact = pm.log_prob(net, t(x), t(cond), ode_steps=4)
    mean = torch.stack([run(s) for s in range(64)]).mean(0)
    ref = np.asarray(jm.log_prob(variables, jnp.asarray(x), jnp.asarray(cond), ode_steps=4))
    np.testing.assert_allclose(exact.numpy(), ref, rtol=1e-4)  # no mask: dims from the shape
    assert torch.allclose(mean, exact, rtol=2e-2)


def test_log_prob_guards():
    from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel

    small = dict(hidden_dim=8, latent=4, layers=1, num_particles=4)
    x = torch.zeros(1, 4, 3)
    for cfg, error, match in (
        (dict(loss_type="droid", droid_t_max=25.0), NotImplementedError, "VE prior"),
        (dict(self_cond=True), NotImplementedError, "self_cond"),
    ):
        fm = FlowMatchingModel(**small, **cfg)
        with pytest.raises(error, match=match):
            fm.log_prob(fm.init(device="cpu"), x)
    fm = FlowMatchingModel(**small)
    net = fm.init(device="cpu")
    fm.fold_weight_norm(net)
    with pytest.raises(RuntimeError, match="unfolded"):
        fm.log_prob(net, x)
    fm.unfold_weight_norm(net)
    assert torch.isfinite(fm.log_prob(net, x, ode_steps=3)).all()


def _droid_configs(impl: str):
    """(JAX config with `attn_impl=impl`, JAX config on the einsum path, port
    config with `attn_impl=impl`) of the narrow droid transformer, with the
    sincos time embedding (see the module's note on the cosine one)."""
    with_impl = droid_configs(jax_mha={"attn_impl": impl}, port_mha={"attn_impl": impl},
                              t_emb="sincos")["transformer"]
    return with_impl[0], droid_configs(t_emb="sincos")["transformer"][0], with_impl[1]


def _droid_pair(impl: str):
    """The JAX model with `attn_impl=impl`, the JAX weights of the same network
    (initialised on the einsum path, which every impl shares: the attention
    has no parameters), the port's model and network with `attn_impl=impl`,
    and the JAX model on the einsum path."""
    jax_impl, jax_einsum, port_cfg = _droid_configs(impl)
    jm, variables, pm, net = model_pair(jax_einsum, port_cfg=port_cfg, fill=0.1)
    return type(jm)(**jax_impl), variables, pm, net, jm


def _jax_log_prob(jm, variables, x, mask, cond):
    return np.asarray(jm.log_prob(variables, jnp.asarray(x), jnp.asarray(cond),
                                  jnp.asarray(mask), ode_steps=4, exact=True))


def test_log_prob_with_packed_attention_matches_jax_on_the_cpu():
    """attn_impl="packed" on CPU tensors: both dispatchers take the einsum
    path (no kernel runs), and log_prob computes in both packages."""
    jm, variables, pm, net, _ = _droid_pair("packed")
    x, mask, cond, _ = cloud(b=2, n=16, seed=4)
    ref = _jax_log_prob(jm, variables, x, mask, cond)
    out = pm.log_prob(net, t(x), t(cond), t(mask), ode_steps=4, exact=True).numpy()
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(out, ref, rtol=1e-4)


@pytest.mark.parametrize("impl", ["fused", "flash"])
def test_log_prob_with_fused_or_flash_attention_on_the_cpu_known_difference(impl):
    """The JAX dispatcher calls the Pallas kernels for these whatever the
    backend, without interpret mode, and JAX's log_prob raises a ValueError
    on the CPU (its forward-mode pass through the kernel's call fails; a
    plain forward pass fails too: Pallas runs on the CPU only in interpret
    mode). The port runs the kernels' plain versions for CPU tensors, so its
    log_prob computes, and agrees with JAX's log_prob of the same network on
    the einsum path."""
    jm, variables, pm, net, jm_einsum = _droid_pair(impl)
    x, mask, cond, _ = cloud(b=2, n=16, seed=4)
    with pytest.raises(ValueError):
        _jax_log_prob(jm, variables, x, mask, cond)
    ref = _jax_log_prob(jm_einsum, variables, x, mask, cond)
    out = pm.log_prob(net, t(x), t(cond), t(mask), ode_steps=4, exact=True).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4)
