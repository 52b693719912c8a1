"""PyTorch port, `FlowMatchingModel.log_prob` held against the JAX package
on the CPU: the exact trace (`torch.func.jacfwd` under `vmap`) and
Hutchinson's estimator with the JAX package's e handed in, on EPiC at a
small width with the sincos time embedding (the compiled JAX function is
the reference; see tests/test_torch_samplers_adaptive.py for why the cosine
embedding is not), for FM-OT, for diffusion's probability-flow drift and
for two flow transforms; and the guards that raise where the JAX function
raises.

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
    _, port_cfg = droid_configs(port_mha={"attn_impl": "packed"})["transformer"]
    droid = FlowMatchingModel(**port_cfg)
    with pytest.raises(NotImplementedError, match="packed"):
        droid.log_prob(droid.init(device="cpu"), torch.zeros(1, 16, 3))
