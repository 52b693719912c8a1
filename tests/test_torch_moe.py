"""PyTorch port, the expert-choice mixture of experts
(particle_fm_tpu_torch/nets/moe.py) and the MoE transformer held against
the JAX package with the JAX parameters carried across.

The module: forward within 1e-5 and the gradients of the input and of every
parameter within 1e-5 of the largest, on masked sets, on sets with fewer
real tokens than an expert's capacity C (where experts reach the padding,
whose scores sink to -1 and whose gates are 0: the tie order of the top-k
among them must not matter) and on sets of one token; in bfloat16 closer to
JAX's bfloat16 than that is to JAX's float32 (Frobenius), with the router in
float32. The MoE transformer (configs/experiment/jetnet/fm_moe_transformer.
yaml, narrowed): the vector field and `sample` from the same noise within
1e-4, and the parameter layout both ways.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.nets.moe import ExpertChoiceMoE as JaxMoE
from particle_fm_tpu_torch.nets.moe import ExpertChoiceMoE, expert_capacity
from particle_fm_tpu_torch.utils.from_jax import load_flax_params
from tests.torch_port_helpers import (bf16_gaps, cloud, droid_net_config, filled, grads_by_name,
                                      jax_noise, model_pair, t)

D, CTXT = 8, 5
MOE_CFG = dict(num_experts=4, hddn_dim=16, capacity_factor=2.0)


def moe_pair(ctxt_dim=CTXT, dtype=None, seed=0, **cfg):
    cfg = dict(MOE_CFG, **cfg)
    jm = JaxMoE(outp_dim=D, ctxt_dim=ctxt_dim, dtype=None if dtype is None else jnp.bfloat16,
                **cfg)
    x = jnp.zeros((2, 7, D))
    variables = jm.init(jax.random.PRNGKey(seed), x, None,
                        jnp.zeros((2, ctxt_dim)) if ctxt_dim else None)
    params = filled(variables["params"], seed, 0.5)
    pm = ExpertChoiceMoE(D, D, ctxt_dim=ctxt_dim, dtype=dtype, **cfg)
    load_flax_params(pm, params)
    return jm, {"params": params}, pm


def sets(lengths, n=7, seed=0):
    rs = np.random.RandomState(seed)
    b = len(lengths)
    mask = (np.arange(n)[None] < np.asarray(lengths)[:, None]).astype(np.float32)
    x = rs.randn(b, n, D).astype(np.float32)
    return x, mask, rs.randn(b, CTXT).astype(np.float32)


CASES = {"masked": [7, 5, 4], "shorter than C": [3, 1, 2], "one token": [1, 1],
         "no mask": None}


def test_capacity_is_the_jax_one():
    assert expert_capacity(30, 4, 2.0) == 15  # the shipped experiment
    assert expert_capacity(5, 4, 0.1) == 1 and expert_capacity(3, 2, 9.0) == 3
    assert expert_capacity(7, 4, 2.0) == 4


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_gradients_match_jax(case):
    lengths = CASES[case]
    x, mask, ctxt = sets(lengths or [7, 7, 7])
    m = None if lengths is None else mask
    jm, variables, pm = moe_pair()

    def jout(params, xx):
        return jm.apply({"params": params}, xx, None if m is None else jnp.asarray(m),
                        jnp.asarray(ctxt))

    ref = np.asarray(jout(variables["params"], jnp.asarray(x)))
    w = np.random.RandomState(3).randn(*ref.shape).astype(np.float32)
    jgp, jgx = jax.grad(lambda p, xx: jnp.sum(jout(p, xx) * w), argnums=(0, 1))(
        variables["params"], jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    out = pm(xt, None if m is None else t(m), t(ctxt))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5)
    assert np.abs(ref).max() > 0.1
    grads = torch.autograd.grad((out * t(w)).sum(), [xt] + list(pm.parameters()))
    want = grads_by_name(jgp)
    scale = max(np.abs(g).max() for g in want.values())
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), atol=1e-5 * scale)
    for (name, _), g in zip(pm.named_parameters(), grads[1:]):
        np.testing.assert_allclose(g.numpy(), want[name], atol=1e-5 * scale, err_msg=name)
    if m is not None:  # tokens no expert picks, and padding, return 0
        picked = np.abs(ref).sum(-1) > 0
        assert not picked[m == 0].any()


def test_padding_order_does_not_matter():
    """Sets shorter than C: the experts take padding with gate 0, so which
    padded token a tie picks changes nothing."""
    x, mask, ctxt = sets([2, 1, 3])
    jm, variables, pm = moe_pair()
    out = pm(t(x), t(mask), t(ctxt)).detach().numpy()
    shuffled = x.copy()
    shuffled[mask == 0] = np.random.RandomState(9).randn(int((mask == 0).sum()), D)
    out2 = pm(t(shuffled), t(mask), t(ctxt)).detach().numpy()
    np.testing.assert_allclose(out2[mask > 0], out[mask > 0], atol=1e-6)


def test_no_context_and_layout():
    x, mask, _ = sets([7, 4])
    jm, variables, pm = moe_pair(ctxt_dim=0)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(mask), None))
    np.testing.assert_allclose(pm(t(x), t(mask)).detach().numpy(), ref, atol=1e-5)
    shapes = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert shapes == {"router.weight": (4, D), "router.bias": (4,), "w1": (4, D, 16),
                      "b1": (4, 16), "w2": (4, 16, D), "b2": (4, D)}
    assert torch.equal(ExpertChoiceMoE(D, D).router.bias, torch.zeros(4))
    with pytest.raises(ValueError, match="ctxt"):
        moe_pair()[2](t(x), t(mask))


def test_bfloat16_is_closer_to_jax_bf16_than_jax_bf16_is_to_float32():
    x, mask, ctxt = sets([7, 3, 5], seed=4)
    jm32, variables, _ = moe_pair()
    jm16, _, pm16 = moe_pair(dtype=torch.bfloat16)
    args = (jnp.asarray(x), jnp.asarray(mask), jnp.asarray(ctxt))
    with jax.disable_jit():
        ref16 = np.asarray(jm16.apply(variables, jnp.asarray(x, jnp.bfloat16), *args[1:]),
                           np.float32)
    ref32 = np.asarray(jm32.apply(variables, *args))
    out = pm16(t(x).to(torch.bfloat16), t(mask), t(ctxt)).float().detach().numpy()
    ours, theirs = bf16_gaps(out, ref16, ref32, "moe bf16")
    assert ours < theirs
    assert pm16.router.weight.dtype == torch.float32  # the router computes in float32


MOE_TRANSFORMER = dict(model="droid_fulltransformer", features=3, num_particles=12,
                       frequencies=4, t_emb="sincos", loss_type="FM-OT", add_time_to_input=True,
                       global_cond_dim=0,
                       net_config=droid_net_config("te_config", moe_config=dict(
                           num_experts=4, hddn_dim=24, capacity_factor=2.0)))


def test_moe_transformer_field_and_sample_match_jax():
    jm, variables, pm, net = model_pair(MOE_TRANSFORMER, fill=0.2)
    assert hasattr(net.flows[0].net.te.layer_1, "moe")
    _, mask, _, ts = cloud(b=3, n=12, seed=2)
    x = cloud(b=3, n=12, seed=3)[0]
    ref = np.asarray(jm.vector_field(variables, jnp.asarray(ts), jnp.asarray(x),
                                     mask=jnp.asarray(mask)))
    with torch.no_grad():
        out = pm.vector_field(net, t(ts), t(x), None, t(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    assert np.abs(ref).max() > 0.05
    with jax.disable_jit():  # op by op: quicker here than compiling the sampler
        ref = np.asarray(jm.sample(variables, jax.random.PRNGKey(5), mask=jnp.asarray(mask),
                                   ode_solver="midpoint", ode_steps=4))
    z = jax_noise(5, ref.shape, mask)
    out = pm.integrate(net, t(z), None, t(mask), "midpoint", 4).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)
