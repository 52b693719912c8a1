"""PyTorch port, `FlowMatchingModel.loss` and its gradients held against
`jax.value_and_grad` of the JAX model's loss on the CPU, with t, the noise
and the cond-dropout draw pinned to the same numpy arrays: for EPiC (t-cats
on, cond on both MLP paths; FM-OT and CFM, mse and huber, cond_dropout) and
for the full transformer with attn_impl=packed, whose attention runs through
the packed kernel's autograd.Function (its forward and backward the plain
version on the CPU). The JAX model takes the einsum path there, as it does
on the CPU.

Tolerances: loss rtol 1e-5; every gradient atol 1e-5 times the largest
gradient of the network.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu_torch.models import flow_matching as pflow
from particle_fm_tpu_torch.ops import attention as pattn
from particle_fm_tpu_torch.ops import short_attention as pshort
from tests.torch_port_helpers import (
    YAML_FLAGSHIP, cloud, droid_configs, grads_by_name, model_pair, pin_draws, t,
)


def _packed_route(monkeypatch):
    """Send attn_impl=packed self-attention on CPU tensors through the packed
    kernel's wrapper (its autograd.Function), as CUDA tensors go; count the
    calls."""
    calls = []
    dispatch = pattn.attention

    def attention(q, k, v, kv_mask=None, attn_bias=None, impl="auto", scores_dtype=None):
        if impl == "packed" and q.shape[1] == k.shape[1]:
            calls.append(torch.is_grad_enabled() and q.requires_grad)
            return pshort.packed_short_attention(q, k, v, kv_mask, attn_bias)
        return dispatch(q, k, v, kv_mask, attn_bias, impl, scores_dtype)

    monkeypatch.setattr(pattn, "attention", attention)
    return calls


TRANSFORMER_PACKED = droid_configs(port_mha={"attn_impl": "packed"})["transformer"]
CASES = {
    "epic FM-OT mse": (YAML_FLAGSHIP, None),
    "epic CFM huber": (dict(YAML_FLAGSHIP, loss_type="CFM", criterion="huber"), None),
    "epic cond_dropout": (dict(YAML_FLAGSHIP, cond_dropout=0.5), None),
    "transformer packed": TRANSFORMER_PACKED,
}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradients_match_jax(monkeypatch, case):
    cfg, port_cfg = CASES[case]
    jm, variables, pm, net = model_pair(cfg, port_cfg=port_cfg, fill=True)
    x, mask, cond, _ = cloud(b=6, n=16, seed=7)
    pin_draws(monkeypatch, b=6, shape=x.shape, n_normals=2 if pm.loss_type == "CFM" else 1,
              steps=1, seed=8)
    keep = np.array([[True], [False], [True], [True], [False], [True]])
    monkeypatch.setattr(jax.random, "bernoulli", lambda rng, p, shape: jnp.asarray(keep))
    monkeypatch.setattr(pflow, "_keep", lambda gen, p, shape, device: torch.from_numpy(keep))
    calls = _packed_route(monkeypatch)

    def jax_loss(params):
        return jm.loss({"params": params}, jax.random.PRNGKey(0), jnp.asarray(x),
                       jnp.asarray(mask), jnp.asarray(cond), train=True)[0]

    ref_loss, ref_grads = jax.value_and_grad(jax_loss)(variables["params"])
    loss = pm.loss(net, torch.Generator(), t(x), t(mask), t(cond), train=True)
    names = [n for n, _ in net.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(net.parameters()))))
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    ref = grads_by_name(ref_grads)
    assert sorted(ref) == sorted(grads)
    scale = max(np.abs(g).max() for g in ref.values())
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[name], atol=1e-5 * scale, err_msg=name)
    if port_cfg is not None:
        assert calls == [True] * 2  # one per layer, each under autograd


def test_loss_accum_weight_is_the_mask_sum():
    pm = pflow.FlowMatchingModel(**YAML_FLAGSHIP)
    x, mask, _, _ = cloud(b=3, n=16, seed=1)
    assert float(pm.loss_accum_weight(t(x), t(mask))) == mask.sum()
    assert float(pm.loss_accum_weight(t(x), None)) == 3 * 16
