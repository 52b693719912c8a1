"""PyTorch port, `FlowMatchingModel` as the shipped configs build it, held
against the JAX model on the CPU.

Each `configs/model/*.yaml` block of a ported family (flow_matching,
fm_droid_transformer, fm_droid_crossattention, flow_matching_mdma), composed
with the port's `config/core.py` and narrowed by overrides, with `_target_`,
`optimizer` and `scheduler` popped as the JAX `train.py` pops them, builds
the port's model, and its `sample` agrees with the JAX model built from the
same block, with the same weights and noise: atol 1e-4. The fields the port
lacks raise only for the values that ask for them, and `loss` refuses what
it cannot train.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu_torch.config.core import compose
from particle_fm_tpu_torch.models import flow_matching as pflow
from tests.torch_port_helpers import cloud, jax_noise, model_pair, t

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
SMALL = ["model.num_particles=16"]
NARROW = {
    "flow_matching": SMALL + ["model.hidden_dim=32", "model.layers=2", "model.latent=8",
                              "model.global_cond_dim=2", "model.local_cond_dim=2"],
    "fm_droid_transformer": SMALL + [
        "model.global_cond_dim=2", "model.net_config.te_config.model_dim=32",
        "model.net_config.te_config.num_layers=2",
        "model.net_config.te_config.mha_config.num_heads=4",
        "model.net_config.ctxt_embd_config.outp_dim=12"],
    "fm_droid_crossattention": SMALL + [
        "model.global_cond_dim=2", "model.net_config.cae_config.model_dim=32",
        "model.net_config.cae_config.num_layers=2",
        "model.net_config.cae_config.mha_config.num_heads=4",
        "model.net_config.cae_config.dense_config.hddn_dim=32",
        "model.net_config.ctxt_embd_config.outp_dim=12"],
    "flow_matching_mdma": SMALL + [
        "model.global_cond_dim=1", "model.net_config.hidden_dim=32", "model.net_config.layers=2",
        "model.net_config.latent=8", "model.net_config.num_heads=4"],
}


def model_block(name: str, *extra: str) -> dict:
    """The model block of configs/model/{name}.yaml as the port composes it,
    narrowed, with `_target_`, `optimizer` and `scheduler` popped."""
    cfg = dict(compose(CONFIG_DIR, "train", [f"model={name}", *NARROW[name], *extra])["model"])
    for key in ("_target_", "optimizer", "scheduler"):
        cfg.pop(key)
    return cfg


@pytest.mark.parametrize("name", list(NARROW))
def test_shipped_model_configs_sample_as_jax(name):
    cfg = model_block(name)
    # every weight drawn anew (the droid models zero their output layers), at
    # a scale that keeps MDMA's 8 x 8 products near unit size
    jm, variables, pm, net = model_pair(cfg, fill=0.05 if name == "flow_matching_mdma" else True)
    _, mask, cond, _ = cloud(b=3, feats=pm.features, cond_dim=pm.global_cond_dim, seed=5)
    with jax.disable_jit():
        ref = np.asarray(jm.sample(variables, jax.random.PRNGKey(3), cond=jnp.asarray(cond),
                                   mask=jnp.asarray(mask), ode_steps=3))
    out = pm.integrate(net, t(jax_noise(3, ref.shape, mask)), t(cond), t(mask), "midpoint", 3)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("override,error", [
    ("model.dropout=0.1", NotImplementedError),
    ("model.droid_t_max=25", NotImplementedError),
    ("model.criterion=l1", ValueError),
    ("model.loss_type=diffusion", NotImplementedError),
])
def test_fields_raise_only_for_what_the_port_lacks(override, error):
    pflow.FlowMatchingModel(**model_block("flow_matching"))  # the shipped values build
    with pytest.raises(error):
        pflow.FlowMatchingModel(**model_block("flow_matching", override))


def test_loss_refuses_what_it_cannot_train():
    x, mask, cond, _ = cloud(b=2, n=16, seed=0)
    args = (torch.Generator(), t(x), t(mask), t(cond))
    ot = pflow.FlowMatchingModel(**model_block("flow_matching", "model.loss_type=CFM-OT"))
    net = ot.init(device="cpu")  # CFM-OT samples; its loss is not ported
    with pytest.raises(NotImplementedError, match="CFM-OT"):
        ot.loss(net, *args, train=True)
    pm = pflow.FlowMatchingModel(**model_block("flow_matching"))
    net = pm.init(device="cpu")
    pm.fold_weight_norm(net)
    with pytest.raises(RuntimeError, match="unfolded"):
        pm.loss(net, *args, train=True)
    pm.unfold_weight_norm(net)
    assert torch.isfinite(pm.loss(net, *args, train=True))
    normed = pflow.FlowMatchingModel(**model_block("flow_matching", "model.use_normaliser=true"))
    net = normed.init(device="cpu")
    with pytest.raises(NotImplementedError, match="use_normaliser"):
        normed.loss(net, *args, train=True)
    assert torch.isfinite(normed.loss(net, *args, train=False))  # frozen statistics
