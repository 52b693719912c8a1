"""PyTorch port, `FlowMatchingModel` as the shipped configs build it, held
against the JAX model on the CPU.

Each `configs/model/*.yaml` block of a ported family (flow_matching,
fm_droid_transformer, fm_droid_crossattention, flow_matching_mdma), composed
with the port's `config/core.py` and narrowed by overrides, with `_target_`,
`optimizer` and `scheduler` popped as the JAX `train.py` pops them, builds
the port's model, and its `sample` agrees with the JAX model built from the
same block, with the same weights and noise: atol 1e-4. So do the model
blocks of the experiments of the other loss families
(jetnet/diffusion_tops150_cond on configs/model/diffusion.yaml with its
eval solver em, jetnet/droid_tops30, jetnet/fm_selfcond_tops30,
jetnet/ot_cfm_tops30), with the prior noise and Euler-Maruyama's noise
replayed from the JAX stream, and each takes 3 training steps on the CPU on
one batch with the same draws every step, its loss falling at each. The
fields the port lacks raise only for the values that ask for them, and
`loss` refuses what it cannot train.
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
from particle_fm_tpu_torch.training import step as pstep
from tests.torch_port_helpers import (cloud, jax_noise, jax_sde_noise, model_pair, pin_sde_noise,
                                      t)

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


EPIC_NARROW = SMALL + ["model.hidden_dim=32", "model.layers=2", "model.latent=8"]
EXPERIMENTS = {
    "diffusion_tops150_cond": EPIC_NARROW,
    "droid_tops30": NARROW["fm_droid_transformer"],
    "fm_selfcond_tops30": EPIC_NARROW,
    "ot_cfm_tops30": EPIC_NARROW,
}


def _popped(cfg: dict) -> dict:
    cfg = dict(cfg)
    for key in ("_target_", "optimizer", "scheduler"):
        cfg.pop(key)
    return cfg


def model_block(name: str, *extra: str) -> dict:
    """The model block of configs/model/{name}.yaml as the port composes it,
    narrowed, with `_target_`, `optimizer` and `scheduler` popped."""
    return _popped(compose(CONFIG_DIR, "train", [f"model={name}", *NARROW[name], *extra])["model"])


def experiment(name: str) -> tuple[dict, dict]:
    """(narrowed model block, jetnet_eval callback block) of
    configs/experiment/jetnet/{name}.yaml."""
    cfg = compose(CONFIG_DIR, "train", [f"experiment=jetnet/{name}", *EXPERIMENTS[name]])
    return _popped(cfg["model"]), cfg["callbacks"]["jetnet_eval"]


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
    ("model.dtype=bfloat16", NotImplementedError),
    ("model.criterion=l1", ValueError),
    ("model.loss_type=bogus", NotImplementedError),
])
def test_fields_raise_only_for_what_the_port_lacks(override, error):
    pflow.FlowMatchingModel(**model_block("flow_matching"))  # the shipped values build
    with pytest.raises(error):
        pflow.FlowMatchingModel(**model_block("flow_matching", override))


def test_loss_refuses_what_it_cannot_train():
    x, mask, cond, _ = cloud(b=2, n=16, seed=0)
    args = (torch.Generator(), t(x), t(mask), t(cond))
    ot = pflow.FlowMatchingModel(**model_block("flow_matching", "model.loss_type=CFM-OT"))
    assert torch.isfinite(ot.loss(ot.init(device="cpu"), *args, train=True))  # CFM-OT trains
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


@pytest.mark.parametrize("name", list(EXPERIMENTS))
def test_family_experiments_sample_as_jax(monkeypatch, name):
    cfg, eval_cfg = experiment(name)
    jm, variables, pm, net = model_pair(cfg, fill=True)
    solver, steps = eval_cfg.get("ode_solver", "midpoint"), 4
    assert solver == ("em" if name.startswith("diffusion") else "midpoint")
    _, mask, cond, _ = cloud(b=3, feats=pm.features, cond_dim=max(pm.global_cond_dim, 1), seed=5)
    cond = cond if pm.conditioned else None
    seed = 3
    with jax.disable_jit():
        ref = np.asarray(jm.sample(variables, jax.random.PRNGKey(seed),
                                   cond=None if cond is None else jnp.asarray(cond),
                                   mask=jnp.asarray(mask), ode_solver=solver, ode_steps=steps))
    monkeypatch.setattr(pflow, "draw_noise", lambda _g, shape, dev: t(jax_noise(seed, shape)))
    pin_sde_noise(monkeypatch, jax_sde_noise(seed, ref.shape, steps))
    out = pm.sample(net, torch.Generator(), cond=None if cond is None else t(cond), mask=t(mask),
                    ode_solver=solver, ode_steps=steps).numpy()
    assert np.isfinite(ref).all() and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, atol=1e-4 * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("name", list(EXPERIMENTS))
def test_family_experiments_train_on_cpu(name):
    """3 steps of AdamW on one batch with the same draws each step: the loss
    falls at every step."""
    cfg, _ = experiment(name)
    pm = pflow.FlowMatchingModel(**cfg)
    optimizer = pstep.make_optimizer(lr=1e-3)
    state = pstep.create_train_state(pm, optimizer, seed=0, device="cpu")
    step = pstep.make_train_step(pm, optimizer)
    x, mask, cond, _ = cloud(b=8, n=16, feats=pm.features, cond_dim=max(pm.global_cond_dim, 1),
                             seed=1)
    losses = [float(step(state, torch.Generator().manual_seed(0), t(x), t(mask),
                         t(cond) if pm.conditioned else None)) for _ in range(3)]
    assert np.isfinite(losses).all()
    assert losses[0] > losses[1] > losses[2], losses
