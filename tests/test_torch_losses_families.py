"""PyTorch port, the loss families beyond FM-OT and CFM held against the JAX
package on the CPU: PC-JeDi diffusion (MLE weight on), PC-Droid with the VE
range t_max, reflow on packed (x1, x0) pairs and CFM-OT with its minibatch-OT
pairing, first on a parameter-free field, then through `FlowMatchingModel`
(EPiC at a small width) with their gradients, self-conditioning included.
t, the noises and the self-conditioning draw are pinned to the same numpy
arrays on both sides.

Tolerances: losses rtol 1e-6 on the parameter-free field (1e-5 through the
network, as tests/test_torch_train_model.py); every gradient atol 1e-5 times
the largest gradient of the network.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.losses import flow_matching as jloss
from particle_fm_tpu_torch.losses import flow_matching as ploss
from tests.torch_port_helpers import (YAML_FLAGSHIP, cloud, grads_by_name, model_pair,
                                      pin_draws, pin_self_cond, t)

DIFF = {"max_sr": 0.999, "min_sr": 0.02}
FAMILIES = {
    "diffusion": dict(diff_config=DIFF),
    "droid": dict(droid_t_max=25.0),
    "reflow": {},
    "CFM-OT": {},
}
N_NORMALS = {"diffusion": 1, "droid": 1, "reflow": 1, "CFM-OT": 2}


def _linear_vf(w, framework):
    def vf(tt, y, cond, mask):
        out = y @ framework(w) + tt[:, None, None]
        if cond is not None:
            out = out + cond[:, None, :1]
        return out * mask
    return vf


@pytest.mark.parametrize("criterion", ["mse", "huber"])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("loss_type", list(FAMILIES))
def test_family_losses_match_jax(monkeypatch, loss_type, masked, criterion):
    feats = 6 if loss_type == "reflow" else 3
    x, mask, cond, _ = cloud(b=5, n=12, feats=feats, seed=3)
    if not masked:
        mask = None
        x = np.random.RandomState(4).randn(*x.shape).astype(np.float32)
    w = np.random.RandomState(1).randn(3, 3).astype(np.float32)
    pin_draws(monkeypatch, b=5, shape=x.shape[:-1] + (3,), n_normals=N_NORMALS[loss_type],
              steps=1, seed=2)
    kw = dict(sigma=1e-4, criterion=criterion, **FAMILIES[loss_type])
    jfn, pfn = jloss.get_loss_fn(loss_type, **kw), ploss.get_loss_fn(loss_type, **kw)
    ref = float(jfn(_linear_vf(w, jnp.asarray), jax.random.PRNGKey(0), jnp.asarray(x),
                    None if mask is None else jnp.asarray(mask), jnp.asarray(cond)))
    out = float(pfn(_linear_vf(w, t), torch.Generator(), t(x),
                    None if mask is None else t(mask), t(cond)))
    assert np.isfinite(ref) and ref > 0
    np.testing.assert_allclose(out, ref, rtol=1e-6)


def test_every_family_is_ported():
    for name in ("FM-OT", "CFM", "CFM-OT", "reflow", "diffusion", "droid"):
        assert callable(ploss.get_loss_fn(name))
    with pytest.raises(NotImplementedError, match="bogus"):
        ploss.get_loss_fn("bogus")


CASES = {
    "diffusion huber": dict(YAML_FLAGSHIP, loss_type="diffusion", criterion="huber",
                            diff_config=DIFF),
    "droid t_max 25": dict(YAML_FLAGSHIP, loss_type="droid", droid_t_max=25.0),
    "CFM-OT": dict(YAML_FLAGSHIP, loss_type="CFM-OT"),
    "self_cond CFM": dict(YAML_FLAGSHIP, loss_type="CFM", self_cond=True),
    "self_cond droid": dict(YAML_FLAGSHIP, loss_type="droid", droid_t_max=25.0, self_cond=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_family_loss_and_gradients_match_jax(monkeypatch, case):
    cfg = CASES[case]
    jm, variables, pm, net = model_pair(cfg, fill=True)
    x, mask, cond, _ = cloud(b=6, n=16, seed=7)
    pin_draws(monkeypatch, b=6, shape=x.shape, n_normals=N_NORMALS.get(cfg["loss_type"], 2),
              steps=1, seed=8)
    pin_self_cond(monkeypatch, np.array([True, False, True, True, False, True])[:, None, None])

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
    assert scale > 0
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[name], atol=1e-5 * scale, err_msg=name)


def test_self_cond_widens_the_input_and_uses_the_estimate():
    """The self-conditioned network reads 2*features per particle (beside the
    time and cond columns; the JAX weights, shape-checked, load into it), and
    its field with the estimate differs from the field without."""
    jm, variables, pm, net = model_pair(CASES["self_cond CFM"], fill=True)
    t_dim, cond_dim = 2 * pm.frequencies, pm.global_cond_dim
    assert net.flows[0].net.fc_l1.weight_v.shape[1] == t_dim + 2 * pm.features + cond_dim
    x, mask, cond, ts = cloud(b=3, n=16, seed=2)
    with torch.no_grad():
        a = net(t(ts), t(x), t(cond), t(mask))
        b = net(t(ts), t(x), t(cond), t(mask), x_sc=t(x))
        ref_a = np.asarray(jm.vector_field(variables, jnp.asarray(ts), jnp.asarray(x),
                                           jnp.asarray(cond), jnp.asarray(mask)))
        ref_b = np.asarray(jm.module.apply(variables, jnp.asarray(ts), jnp.asarray(x),
                                           cond=jnp.asarray(cond), mask=jnp.asarray(mask),
                                           x_sc=jnp.asarray(x)))
    np.testing.assert_allclose(a.numpy(), ref_a, atol=1e-5)
    np.testing.assert_allclose(b.numpy(), ref_b, atol=1e-5)
    assert np.abs(ref_a - ref_b).max() > 1e-3
