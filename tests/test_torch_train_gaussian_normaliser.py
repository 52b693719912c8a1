"""PyTorch port, the two model options that carry state through training,
held against the JAX package's un-jitted `parallel/train.py` steps on the
CPU with t and the noise pinned per step:

- the gaussian time embedding (`nets/time_emb.py::GaussianFourierProjection`
  with the CNF's `gfp_dense` and `gfp_out`): the embedding within 1e-6, the
  vector field within 1e-5 and a folded-route sample within 1e-4; its `W`,
  which the forward pass detaches, after 3 AdamW steps equal to optax's
  within 1e-7 relative (weight decay shrinks it, the EMA tracks it). The
  learning rate and the decay are both 2^-5, so that the shrinking shows
  (2^-10 a step) and 1 - lr * wd is exact in float32: torch's AdamW
  multiplies by the float32 rounding of 1 - lr * wd where optax subtracts
  lr * (wd * p), a one-ulp difference of every parameter at other values
  that the trajectory tests' tolerances take in;
- normaliser training (`nets/norm_layer.py::IterativeNormLayer.update` from
  the loss): both normalisers' statistics after each of 3 steps, with and
  without gradient accumulation, within 1e-6 relative, the loss of the
  first step within 1e-5, and the statistics frozen once `n` reaches
  `max_n`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.parallel import train as jtrain
from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel as PortModel
from particle_fm_tpu_torch.training import step as pstep
from particle_fm_tpu_torch.utils.from_jax import load_flax_train_state
from tests.torch_port_helpers import (YAML_FLAGSHIP, cloud, draws, jax_cos_table, jax_noise,
                                      model_pair, pin_draws, t)

B = 4
GAUSS = dict(YAML_FLAGSHIP, t_emb="gaussian", frequencies=6)
# sincos time: the cosine ladder's float32 field is a chaotic function of t, and
# the jitted JAX step rounds its time products otherwise than op by op
NORMED = dict(YAML_FLAGSHIP, t_emb="sincos", frequencies=6, use_normaliser=True)
BOTH = dict(GAUSS, use_normaliser=True, normaliser_config={"max_n": 60})


def test_gaussian_embedding_field_and_sample_match_jax():
    jm, variables, pm, net = model_pair(GAUSS, fill=0.2)
    ts = np.array([0.0, 0.13, 0.5, 0.97], np.float32)
    ref = np.asarray(jm.module.apply(variables, jnp.asarray(ts), 16,
                                     method=lambda m, tt, n: m.flows[0].time_embedding(tt, n)))
    with torch.no_grad():
        emb = net.flows[0].time_embedding(t(ts)).numpy()
    np.testing.assert_allclose(emb, ref[:, 0], atol=1e-6)
    assert emb.shape == (4, 12) and np.abs(emb).max() > 0.1
    assert net.flows[0].gfp.W.requires_grad  # a parameter, detached in the forward pass
    x, mask, cond, _ = cloud(b=B, seed=1)
    ref = np.asarray(jm.vector_field(variables, jnp.asarray(ts), jnp.asarray(x),
                                     jnp.asarray(cond), jnp.asarray(mask)))
    with torch.no_grad():
        out = pm.vector_field(net, t(ts), t(x), t(cond), t(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    ref = np.asarray(jm.sample(variables, jax.random.PRNGKey(3), cond=jnp.asarray(cond),
                               mask=jnp.asarray(mask), ode_steps=4))
    z = jax_noise(3, ref.shape, mask)
    out = pm.integrate(net, t(z), t(cond), t(mask), "midpoint", 4).numpy()  # folded route
    np.testing.assert_allclose(out, ref, atol=1e-4)


def states(monkeypatch, cfg, lr, wd, ts, zs):
    """(jax model, jax optimizer, jax state, port model, port state), the
    JAX initial state carried into the port."""
    # the statistics a normaliser starts from (the flax layer creates them at
    # its first update; handing them in explicitly is the same)
    fresh = PortModel(**cfg).init(device="cpu")
    norm_stats = {name: {leaf: getattr(getattr(fresh, name), leaf).numpy()
                         for leaf in ("means", "m2", "vars", "n")}
                  for name in ("normaliser", "ctxt_normaliser") if hasattr(fresh, name)}
    jm, variables, pm, _ = model_pair(cfg, fill=0.1, norm_stats=norm_stats or None)
    jopt = jtrain.make_optimizer(lr=lr, weight_decay=wd, grad_clip=0.5)
    params = variables["params"]
    jstate = jtrain.TrainState(params=params,
                               norm_stats=jax.tree_util.tree_map(jnp.asarray, norm_stats),
                               ema_params=jax.tree_util.tree_map(jnp.copy, params),
                               opt_state=jopt.init(params), step=jnp.zeros((), jnp.int32))
    popt = pstep.make_optimizer(lr=lr, weight_decay=wd)
    pstate = pstep.create_train_state(pm, popt, device="cpu")
    for flow in pstate.net.flows:
        if flow.t_emb == "cosine":
            flow.cos_freqs.copy_(torch.from_numpy(jax_cos_table(flow.cos_freqs.shape[0])))
    load_flax_train_state(pstate, jstate)
    pin_draws(monkeypatch, ts, zs)
    return jm, jopt, jstate, pm, popt, pstate


def scaled_batches(n, b=B, seed=10):
    """Masked sets and cond away from mean 0, variance 1."""
    out = []
    for i in range(n):
        x, mask, cond, _ = cloud(b=b, n=16, seed=seed + i)
        out.append(((x * (2.0 + i) + 1.5) * mask, mask, cond * 3.0 - 0.7))
    return out


def assert_stats(pstate, jstate, rtol=1e-6):
    sd = pstate.net.state_dict()
    for name, leaves in jax.device_get(jstate.norm_stats).items():
        for leaf, value in leaves.items():
            np.testing.assert_allclose(sd[f"{name}.{leaf}"].numpy(), value, rtol=rtol, atol=0,
                                       err_msg=f"{name}.{leaf}")


def test_gaussian_W_after_three_adamw_steps_matches_optax(monkeypatch):
    batches = scaled_batches(3)
    ts, zs = draws(b=B, shape=batches[0][0].shape, n_normals=1, steps=1, seed=2)
    lr = wd = 2.0 ** -5
    # the jitted JAX step takes its pinned draws once, when it is traced: the
    # port takes the same ones at every step
    jm, jopt, jstate, pm, popt, pstate = states(monkeypatch, GAUSS, lr, wd, ts * 3, zs * 3)
    w0 = pstate.net.flows[0].gfp.W.detach().clone()
    jstep = jax.jit(jtrain._build_step_fn(jm, jopt, ema_decay=0.9))
    port_step = pstep._build_step_fn(pm, popt, ema_decay=0.9)
    for x, mask, cond in batches:
        jstate, jloss = jstep(jstate, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask),
                              jnp.asarray(cond))
        ploss = port_step(pstate, torch.Generator(), t(x), t(mask), t(cond))
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    names = [n for n, _ in pstate.net.named_parameters()]
    w = pstate.net.flows[0].gfp.W.detach()
    ema = pstate.ema_params[names.index("flows.0.gfp.W")]
    np.testing.assert_allclose(w.numpy(), np.asarray(jstate.params["flows_0"]["gfp"]["W"]),
                               rtol=1e-7, atol=0)
    np.testing.assert_allclose(ema.numpy(), np.asarray(jstate.ema_params["flows_0"]["gfp"]["W"]),
                               rtol=1e-7, atol=0)
    # decay alone moved it: (1 - lr * wd)^3, about 3e-3 of its size
    np.testing.assert_allclose(w.numpy(), w0.numpy() * (1 - lr * wd) ** 3, rtol=1e-6)
    assert np.abs(w.numpy() - w0.numpy()).max() > 1e-3 * np.abs(w0.numpy()).max()


@pytest.mark.parametrize("cfg,accum", [(NORMED, 1), (NORMED, 2), (BOTH, 1)],
                         ids=["normaliser", "normaliser-accum", "gaussian-normaliser-max_n"])
def test_normaliser_statistics_after_three_steps_match_jax(monkeypatch, cfg, accum):
    batches = scaled_batches(3, b=B * accum)
    ts, zs = draws(b=B, shape=(B,) + batches[0][0].shape[1:], n_normals=1, steps=1, seed=4)
    # the jitted JAX step draws once, at its trace (each microbatch of its scan
    # alike): the port takes the same draw every time. The statistics depend
    # on the data alone; the loss is held at the first step.
    jm, jopt, jstate, pm, popt, pstate = states(monkeypatch, cfg, 1e-3, 5e-5, ts * 3 * accum,
                                                zs * 3 * accum)
    build = (jtrain._build_accum_step_fn, pstep._build_accum_step_fn) if accum > 1 else (
        jtrain._build_step_fn, pstep._build_step_fn)
    jstep, port_step = jax.jit(build[0](jm, jopt)), build[1](pm, popt)

    def stacked(a):
        return a.reshape((accum, B) + a.shape[1:]) if accum > 1 else a

    seen = []
    for i, (x, mask, cond) in enumerate(batches):
        args = [stacked(a) for a in (x, mask, cond)]
        jstate, jloss = jstep(jstate, jax.random.PRNGKey(0), *map(jnp.asarray, args))
        ploss = port_step(pstate, torch.Generator(), *map(t, args))
        if i == 0:
            np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
        assert_stats(pstate, jstate)
        seen.append({k: v.clone() for k, v in pstate.net.state_dict().items() if "normaliser" in k})
    counts = [float(s["normaliser.n"]) for s in seen]
    masses = np.cumsum([float(m.sum()) for _, m, _ in batches])
    if "max_n" in cfg.get("normaliser_config", {}):
        # frozen from the step that reached max_n on: the later batches change nothing
        assert masses[0] < 60 <= masses[1]
        assert counts == [masses[0], masses[1], masses[1]]
        frozen = [k for k in seen[1] if k.startswith("normaliser.")]
        assert len(frozen) == 4 and all(torch.equal(seen[1][k], seen[2][k]) for k in frozen)
        # the cond normaliser, 4 sets a step, is far from max_n and goes on
        assert not torch.equal(seen[1]["ctxt_normaliser.means"], seen[2]["ctxt_normaliser.means"])
    else:
        assert counts == list(masses)
        assert float(seen[-1]["ctxt_normaliser.n"]) == 3 * B * accum
    # the EMA network carries the live statistics
    ema_net = pstate.ema_network()
    assert torch.equal(ema_net.normaliser.means, pstate.net.normaliser.means)
