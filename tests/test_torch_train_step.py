"""PyTorch port, the train step (`training/step.py`) held against the JAX
package's un-jitted `parallel/train.py::_build_step_fn` on the CPU.

- The JAX TrainState (params, EMA, Adam moments and count, step) carried
  into the port by `utils/from_jax.py::load_flax_train_state` arrives exactly.
- A 5-step trajectory of global-norm clipping, AdamW, EMA and the cosine
  warmup schedule, started past step 0 from a state the JAX step made and
  carried across, with t and the noise pinned per step to the same numpy
  arrays, for EPiC (the transformer with attn_impl=packed:
  tests/test_torch_train_step_packed.py). Losses rtol
  1e-5 each step; the Adam moments atol 1e-4 of the moment's largest entry;
  the parameters and the EMA atol 0.02 times the summed learning rates of the
  five steps (Adam moves an entry whose gradient is near 0 by up to lr per
  step, whatever its sign), and 99% of the parameter entries within 1e-3 of
  that.
- The accumulation step over 2 microbatches equals the step over their
  union: loss rtol 1e-6, Adam's first moment (the clipped gradient times
  1 - b1) atol 1e-6 of its largest entry.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.parallel import train as jtrain
from particle_fm_tpu.training.lr_schedules import cosine_warmup_schedule as jax_cosine
from particle_fm_tpu_torch.training import step as pstep
from particle_fm_tpu_torch.training.lr_schedules import cosine_warmup_schedule
from particle_fm_tpu_torch.utils.from_jax import load_flax_train_state
from tests.torch_port_helpers import (
    YAML_FLAGSHIP, cloud, draws, grads_by_name, jax_cos_table, model_pair,
    pin_draws, t,
)

SCHEDULE = dict(base_lr=1e-3, warmup=2, max_iters=10, steps_per_epoch=3)
EMA = dict(ema_decay=0.9, ema_every_n=1, ema_start_step=0)
B = 4


def _port_state(pm, optimizer, jax_state):
    state = pstep.create_train_state(pm, optimizer, device="cpu")
    for flow in state.net.flows:
        if flow.t_emb == "cosine":
            flow.cos_freqs.copy_(torch.from_numpy(jax_cos_table(flow.cos_freqs.shape[0])))
    return load_flax_train_state(state, jax_state)


def _names(net):
    return [n for n, _ in net.named_parameters()]


def _adam(state, key):
    return {n: state.opt_state.state[p][key].numpy()
            for n, p in zip(_names(state.net), state.net.parameters())}


def check_trajectory(monkeypatch, cfg: dict, port_cfg: dict | None = None) -> None:
    """Two JAX steps, the state carried into the port, then five steps on
    both sides; the comparisons of the module docstring."""
    jm, variables, pm, _ = model_pair(cfg, port_cfg=port_cfg, fill=0.1)
    params = variables["params"]
    jopt = jtrain.make_optimizer(lr=jax_cosine(**SCHEDULE), weight_decay=5e-5, grad_clip=0.5)
    jstate = jtrain.TrainState(params=params, norm_stats={},
                               ema_params=jax.tree_util.tree_map(jnp.copy, params),
                               opt_state=jopt.init(params), step=jnp.zeros((), jnp.int32))
    jstep = jtrain._build_step_fn(jm, jopt, **EMA)
    batches = [cloud(b=B, n=16, seed=10 + i) for i in range(7)]
    ts, zs = draws(b=B, shape=batches[0][0].shape, n_normals=1, steps=7, seed=1)
    pin_draws(monkeypatch, ts[:2], zs[:2])
    for x, mask, cond, _ in batches[:2]:  # past the schedule's lr = 0 at step 0
        jstate, _ = jstep(jstate, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask),
                          jnp.asarray(cond))

    pstate = _port_state(pm, pstep.make_optimizer(lr=cosine_warmup_schedule(**SCHEDULE)), jstate)
    assert pstate.step == int(jstate.step) == 2
    for name, v in grads_by_name(jstate.params).items():
        np.testing.assert_array_equal(dict(pstate.net.named_parameters())[name].detach().numpy(), v)
    adam = jstate.opt_state[1][0]
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        ref = grads_by_name(tree)
        for name, v in _adam(pstate, key).items():
            np.testing.assert_array_equal(v, ref[name])

    pin_draws(monkeypatch, ts[2:], zs[2:])
    port_step = pstep._build_step_fn(pm, pstep.make_optimizer(
        lr=cosine_warmup_schedule(**SCHEDULE)), **EMA)
    lrs = []
    for x, mask, cond, _ in batches[2:]:
        lrs.append(cosine_warmup_schedule(**SCHEDULE)(pstate.step))
        jstate, jloss = jstep(jstate, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask),
                              jnp.asarray(cond))
        ploss = port_step(pstate, torch.Generator(), t(x), t(mask), t(cond))
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    assert pstate.step == int(jstate.step) == 7

    tol = 0.02 * sum(lrs)
    names = _names(pstate.net)
    got = dict(zip(names, (p.detach().numpy() for p in pstate.net.parameters())))
    ema = dict(zip(names, (e.numpy() for e in pstate.ema_params)))
    diffs = []
    for mine, ref in ((got, grads_by_name(jstate.params)), (ema, grads_by_name(jstate.ema_params))):
        for name in names:
            np.testing.assert_allclose(mine[name], ref[name], atol=tol, err_msg=name)
            diffs.append(np.abs(mine[name] - ref[name]).ravel())
    assert np.quantile(np.concatenate(diffs), 0.99) <= 1e-3 * tol
    adam = jstate.opt_state[1][0]
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        ref = grads_by_name(tree)
        scale = max(np.abs(v).max() for v in ref.values())
        for name, v in _adam(pstate, key).items():
            np.testing.assert_allclose(v, ref[name], atol=1e-4 * scale, err_msg=f"{key} {name}")


def test_trajectory_matches_jax(monkeypatch):
    check_trajectory(monkeypatch, YAML_FLAGSHIP)


def test_accumulation_equals_the_big_batch_step(monkeypatch):
    pm = model_pair(YAML_FLAGSHIP)[2]
    opt = pstep.make_optimizer(lr=1e-3)
    x, mask, cond, _ = cloud(b=2 * B, n=16, seed=3)
    ts, zs = draws(b=2 * B, shape=x.shape, n_normals=1, steps=1, seed=4)
    results = {}
    for accum in (1, 2):
        state = pstep.create_train_state(pm, opt, seed=5, device="cpu")
        step = pstep.make_train_step(pm, opt, accum=accum)
        if accum == 1:
            pin_draws(monkeypatch, ts, zs)
            loss = step(state, torch.Generator(), t(x), t(mask), t(cond))
        else:
            pin_draws(monkeypatch, [ts[0][:B], ts[0][B:]], [zs[0][:B], zs[0][B:]])
            split = lambda a: t(a.reshape((2, B) + a.shape[1:]))
            loss = step(state, torch.Generator(), split(x), split(mask), split(cond))
        assert state.step == 1
        results[accum] = (float(loss), _adam(state, "exp_avg"))
    np.testing.assert_allclose(results[2][0], results[1][0], rtol=1e-6)
    scale = max(np.abs(v).max() for v in results[1][1].values())
    for name, v in results[2][1].items():
        np.testing.assert_allclose(v, results[1][1][name], atol=1e-6 * scale, err_msg=name)


def test_ema_network_holds_the_ema_weights():
    pm = model_pair(YAML_FLAGSHIP)[2]
    state = pstep.create_train_state(pm, pstep.make_optimizer(), device="cpu")
    with torch.no_grad():
        for e in state.ema_params:
            e.add_(1.0)
    ema_net = state.ema_network()
    for p, q, e in zip(state.net.parameters(), ema_net.parameters(), state.ema_params):
        assert torch.equal(q, e) and not torch.equal(p, q)
