"""PyTorch port, the train step in bfloat16 (float32 master weights) against
the JAX package's un-jitted step functions run op by op
(`parallel/train.py::_build_step_fn`, `_build_accum_step_fn` under
`jax.disable_jit`; under jit XLA keeps excess bfloat16 precision), on the
narrow EPiC flagship from the same parameters, with t and the noise pinned
per loss call:

- a 5-step trajectory (global-norm clip 0.5, AdamW at a constant lr 1e-3,
  EMA 0.9): at every step the loss, the parameters and the EMA weights held
  by the bf16 gate |port_bf16 - jax_bf16| < |jax_bf16 - jax_f32|
  (`tests/torch_port_helpers.py::hold_bf16`), the parameters, the EMA and
  AdamW's moments float32 (the accumulation step:
  tests/test_torch_train_bf16_accum.py).

JAX's bfloat16 sums accumulate in float32 here, as torch's do
(`jax_reductions_in_float32`; tests/test_torch_train_bf16_layers.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import torch

from particle_fm_tpu.parallel import train as jtrain
from particle_fm_tpu_torch.training import step as pstep
from tests.torch_port_helpers import (YAML_FLAGSHIP, bf16_triple, cloud, draws, grads_by_name,
                                      hold_bf16, jax_reductions_in_float32, pin_draws, t)

EMA = dict(ema_decay=0.9, ema_every_n=1, ema_start_step=0)
OPT = dict(lr=1e-3, weight_decay=5e-5, grad_clip=0.5)
B = 4


def _jax_state(params, jopt):
    return jtrain.TrainState(params=params, norm_stats={},
                             ema_params=jax.tree_util.tree_map(jnp.copy, params),
                             opt_state=jopt.init(params), step=jnp.zeros((), jnp.int32))


def _port_state(pm16, net16, opt):
    params = list(net16.parameters())
    return pstep.TrainState(net=net16, ema_params=[p.detach().clone() for p in params],
                            opt_state=opt.init(params))


def _named(state, tensors):
    names = [n for n, _ in state.net.named_parameters()]
    return {n: a.detach().numpy().copy() for n, a in zip(names, tensors)}


def _all_float32(state):
    tensors = [*state.params(), *state.ema_params]
    tensors += [v for s in state.opt_state.state.values() for v in s.values() if v.ndim]
    return all(a.dtype == torch.float32 for a in tensors)


def test_bf16_trajectory_closer_to_jax_bf16_than_jax_is_to_f32(monkeypatch):
    jax_reductions_in_float32(monkeypatch)
    jm, jm16, variables, pm16, net16 = bf16_triple(YAML_FLAGSHIP, fill=0.1)
    jopt = jtrain.make_optimizer(**OPT)
    batches = [cloud(b=B, n=16, seed=10 + i)[:3] for i in range(5)]
    ts, zs = draws(b=B, shape=batches[0][0].shape, n_normals=1, steps=5, seed=1)
    jax_runs = {}
    for name, model in (("f32", jm), ("bf16", jm16)):
        pin_draws(monkeypatch, ts, zs)
        state, step, run = _jax_state(variables["params"], jopt), jtrain._build_step_fn(
            model, jopt, **EMA), []
        with jax.disable_jit():
            for x, mask, cond in batches:
                state, loss = step(state, jax.random.PRNGKey(0), jnp.asarray(x),
                                   jnp.asarray(mask), jnp.asarray(cond))
                run.append((float(loss), grads_by_name(state.params),
                            grads_by_name(state.ema_params)))
        jax_runs[name] = run

    pin_draws(monkeypatch, ts, zs)
    opt = pstep.make_optimizer(**OPT)
    state = _port_state(pm16, net16, opt)
    step = pstep._build_step_fn(pm16, opt, **EMA)
    for i, (x, mask, cond) in enumerate(batches):
        loss = float(step(state, torch.Generator(), t(x), t(mask), t(cond)))
        assert state.step == i + 1 and _all_float32(state)
        (l32, p32, e32), (l16, p16, e16) = jax_runs["f32"][i], jax_runs["bf16"][i]
        hold_bf16(f"step {i} parameters", (loss, _named(state, state.params())), (l16, p16),
                  (l32, p32))
        hold_bf16(f"step {i} EMA", (loss, _named(state, state.ema_params)), (l16, e16),
                  (l32, e32))
