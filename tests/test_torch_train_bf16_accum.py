"""PyTorch port, the train step with gradient accumulation in bfloat16
against the JAX package's un-jitted `parallel/train.py::_build_accum_step_fn`
run op by op, on the narrow EPiC flagship from the same parameters, with t
and the noise pinned per microbatch: one step over 2 microbatches, the loss,
AdamW's first moment (the clipped, accumulated gradient times 1 - b1) and
the parameters held by the bf16 gate |port_bf16 - jax_bf16| <
|jax_bf16 - jax_f32| (`tests/torch_port_helpers.py::hold_bf16`); the
accumulator, the parameters and the moments are float32. JAX's bfloat16
sums accumulate in float32 here, as torch's do (`jax_reductions_in_float32`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import torch

from particle_fm_tpu.parallel import train as jtrain
from particle_fm_tpu_torch.training import step as pstep
from tests.test_torch_train_bf16_step import (B, EMA, OPT, _all_float32, _jax_state, _named,
                                              _port_state)
from tests.torch_port_helpers import (YAML_FLAGSHIP, bf16_triple, cloud, draws, grads_by_name,
                                      hold_bf16, jax_reductions_in_float32, pin_draws, t)


def test_bf16_accumulation_closer_to_jax_bf16_than_jax_is_to_f32(monkeypatch):
    jax_reductions_in_float32(monkeypatch)
    jm, jm16, variables, pm16, net16 = bf16_triple(YAML_FLAGSHIP, fill=0.1)
    x, mask, cond, _ = cloud(b=2 * B, n=16, seed=3)
    ts, zs = draws(b=B, shape=(B,) + x.shape[1:], n_normals=1, steps=2, seed=4)
    split = lambda a: a.reshape((2, B) + a.shape[1:])
    jopt = jtrain.make_optimizer(**OPT)
    jax_runs = {}
    for name, model in (("f32", jm), ("bf16", jm16)):
        pin_draws(monkeypatch, ts, zs)
        step = jtrain._build_accum_step_fn(model, jopt, **EMA)
        with jax.disable_jit():
            state, loss = step(_jax_state(variables["params"], jopt), jax.random.PRNGKey(0),
                               *(jnp.asarray(split(a)) for a in (x, mask, cond)))
        adam = state.opt_state[1][0]
        jax_runs[name] = (float(loss), grads_by_name(adam.mu), grads_by_name(state.params))

    pin_draws(monkeypatch, ts, zs)
    opt = pstep.make_optimizer(**OPT)
    state = _port_state(pm16, net16, opt)
    loss = float(pstep.make_train_step(pm16, opt, accum=2, **EMA)(
        state, torch.Generator(), *(t(split(a)) for a in (x, mask, cond))))
    assert state.step == 1 and _all_float32(state)
    mu = _named(state, [state.opt_state.state[p]["exp_avg"] for p in state.params()])
    (l32, mu32, p32), (l16, mu16, p16) = jax_runs["f32"], jax_runs["bf16"]
    hold_bf16("accumulated first moment", (loss, mu), (l16, mu16), (l32, mu32))
    hold_bf16("accumulated step's parameters", (loss, _named(state, state.params())),
              (l16, p16), (l32, p32))
