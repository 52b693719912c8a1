"""Diffusion samplers; counterpart of particle_fm_tpu/samplers/sde.py
(PC-JeDi): reverse-SDE Euler-Maruyama and deterministic DDIM.

The model callable is `model(t, x) -> predicted noise` with t a 0-dim
float32 diffusion time (cond and mask already closed over). The times are
the JAX scan's, t_k = 1 - float32(k) * (1/n_steps) and DDIM's
t_k - 1/n_steps, each rounded to float32 in the same order; they are built
on the CPU and moved to the device once, so the loop never waits on the
host. Euler-Maruyama draws one standard normal of x's shape per step, after
the network call, through `_normal`, so a test can replay the JAX stream;
or it reads each step's draw from a tensor `eps` (steps, *x.shape) handed
to it. As in the JAX package the per-step noise is not masked. A bfloat16
prediction is cast to the state's type where it meets the float32 schedule,
as JAX promotes it there.

Inside samplers/ode.py's `exported_loops()` (the exported program of
serving.py) each sampler is one `while_loop` of one step
(`ode.step_loop`): the times are computed there from a float32 step index
in the operations and order of `_times`, so the exported loop computes what
the Python loop computes, bit for bit. Euler-Maruyama takes `eps` there: a
program cannot hold a generator.
"""

from __future__ import annotations

from typing import Callable

import torch

from particle_fm_tpu_torch.losses.diffusion import VPDiffusionSchedule
from particle_fm_tpu_torch.samplers.ode import exporting, step_loop

NoiseModel = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _normal(generator: torch.Generator, shape, device: torch.device) -> torch.Tensor:
    """Standard-normal draw of one Euler-Maruyama step."""
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


def _times(n_steps: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor, float]:
    """(t_k, t_k - step, step) for k < n_steps, float32, on `device`."""
    step = 1.0 / n_steps
    t = 1.0 - torch.arange(n_steps, dtype=torch.float32) * step
    return t.to(device), (t - step).to(device), step


def _loop_times(n_steps: int, like: torch.Tensor):
    """t(k) = 1 - k * step for a float32 step index k on `like`'s device, as
    `_times` computes t_k, and step as a float32 there."""
    step = torch.full((), 1.0 / n_steps, dtype=torch.float32, device=like.device)
    return (lambda k: 1.0 - k * step), step


def ddim_predict(noisy, pred_noises, signal_rates, noise_rates):
    """One-jump estimate of x_0 from anywhere in the diffusion process."""
    return (noisy - noise_rates * pred_noises) / signal_rates


def ddim_sampler(model: NoiseModel, schedule: VPDiffusionSchedule, initial_noise: torch.Tensor,
                 n_steps: int = 50, clip_predictions: tuple | None = None) -> torch.Tensor:
    """Deterministic DDIM: predict x0, re-noise to the next time, repeat."""
    def advance(t, t_next, noisy, pred_data):
        signal_rates, noise_rates = schedule(t)
        pred_noises = model(t, noisy).to(noisy.dtype)
        pred_data = ddim_predict(noisy, pred_noises, signal_rates, noise_rates)
        if clip_predictions is not None:
            pred_data = torch.clamp(pred_data, *clip_predictions)
        next_signal, next_noise = schedule(t_next)
        return next_signal * pred_data + next_noise * pred_noises, pred_data

    if exporting():
        t_of, step = _loop_times(n_steps, initial_noise)

        def body(k, noisy, pred_data):
            t = t_of(k)
            return advance(t, t - step, noisy, pred_data)

        # the two carried states start from one tensor: the second as a copy
        return step_loop(body, (initial_noise, initial_noise.clone()), 0, n_steps)[1]
    ts, ts_next, _ = _times(n_steps, initial_noise.device)
    state = (initial_noise, initial_noise)
    for t, t_next in zip(ts, ts_next):
        state = advance(t, t_next, *state)
    return state[1]


def euler_maruyama_sampler(model: NoiseModel, schedule: VPDiffusionSchedule,
                           initial_noise: torch.Tensor, generator: torch.Generator | None = None,
                           n_steps: int = 50, clip_predictions: tuple | None = None,
                           noise_rows: tuple[int, slice] | None = None,
                           eps: torch.Tensor | None = None) -> torch.Tensor:
    """Reverse-SDE sampling: x += 0.5*beta*(x + 2*s)*dt + sqrt(beta*dt)*eps,
    with the score s = -pred_noise / noise_rate. Each step's eps is drawn
    from `generator`, or read from `eps` (n_steps, *x.shape) where it is
    given (the exported loop's form). With `noise_rows` = (n, rows) the
    state is `rows` of a batch of n (a rank's part of a rank-split sample):
    each step draws eps for the n sets and keeps those rows, so the ranks
    draw what one process draws."""
    if (generator is None) == (eps is None):
        raise ValueError("euler_maruyama_sampler takes its noise from a generator or from eps: "
                         "pass one of them")
    delta_t = 1.0 / n_steps

    def draw(k, shape, device):
        if eps is not None:  # k: the step, an int, or a float32 on the device in the loop
            return eps[k] if isinstance(k, int) else eps.index_select(
                0, k.to(torch.int64).reshape(1))[0]
        if noise_rows is None:
            return _normal(generator, shape, device)
        return _normal(generator, (noise_rows[0],) + shape[1:], device)[noise_rows[1]]

    def advance(t, k, x_t):
        pred_noises = model(t, x_t).to(x_t.dtype)
        _, noise_rates = schedule(t)
        s = -pred_noises / noise_rates
        betas = schedule.get_betas(t)
        noise = draw(k, x_t.shape, x_t.device)  # after the network call, as JAX splits its key
        x_t = x_t + 0.5 * betas * (x_t + 2.0 * s) * delta_t
        x_t = x_t + torch.sqrt(betas * delta_t) * noise
        if clip_predictions is not None:
            x_t = torch.clamp(x_t, *clip_predictions)
        return x_t

    if exporting():
        if eps is None:
            raise ValueError("an exported Euler-Maruyama loop reads its noise from eps")
        t_of, _ = _loop_times(n_steps, initial_noise)
        return step_loop(lambda k, x: (advance(t_of(k), k, x),), (initial_noise,), 0,
                         n_steps)[0]
    ts, _, _ = _times(n_steps, initial_noise.device)
    x_t = initial_noise
    for k, t in enumerate(ts):
        x_t = advance(t, k, x_t)
    return x_t
