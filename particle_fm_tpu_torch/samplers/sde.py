"""Diffusion samplers; counterpart of particle_fm_tpu/samplers/sde.py
(PC-JeDi): reverse-SDE Euler-Maruyama and deterministic DDIM.

The model callable is `model(t, x) -> predicted noise` with t a 0-dim
float32 diffusion time (cond and mask already closed over). The times are
the JAX scan's, t_k = 1 - float32(k) * (1/n_steps) and DDIM's
t_k - 1/n_steps, each rounded to float32 in the same order; they are built
on the CPU and moved to the device once, so the loop never waits on the
host. Euler-Maruyama draws one standard normal of x's shape per step, after
the network call, through `_normal`, so a test can replay the JAX stream.
As in the JAX package the per-step noise is not masked. A bfloat16
prediction is cast to the state's type where it meets the float32 schedule,
as JAX promotes it there.
"""

from __future__ import annotations

from typing import Callable

import torch

from particle_fm_tpu_torch.losses.diffusion import VPDiffusionSchedule

NoiseModel = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _normal(generator: torch.Generator, shape, device: torch.device) -> torch.Tensor:
    """Standard-normal draw of one Euler-Maruyama step."""
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


def _times(n_steps: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor, float]:
    """(t_k, t_k - step, step) for k < n_steps, float32, on `device`."""
    step = 1.0 / n_steps
    t = 1.0 - torch.arange(n_steps, dtype=torch.float32) * step
    return t.to(device), (t - step).to(device), step


def ddim_predict(noisy, pred_noises, signal_rates, noise_rates):
    """One-jump estimate of x_0 from anywhere in the diffusion process."""
    return (noisy - noise_rates * pred_noises) / signal_rates


def ddim_sampler(model: NoiseModel, schedule: VPDiffusionSchedule, initial_noise: torch.Tensor,
                 n_steps: int = 50, clip_predictions: tuple | None = None) -> torch.Tensor:
    """Deterministic DDIM: predict x0, re-noise to the next time, repeat."""
    ts, ts_next, _ = _times(n_steps, initial_noise.device)
    noisy = pred_data = initial_noise
    for t, t_next in zip(ts, ts_next):
        signal_rates, noise_rates = schedule(t)
        pred_noises = model(t, noisy).to(noisy.dtype)
        pred_data = ddim_predict(noisy, pred_noises, signal_rates, noise_rates)
        if clip_predictions is not None:
            pred_data = torch.clamp(pred_data, *clip_predictions)
        next_signal, next_noise = schedule(t_next)
        noisy = next_signal * pred_data + next_noise * pred_noises
    return pred_data


def euler_maruyama_sampler(model: NoiseModel, schedule: VPDiffusionSchedule,
                           initial_noise: torch.Tensor, generator: torch.Generator,
                           n_steps: int = 50, clip_predictions: tuple | None = None,
                           noise_rows: tuple[int, slice] | None = None) -> torch.Tensor:
    """Reverse-SDE sampling: x += 0.5*beta*(x + 2*s)*dt + sqrt(beta*dt)*eps,
    with the score s = -pred_noise / noise_rate. With `noise_rows` = (n,
    rows) the state is `rows` of a batch of n (a rank's part of a rank-split
    sample): each step draws eps for the n sets and keeps those rows, so
    the ranks draw what one process draws."""
    ts, _, delta_t = _times(n_steps, initial_noise.device)
    x_t = initial_noise
    for t in ts:
        pred_noises = model(t, x_t).to(x_t.dtype)
        _, noise_rates = schedule(t)
        s = -pred_noises / noise_rates
        betas = schedule.get_betas(t)
        if noise_rows is None:
            eps = _normal(generator, x_t.shape, x_t.device)
        else:
            eps = _normal(generator, (noise_rows[0],) + x_t.shape[1:], x_t.device)[noise_rows[1]]
        x_t = x_t + 0.5 * betas * (x_t + 2.0 * s) * delta_t
        x_t = x_t + torch.sqrt(betas * delta_t) * eps
        if clip_predictions is not None:
            x_t = torch.clamp(x_t, *clip_predictions)
    return x_t
