"""Learning-rate schedules; counterpart of particle_fm_tpu/training/lr_schedules.py.

Each returns lr(step), a function of the optimizer step. The schedules are
given in epochs; `steps_per_epoch` converts them to steps while keeping the
per-epoch trajectory. Step k's update uses lr(k), k optimizer steps taken
before it.
"""

from __future__ import annotations

import math


def cosine_warmup_schedule(base_lr: float, warmup: int, max_iters: int, steps_per_epoch: int = 1):
    """lr(step) = base * 0.5 (1 + cos(pi e / max_iters)) * min(1, e / warmup), e = epoch."""

    def schedule(step):
        e = step / steps_per_epoch
        factor = 0.5 * (1.0 + math.cos(math.pi * e / max_iters))
        if e <= warmup:
            factor = factor * e / warmup
        return base_lr * factor

    return schedule


def warmup_to_constant_schedule(base_lr: float, num_steps: int = 100, steps_per_epoch: int = 1):
    """Linear ramp from 0 to base_lr over num_steps epochs, then constant."""

    def schedule(step):
        return base_lr * min(step / steps_per_epoch / num_steps, 1.0)

    return schedule


def onecycle_cooldown_schedule(
    base_lr: float,
    warmup: int,
    cooldown: int,
    cooldown_final: int,
    max_lr: float,
    final_lr: float,
    steps_per_epoch: int = 1,
):
    """Warmup to max_lr, cosine down to base_lr, then cosine to final_lr, then flat."""

    def schedule(step):
        e = step / steps_per_epoch
        if e < warmup:
            return base_lr + (max_lr - base_lr) * min(e / warmup, 1.0)
        if e < warmup + cooldown:
            frac = min(max((e - warmup) / cooldown, 0.0), 1.0)
            return max_lr + (base_lr - max_lr) * 0.5 * (1 - math.cos(math.pi * frac))
        frac = min(max((e - warmup - cooldown) / cooldown_final, 0.0), 1.0)
        return base_lr + (final_lr - base_lr) * 0.5 * (1 - math.cos(math.pi * frac))

    return schedule


def build_lr(optimizer_cfg: dict, scheduler_cfg: dict | None, steps_per_epoch: int):
    """The learning rate of a model config's `optimizer` and `scheduler`
    blocks: a float, or a schedule over optimizer steps."""
    lr = optimizer_cfg.get("lr", 1e-3)
    if not scheduler_cfg:
        return lr
    name = scheduler_cfg.get("name")
    if name == "cosine_warmup":
        return cosine_warmup_schedule(
            lr, scheduler_cfg["warmup"], scheduler_cfg["max_iters"], steps_per_epoch
        )
    if name == "warmup_to_constant":
        return warmup_to_constant_schedule(lr, scheduler_cfg.get("num_steps", 100), steps_per_epoch)
    if name == "onecycle_cooldown":
        kw = {k: v for k, v in scheduler_cfg.items() if k != "name"}
        return onecycle_cooldown_schedule(lr, steps_per_epoch=steps_per_epoch, **kw)
    if name in (None, "none", "constant"):
        return lr
    raise ValueError(f"unknown scheduler {name}")


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0):
    """optax.warmup_cosine_decay_schedule over optimizer steps: linear from
    `init_value` to `peak_value` over `warmup_steps`, then a cosine from the
    peak to `end_value` at `decay_steps` (counted from step 0), flat after."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps

    def schedule(step):
        if step < warmup_steps:
            frac = 1.0 - max(step, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(step - warmup_steps, span)
        return peak_value * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / span)) + alpha)

    return schedule
