"""Exponential moving average of parameters; counterpart of
particle_fm_tpu/training/ema.py.

ema <- ema - (1 - decay) * (ema - params) over every parameter, applied
from `start_step` every `every_n` steps, gated on the step counter before
it is incremented; otherwise the EMA copy is carried through unchanged.
The step counter may be a device tensor (the train step's, so that a
captured step reads no host value): the gate is then a device multiplier
of 1 - decay, 0 where the update is skipped.
"""

from __future__ import annotations

from typing import Sequence

import torch


@torch.no_grad()
def ema_update(
    ema_params: Sequence[torch.Tensor],
    params: Sequence[torch.Tensor],
    step: int | torch.Tensor,
    decay: float = 0.999,
    every_n: int = 1,
    start_step: int = 0,
) -> None:
    """Update `ema_params` in place from `params` (same order)."""
    if isinstance(step, torch.Tensor):
        rate = ((step >= start_step) & (step % every_n == 0)).to(torch.float32) * (1.0 - decay)
    elif step >= start_step and step % every_n == 0:
        rate = 1.0 - decay
    else:
        return
    ema_params, params = list(ema_params), [p.detach() for p in params]
    diff = torch._foreach_sub(ema_params, params)
    torch._foreach_mul_(diff, rate)
    torch._foreach_sub_(ema_params, diff)
