"""Exponential moving average of parameters; counterpart of
particle_fm_tpu/training/ema.py.

ema <- ema - (1 - decay) * (ema - params) over every parameter, applied
from `start_step` every `every_n` steps, gated on the step counter before
it is incremented; otherwise the EMA copy is carried through unchanged.
"""

from __future__ import annotations

from typing import Sequence

import torch


@torch.no_grad()
def ema_update(
    ema_params: Sequence[torch.Tensor],
    params: Sequence[torch.Tensor],
    step: int,
    decay: float = 0.999,
    every_n: int = 1,
    start_step: int = 0,
) -> None:
    """Update `ema_params` in place from `params` (same order)."""
    if not (step >= start_step and step % every_n == 0):
        return
    ema_params, params = list(ema_params), [p.detach() for p in params]
    diff = torch._foreach_sub(ema_params, params)
    torch._foreach_mul_(diff, 1.0 - decay)
    torch._foreach_sub_(ema_params, diff)
