"""Continuous-time VP cosine diffusion schedule; counterpart of
particle_fm_tpu/losses/diffusion.py (PC-JeDi).

signal_rate(t) = cos(angle(t)),  noise_rate(t) = sin(angle(t))
angle(t) = acos(max_sr) + t * (acos(min_sr) - acos(max_sr))
beta(t)  = 2 * (acos(min_sr) - acos(max_sr)) * tan(angle(t))

The two angles are taken with `math.acos` in float64; the rest is float32
tensor arithmetic in the JAX package's order, each Python float rounded to
float32 where it meets a tensor (as JAX's weak types round it), so no
constant is copied to the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


def _angles(t: torch.Tensor, max_sr: float, min_sr: float) -> tuple[torch.Tensor, float]:
    start, end = math.acos(max_sr), math.acos(min_sr)
    return start + t * (end - start), end - start


def cosine_diffusion_schedule(t: torch.Tensor, max_sr: float = 1.0, min_sr: float = 1e-2
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(signal_rates, noise_rates) for diffusion times t in [0, 1]."""
    angles, _ = _angles(t, max_sr, min_sr)
    return torch.cos(angles), torch.sin(angles)


def cosine_beta_schedule(t: torch.Tensor, max_sr: float = 1.0, min_sr: float = 1e-2
                         ) -> torch.Tensor:
    """Continuous beta(t) of the VP SDE under the cosine schedule."""
    angles, span = _angles(t, max_sr, min_sr)
    return 2.0 * span * torch.tan(angles)


@dataclass(frozen=True)
class VPDiffusionSchedule:
    max_sr: float = 1.0
    min_sr: float = 1e-2

    def __call__(self, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return cosine_diffusion_schedule(t, self.max_sr, self.min_sr)

    def get_betas(self, t: torch.Tensor) -> torch.Tensor:
        return cosine_beta_schedule(t, self.max_sr, self.min_sr)
