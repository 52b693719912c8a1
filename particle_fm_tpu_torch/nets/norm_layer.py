"""Iterative (running) normalisation layer, serving side; counterpart of
particle_fm_tpu/nets/norm_layer.py.

y = (x - mean) / (sqrt(var) + 1e-8) with statistics that were fitted during
training and are frozen here. `means`, `m2`, `vars` and `n` are buffers, so
they travel in the state dict as the flax module's "norm_stats" collection
travels in a checkpoint (utils/from_jax.py carries one into the other). For
set inputs (B, N, F) pass mask (B, N, 1): padding passes through unchanged.
The batched Welford update of the statistics belongs to training and is not
ported: `update_stats=True` raises.
"""

from __future__ import annotations

import torch
from torch import nn


class IterativeNormLayer(nn.Module):
    def __init__(self, inpt_dim: int, max_n: int = 500_000):
        super().__init__()
        self.inpt_dim, self.max_n = inpt_dim, max_n
        self.register_buffer("means", torch.zeros(inpt_dim))
        self.register_buffer("m2", torch.ones(inpt_dim))
        self.register_buffer("vars", torch.ones(inpt_dim))
        self.register_buffer("n", torch.zeros(()))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                update_stats: bool = False) -> torch.Tensor:
        if update_stats:
            raise NotImplementedError(
                "updating the normaliser's statistics is not ported: the port serves with "
                "frozen statistics, it does not train"
            )
        normed = (x - self.means) / (torch.sqrt(self.vars) + 1e-8)
        if mask is not None:
            normed = torch.where(mask > 0, normed, x)
        return normed

    def reverse(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        un = x * torch.sqrt(self.vars) + self.means
        if mask is not None:
            un = torch.where(mask > 0, un, x)
        return un
