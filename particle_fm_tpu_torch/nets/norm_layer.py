"""Iterative (running) normalisation layer; counterpart of
particle_fm_tpu/nets/norm_layer.py.

y = (x - mean) / (sqrt(var) + 1e-8) with statistics fitted online from the
training batches. `means`, `m2`, `vars` and `n` are buffers, so they travel
in the state dict as the flax module's "norm_stats" collection travels in a
checkpoint (utils/from_jax.py carries one into the other). For set inputs
(B, N, F) pass mask (B, N, 1): the statistics are over real particles only
and padding passes through unchanged.

`update_stats=True` first updates the statistics in place, without
gradient and in float32, as the JAX layer does: the first batch is a plain
masked fit (the variance over max(c - 1, 1), c the number of real rows),
each later one a batched Welford update, and nothing changes once `n`
reaches `max_n`. The input is then normalised with the updated statistics.

Under data parallelism (`shard`, parallel/dist.py) x is this rank's rows:
the masked sums are summed over the ranks in two rounds (the count, the
sum and the sum about the old means; then the two sums about the new
means), so that every rank updates its statistics from the global batch,
in the JAX layer's formulas.
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
                update_stats: bool = False, shard=None) -> torch.Tensor:
        if update_stats:
            self.update(x, mask, shard)
        normed = (x - self.means) / (torch.sqrt(self.vars) + 1e-8)
        if mask is not None:
            normed = torch.where(mask > 0, normed, x)
        return normed

    @torch.no_grad()
    def update(self, x: torch.Tensor, mask: torch.Tensor | None = None, shard=None) -> None:
        """One masked Welford update of the statistics from the batch x (the
        global batch, with a `shard`)."""
        flat = x.reshape(-1, x.shape[-1]).float()
        w = (mask.reshape(-1, 1).float() if mask is not None
             else torch.ones((flat.shape[0], 1), dtype=torch.float32, device=x.device))
        n, means, m2 = self.n, self.means, self.m2
        c, w_sum, d_sum = self._total(shard, torch.sum(w), torch.sum(flat * w, dim=0),
                                      torch.sum((flat - means) * w, dim=0))
        w_mean = w_sum / c
        new_n = n + c
        upd_means = means + d_sum / new_n
        v_sum, m_sum = self._total(shard, torch.sum(torch.square(flat - w_mean) * w, dim=0),
                                   torch.sum((flat - means) * (flat - upd_means) * w, dim=0))
        w_var = v_sum / torch.clamp(c - 1.0, min=1.0)
        upd_m2 = m2 + m_sum
        first, frozen = n == 0, n >= self.max_n
        for buf, fit, welford in ((self.means, w_mean, upd_means),
                                  (self.m2, w_var * c, upd_m2),
                                  (self.vars, w_var, upd_m2 / new_n),
                                  (self.n, c, new_n)):
            buf.copy_(torch.where(frozen, buf, torch.where(first, fit, welford)))

    @staticmethod
    def _total(shard, *sums: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """The sums over the ranks, in one collective (as given without a shard)."""
        if shard is None:
            return sums
        flat = shard.total(torch.cat([s.reshape(-1) for s in sums]))
        return tuple(part.reshape(s.shape) for part, s in
                     zip(torch.split(flat, [s.numel() for s in sums]), sums))

    def reverse(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        un = x * torch.sqrt(self.vars) + self.means
        if mask is not None:
            un = torch.where(mask > 0, un, x)
        return un
