"""Masked-set primitives; counterpart of particle_fm_tpu/ops/masked.py.

Point clouds are fixed-shape and padded:

    x    : (B, N, F)  particle features, padded with zeros
    mask : (B, N, 1)  1.0 for real particles, 0.0 for padding

The mean has no epsilon, as in the JAX package: a set with no real particle
gives 0/0. The caller guarantees at least one real particle per set.

Under sequence parallelism (parallel/mesh.py::sequence_parallel) each rank
holds its part of every set's particles: `meansum_pool` sums its sums and
counts over the model axis in one all-reduce, whose backward sums too
(every rank's pooled value reaches every rank's share of the loss).
"""

from __future__ import annotations

import torch

from particle_fm_tpu_torch.parallel.mesh import seq_reduce, sequence_axis


def apply_mask(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Zero out padded positions; None is a no-op."""
    if mask is None:
        return x
    return x * mask


def masked_sum(x: torch.Tensor, mask: torch.Tensor | None, dim: int = -2) -> torch.Tensor:
    """Sum over the particle axis, ignoring padding."""
    if mask is None:
        return torch.sum(x, dim=dim)
    return torch.sum(x * mask, dim=dim)


def masked_mean(
    x: torch.Tensor, mask: torch.Tensor | None, dim: int = -2, eps: float = 0.0
) -> torch.Tensor:
    """Mean over the particle axis, ignoring padding."""
    if mask is None:
        return torch.mean(x, dim=dim)
    s = torch.sum(x * mask, dim=dim)
    n = torch.sum(mask, dim=dim)
    if eps:
        n = n + eps
    return s / n


def meansum_pool(
    x: torch.Tensor, mask: torch.Tensor | None, sum_scale: float = 1e-2
) -> tuple[torch.Tensor, torch.Tensor]:
    """EPiC mean+sum pooling over particles: (mean, sum * sum_scale), each (B, F)."""
    seq = sequence_axis()
    if seq is not None:
        if mask is None:
            mask = torch.ones_like(x[..., :1])
        s = torch.sum(x * mask, dim=-2)
        both = seq_reduce(torch.cat([s, torch.sum(mask, dim=-2).to(s.dtype)], dim=-1), seq)
        s, n = both[..., :-1], both[..., -1:]
        return s / n, s * sum_scale
    if mask is None:
        s = torch.sum(x, dim=-2)
        m = s / x.shape[-2]
    else:
        s = torch.sum(x * mask, dim=-2)
        m = s / torch.sum(mask, dim=-2)
    return m, s * sum_scale


def _denominator(v: torch.Tensor, mask: torch.Tensor | None):
    if mask is None:
        return float(v.shape[0] * v.shape[1]) if v.ndim == 3 else float(v.shape[0])
    return torch.sum(mask)


def masked_mse(v: torch.Tensor, u: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """sum((v - u)^2) / mask.sum(): the numerator sums over all positions
    (padded slots give 0 when v and u are masked upstream), the denominator
    counts the real particles only."""
    return torch.sum(torch.square(v - u)) / _denominator(v, mask)


def huber(err: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber loss (torch.nn.HuberLoss semantics)."""
    abs_err = torch.abs(err)
    quad = 0.5 * torch.square(err)
    lin = delta * (abs_err - 0.5 * delta)
    return torch.where(abs_err <= delta, quad, lin)


def masked_huber(v: torch.Tensor, u: torch.Tensor, mask: torch.Tensor | None,
                 delta: float = 1.0) -> torch.Tensor:
    """sum(huber(v - u)) / mask.sum()."""
    return torch.sum(huber(v - u, delta)) / _denominator(v, mask)
