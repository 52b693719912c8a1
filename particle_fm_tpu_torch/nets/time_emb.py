"""Time embeddings; counterpart of particle_fm_tpu/nets/time_emb.py.

The cosine ladder uses frequencies exp(k) for k up to 2*frequencies-1
(about 2.9e13 at 16 frequencies), so one ulp in a frequency or in t changes
cos() completely. The frequency table is therefore built the reference's own
way (`exp(arange)` in float32; `cosine_frequencies`) and the float32
operations run in the reference's order, left to right:
((x + min) * freqs) * pi / (max + min). Callers that hold the table (CNF
keeps it as a buffer) pass it in, so a test can substitute the JAX table.

`GaussianFourierProjection` is the gaussian embedding's random projection.
Its `W` is a parameter that the forward pass detaches, as the flax module
holds it under `stop_gradient`: it gets a zero gradient, and AdamW's
decoupled weight decay still shrinks it and the EMA still tracks it, as
optax's adamw and the JAX EMA do. A buffer, or `requires_grad=False`, would
leave it unchanged and drift from the JAX run after the first step.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def sincos_embedding(t: torch.Tensor, frequencies: int) -> torch.Tensor:
    """cat(cos, sin) of t at frequencies 2^k * pi: (...,) -> (..., 2*frequencies)."""
    freqs = (2.0 ** torch.arange(frequencies, dtype=t.dtype, device=t.device)) * math.pi
    arg = t[..., None] * freqs
    return torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1)


def cosine_frequencies(
    outp_dim: int,
    frequency_scaling: str = "exponential",
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """The cosine encoding's frequency table."""
    if frequency_scaling == "exponential":
        return torch.exp(torch.arange(outp_dim, dtype=dtype, device=device))
    if frequency_scaling == "linear":
        return torch.arange(1, outp_dim + 1, dtype=dtype, device=device)
    raise ValueError(f"Unrecognised frequency scaling: {frequency_scaling}")


def cosine_encoding(
    x: torch.Tensor,
    outp_dim: int = 32,
    min_value: float = 0.0,
    max_value: float = 1.0,
    frequency_scaling: str = "exponential",
    freqs: torch.Tensor | None = None,
) -> torch.Tensor:
    """Cosine encoding over a ladder of frequencies: (...,) or (..., 1) -> (..., outp_dim)."""
    if x.ndim == 0:
        x = x[None]
    if x.shape[-1] != 1:
        x = x[..., None]
    if freqs is None:
        freqs = cosine_frequencies(outp_dim, frequency_scaling, x.dtype, x.device)
    return torch.cos((x + min_value) * freqs * math.pi / (max_value + min_value))


class GaussianFourierProjection(nn.Module):
    """t (...,) -> cat(sin, cos)(2 pi t W), (..., embed_dim); W ~ N(0, scale^2)."""

    def __init__(self, embed_dim: int, scale: float = 30.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.W = nn.Parameter(torch.randn(embed_dim // 2, generator=generator) * scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_proj = x[..., None] * self.W.detach() * 2 * math.pi
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


def time_embedding(
    t: torch.Tensor, t_emb: str, frequencies: int, freqs: torch.Tensor | None = None
) -> torch.Tensor:
    """Per-set parameter-free time embedding: t scalar or (B,) -> (B, 2*frequencies)."""
    if t.ndim == 0:
        t = t[None]
    if t_emb == "sincos":
        return sincos_embedding(t, frequencies)
    if t_emb == "cosine":
        return cosine_encoding(t, outp_dim=2 * frequencies, freqs=freqs)
    raise NotImplementedError(f"t_emb={t_emb} has parameters or is unknown")


def broadcast_time_embedding(
    t: torch.Tensor,
    n_particles: int,
    t_emb: str,
    frequencies: int,
    freqs: torch.Tensor | None = None,
) -> torch.Tensor:
    """t scalar or (B,) -> (B, N, 2*frequencies), a broadcast view."""
    emb = time_embedding(t, t_emb, frequencies, freqs)
    return emb[..., None, :].expand(*emb.shape[:-1], n_particles, emb.shape[-1])
