"""ParT-style jet classifier, a transformer with pairwise interaction
attention; counterpart of particle_fm_tpu/nets/part.py.

For every particle pair (i, j) four kinematic features (ln Delta, ln kT,
ln z, ln m^2 of the massless pair) are embedded by a per-pair MLP
(`PairEmbed`) into one bias per head, computed once and added to the
attention logits of every encoder layer. The attention is
`ops/attention.py::attention` with `impl="auto"` and that bias, which is
the einsum path on every device, as in the JAX package: the (B, H, N, N)
bias and the (B, N, N, C) pair activations are materialised. The class
readout is a learnable token (`cls_token`) through `num_cls_layers`
cross-attention layers.

Module and parameter names follow the flax modules (`pair_embed`,
`input_norm`, `embed_{i}`, `encoder`, `cls_layer_{i}`, `final_norm`,
`head`), so utils/from_jax.py carries one tree into the other.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from particle_fm_tpu_torch.nets.common import LayerNorm, WNDense
from particle_fm_tpu_torch.nets.transformer import (TransformerCrossAttentionLayer,
                                                    TransformerEncoder)

EPS = 1e-8


def truncated_normal(shape: tuple[int, ...], std: float,
                     generator: torch.Generator | None) -> torch.Tensor:
    """flax's truncated_normal(std): a normal truncated at +-2 standard
    deviations, scaled so that the truncated draw has standard deviation
    `std` (drawn by the inverse CDF)."""
    lo, hi = (0.5 * (1.0 + math.erf(v / math.sqrt(2.0))) for v in (-2.0, 2.0))
    u = torch.rand(shape, generator=generator) * (hi - lo) + lo
    return torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0) * (std / 0.87962566103423978)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def pairwise_features(pt, eta, phi, mask):
    """ParT pairwise interaction features for massless particles.

    pt/eta/phi: (B, N); mask: (B, N, 1) or None. Returns (features
    (B, N, N, 4), pair mask (B, N, N, 1)), the features of padded pairs
    zeroed. Padded entries are zeroed before the transcendental math, so
    that cosh cannot overflow into inf * 0. The phi wrap is a floor-mod, as
    jnp's `%` on floats."""
    m = torch.ones_like(pt) if mask is None else mask[..., 0]
    pm = (m[:, :, None] * m[:, None, :])[..., None]
    pt, eta, phi = pt * m, eta * m, phi * m

    deta = eta[:, :, None] - eta[:, None, :]
    dphi = phi[:, :, None] - phi[:, None, :]
    dphi = torch.remainder(dphi + math.pi, 2.0 * math.pi) - math.pi
    delta2 = torch.clamp(deta**2 + dphi**2, min=EPS)
    delta = torch.sqrt(delta2)

    pt_i = torch.clamp(pt, min=EPS)
    ptmin = torch.minimum(pt_i[:, :, None], pt_i[:, None, :])
    ptsum = pt_i[:, :, None] + pt_i[:, None, :]

    lndelta = 0.5 * torch.log(delta2)
    lnkt = torch.log(torch.clamp(ptmin * delta, min=EPS))
    lnz = torch.log(torch.clamp(ptmin / ptsum, min=EPS))
    m2 = 2.0 * pt_i[:, :, None] * pt_i[:, None, :] * (torch.cosh(deta) - torch.cos(dphi))
    lnm2 = torch.log(torch.clamp(m2, min=EPS))

    feats = torch.stack([lndelta, lnkt, lnz, lnm2], dim=-1)
    return feats * pm, pm


class PairEmbed(nn.Module):
    """Per-pair MLP (Dense, LayerNorm, gelu per width): 4 interaction
    features -> one bias per attention head, (B, N, N, 4) -> (B, H, N, N)."""

    def __init__(self, num_heads: int, dims: Sequence[int] = (64, 64, 64), in_dim: int = 4,
                 generator: torch.Generator | None = None, dtype: torch.dtype | None = None):
        super().__init__()
        self.depth = len(dims)
        widths = [in_dim] + list(dims)
        for i in range(self.depth):
            self.add_module(f"lin_{i}", WNDense(widths[i], widths[i + 1], use_weight_norm=False,
                                                generator=generator, dtype=dtype))
            self.add_module(f"nrm_{i}", LayerNorm(widths[i + 1], eps=1e-5, dtype=dtype))
        self.out = WNDense(widths[-1], num_heads, use_weight_norm=False, generator=generator,
                           dtype=dtype)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        h = feats
        for i in range(self.depth):
            h = _gelu(getattr(self, f"nrm_{i}")(getattr(self, f"lin_{i}")(h)))
        return self.out(h).permute(0, 3, 1, 2)


class ParTClassifierNet(nn.Module):
    """Particle Transformer classifier with pairwise interaction attention.

    x (B, N, F) holds the kinematic channels at `eta_idx`, `phi_idx` and
    `pt_idx`; `pt_transform` recovers pt from its column: "log_scaled"
    exp(f / 0.7 + 1.7), "log" exp(f), "identity" f. With `kin_means` and
    `kin_stds` (per input feature) the columns are un-normalised first, so
    that the pair features see physical kinematics.

    Call: (x, mask (B, N, 1) | None, cond ignored) -> logits (B, n_classes)
    """

    def __init__(
        self,
        in_feats: int,
        n_classes: int = 2,
        embed_dims: Sequence[int] = (128, 512, 128),
        num_heads: int = 8,
        num_layers: int = 8,
        num_cls_layers: int = 2,
        pair_embed_dims: Sequence[int] = (64, 64, 64),
        ffn_mult: int = 4,
        eta_idx: int = 0,
        phi_idx: int = 1,
        pt_idx: int = 2,
        pt_transform: str = "log_scaled",
        kin_means: Sequence[float] | None = None,
        kin_stds: Sequence[float] | None = None,
        generator: torch.Generator | None = None,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        if pt_transform not in ("log_scaled", "log", "identity"):
            raise ValueError(f"unknown pt_transform {pt_transform}")
        self.eta_idx, self.phi_idx, self.pt_idx = eta_idx, phi_idx, pt_idx
        self.pt_transform = pt_transform
        self.num_cls_layers = num_cls_layers
        self.kin = None if kin_means is None else (tuple(kin_means), tuple(kin_stds))
        model_dim = int(embed_dims[-1])
        self.pair_embed = PairEmbed(num_heads, tuple(pair_embed_dims), generator=generator,
                                    dtype=dtype)
        self.input_norm = LayerNorm(in_feats, eps=1e-5, dtype=dtype)
        widths = [in_feats] + [int(d) for d in embed_dims]
        self.num_embed = len(embed_dims)
        for i in range(self.num_embed):
            self.add_module(f"embed_{i}", WNDense(widths[i], widths[i + 1], use_weight_norm=False,
                                                  generator=generator, dtype=dtype))
        dense = {"hddn_dim": ffn_mult * model_dim, "act_h": "gelu"}
        self.encoder = TransformerEncoder(model_dim=model_dim, num_layers=num_layers,
                                          mha_config={"num_heads": num_heads}, dense_config=dense,
                                          generator=generator, dtype=dtype)
        self.cls_token = nn.Parameter(truncated_normal((1, 1, model_dim), 0.02, generator))
        for i in range(num_cls_layers):
            self.add_module(f"cls_layer_{i}", TransformerCrossAttentionLayer(
                model_dim, mha_config={"num_heads": num_heads}, dense_config=dense,
                generator=generator, dtype=dtype))
        self.final_norm = LayerNorm(model_dim, eps=1e-5, dtype=dtype)
        self.head = WNDense(model_dim, n_classes, use_weight_norm=False, generator=generator,
                            dtype=dtype)

    def forward(self, x, mask=None, cond=None) -> torch.Tensor:
        m = torch.ones_like(x[..., 0]) if mask is None else mask[..., 0]
        x_kin = x
        if self.kin is not None:
            mu = torch.tensor(self.kin[0], dtype=x.dtype, device=x.device)
            sd = torch.tensor(self.kin[1], dtype=x.dtype, device=x.device)
            x_kin = x * sd + mu
        eta, phi, f_pt = (x_kin[..., i] for i in (self.eta_idx, self.phi_idx, self.pt_idx))
        if self.pt_transform == "log_scaled":
            pt = torch.exp(f_pt / 0.7 + 1.7) * m
        elif self.pt_transform == "log":
            pt = torch.exp(f_pt) * m
        else:
            pt = f_pt
        feats, _ = pairwise_features(pt, eta, phi, mask)
        attn_bias = self.pair_embed(feats)

        h = self.input_norm(x)
        for i in range(self.num_embed):
            h = _gelu(getattr(self, f"embed_{i}")(h))
        h = self.encoder(h, mask=m, attn_bias=attn_bias)

        cls = self.cls_token.expand(h.shape[0], 1, -1).to(h.dtype)
        for i in range(self.num_cls_layers):
            cls = getattr(self, f"cls_layer_{i}")(cls, h, kv_mask=m)
        return self.head(self.final_norm(cls[:, 0]))
