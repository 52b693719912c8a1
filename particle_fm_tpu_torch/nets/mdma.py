"""MDMA: cross-attention flow network with a class token (calorimeter
showers); counterpart of particle_fm_tpu/nets/mdma.py.

Per layer a single class token attends over all particles, is mixed with the
conditioning (multiplicity and the optional global cond) and is broadcast
back to the particles. Module and parameter names follow the flax modules
(`embed`, `embed_cls`, `cond`, `block_{i}` with `fc0`, `fc0_cls`, `ln`,
`attn_q/k/v`, `attn_out`, `fc1_cls`, `fc2_cls`, `fc1`, and `out`), so
utils/from_jax.py maps one parameter tree onto the other by name. The
per-set inputs of the particle-wise layers (time, cond, the class token) go
through `WNDenseSplit`, never through a (B, N, hidden + extras) concat.

Differences of form: a module is given its input widths at construction
(flax infers them at the first call), and the time embedding arrives as the
per-set (B, T) tensor, where the JAX module takes (B, N, T) and slices its
first particle. `dtype` (None or bfloat16) is the compute type of every
Dense and of the LayerNorm, as the flax modules' (nets/common.py).

The class token's attention goes through `ops.attention.attention` with
`impl="auto"`: on the card, with at least 1024 particles and a head dim that
is a multiple of 128 (`num_heads=2` at hidden 256), that is the blockwise
flash kernel; the shipped 8 heads of 32 take the einsum path.
"""

from __future__ import annotations

import torch
from torch import nn

from particle_fm_tpu_torch.nets.common import LayerNorm, WNDense, WNDenseSplit, cat, leaky_relu
from particle_fm_tpu_torch.ops.attention import attention
from particle_fm_tpu_torch.parallel.mesh import refuse_under_sp

_LN_EPS = 1e-5


def _act(x: torch.Tensor | None) -> torch.Tensor | None:
    return None if x is None else leaky_relu(x, 0.01)


def _glu(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return a * torch.sigmoid(b)


class MDMABlock(nn.Module):
    """One layer. `t_dim` is the width of the time embedding, `cond_dim` that
    of the block's conditioning vector (multiplicity, then the global cond)."""

    def __init__(
        self,
        embed_dim: int,  # class-token (latent) dim
        hidden: int,
        t_dim: int,
        cond_dim: int,
        num_heads: int = 8,
        t_local_cat: bool = True,
        t_global_cat: bool = True,
        local_cat_cond: bool = False,
        global_cat_cond: bool = False,
        generator: torch.Generator | None = None,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        if hidden % num_heads:
            raise ValueError("hidden must be divisible by num_heads")
        self.hidden, self.num_heads = hidden, num_heads
        self.t_local_cat, self.t_global_cat = t_local_cat, t_global_cat
        self.local_cat_cond, self.global_cat_cond = local_cat_cond, global_cat_cond
        dense = dict(use_weight_norm=False, generator=generator, dtype=dtype)
        t_loc, t_glob = t_dim * t_local_cat, t_dim * t_global_cat
        c_loc, c_glob = int(local_cat_cond), int(global_cat_cond)
        self.fc0 = WNDenseSplit([(hidden, "particle"), (t_loc, "set"), (c_loc, "set")], hidden, **dense)
        self.fc0_cls = WNDense(embed_dim + t_glob + c_glob, hidden, **dense)
        self.ln = LayerNorm(hidden, eps=_LN_EPS, dtype=dtype)
        self.attn_q = WNDense(hidden, hidden, **dense)
        self.attn_k = WNDense(hidden, hidden, **dense)
        self.attn_v = WNDense(hidden, hidden, **dense)
        self.attn_out = WNDense(hidden, hidden, **dense)
        self.fc1_cls = WNDense(hidden + cond_dim + t_glob, embed_dim, **dense)
        self.fc2_cls = WNDense(embed_dim + t_glob + c_glob, embed_dim, **dense)
        self.fc1 = WNDenseSplit([(hidden, "particle"), (c_loc, "set"), (embed_dim, "set")], hidden,
                                **dense)

    def forward(self, x, x_cls, cond, mask, t_set):
        """x (B, N, hidden), x_cls (B, 1, embed_dim), cond (B, 1, cond_dim),
        mask (B, N, 1), t_set (B, T) -> (x, x_cls)."""
        res = x
        t_cls = t_set[:, None, :] if self.t_global_cat else None
        cond_set = cond[:, 0, -1:] if self.local_cat_cond else None
        cond_cls = cond[..., -1:] if self.global_cat_cond else None
        x_cls = cat(x_cls, t_cls, cond_cls)
        # fc0(act(cat(x, t, cond))): act is elementwise, so it distributes
        # over the segments
        x = self.fc0([(_act(x), "particle"),
                      (_act(t_set) if self.t_local_cat else None, "set"),
                      (_act(cond_set), "set")])
        x_cls = self.ln(self.fc0_cls(_act(x_cls)))

        # the class token attends over the particles
        def split(z):
            return z.view(*z.shape[:-1], self.num_heads, self.hidden // self.num_heads)

        a = attention(split(self.attn_q(x_cls)), split(self.attn_k(x)), split(self.attn_v(x)),
                      kv_mask=mask[..., 0])
        x_cls = self.attn_out(a.reshape(*a.shape[:-2], self.hidden))

        x_cls = self.fc1_cls(cat(x_cls, cond, t_cls))
        x_cls = self.fc2_cls(cat(x_cls, t_cls, cond_cls))
        # fc1(cat(x, cond, x_cls broadcast)) + res, without the concat
        x = self.fc1([(x, "particle"), (cond_set, "set"), (x_cls[:, 0, :], "set")]) + res
        return x, x_cls


class MDMA(nn.Module):
    """Stack of MDMA blocks. Call: (t_set (B, T), x (B, N, inpt_dim),
    cond (B, C) | None, mask (B, N, 1) | None) -> (B, N, out_features).

    `inpt_dim`, `t_dim` and `cond_dim` (the width of `cond` as it is passed)
    are construction-time widths; the other arguments are the flax module's
    fields (less `frequencies`, which it never reads).
    """

    def __init__(
        self,
        inpt_dim: int,
        t_dim: int,
        cond_dim: int = 0,
        out_features: int = 1,
        latent: int = 16,
        hidden_dim: int = 256,
        layers: int = 16,
        global_cond_dim: int = 0,
        t_local_cat: bool = True,
        t_global_cat: bool = True,
        avg_n: int = 30,
        num_heads: int = 8,
        local_cat_cond: bool = False,
        global_cat_cond: bool = False,
        dtype=None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.has_cond = global_cat_cond or global_cond_dim > 0
        if (self.has_cond or local_cat_cond) and cond_dim <= 0:
            raise ValueError("MDMA is configured with a global cond but cond_dim is 0")
        self.layers, self.avg_n = layers, avg_n
        self.t_local_cat, self.local_cat_cond = t_local_cat, local_cat_cond
        dense = dict(use_weight_norm=False, generator=generator, dtype=dtype)
        c_loc = int(local_cat_cond)
        cond_vec = 1 + cond_dim * self.has_cond  # multiplicity, then the global cond
        self.embed = WNDenseSplit([(inpt_dim, "particle"), (t_dim * t_local_cat, "set"),
                                   (c_loc, "set")], hidden_dim, **dense)
        self.embed_cls = WNDense(hidden_dim + cond_vec, latent, **dense)
        self.cond = WNDense(cond_vec, latent, **dense)
        for i in range(layers):
            self.add_module(f"block_{i}", MDMABlock(
                latent, hidden_dim, t_dim, cond_vec, num_heads=num_heads, t_local_cat=t_local_cat,
                t_global_cat=t_global_cat, local_cat_cond=local_cat_cond,
                global_cat_cond=global_cat_cond, generator=generator, dtype=dtype))
        self.out = WNDenseSplit([(hidden_dim, "particle"), (c_loc, "set")], out_features, **dense)

    def forward(self, t_set, x, cond=None, mask=None) -> torch.Tensor:
        refuse_under_sp("MDMA")
        if mask is None:
            mask = torch.ones_like(x[..., :1])
        if cond is None and (self.has_cond or self.local_cat_cond):
            raise ValueError("Was expecting a global cond but none given!")
        cond_set = cond[..., -1:] if self.local_cat_cond else None
        x = _act(self.embed([(x, "particle"), (t_set if self.t_local_cat else None, "set"),
                             (cond_set, "set")]))
        x = x * mask

        # class token: scaled sum pooling, multiplicity and the cond
        n_valid = mask.sum(dim=1, keepdim=True)  # (B, 1, 1)
        cond_vec = cat(n_valid, cond[:, None, :] if self.has_cond else None)
        x_cls = self.embed_cls(cat(x.sum(dim=1, keepdim=True) / self.avg_n, cond_vec))
        x_cls = _glu(cat(x_cls, self.cond(cond_vec)))

        for i in range(self.layers):
            x, x_cls = getattr(self, f"block_{i}")(x, x_cls, cond_vec, mask, t_set)

        x = self.out([(_act(x), "particle"), (_act(cond_set), "set")])
        return x * mask
