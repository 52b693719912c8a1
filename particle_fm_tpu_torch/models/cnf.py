"""CNF vector-field wrapper; counterpart of particle_fm_tpu/models/cnf.py.

The port carries the EPiC branch, the two PC-Droid transformer branches
(`droid_fulltransformer`, `droid_fullcrossattention`) and MDMA (`mdma`), the
last three configured through `net_config`, with the three time embeddings
(sincos, cosine, and gaussian: the random projection `gfp` through the
Dense layers `gfp_dense` and `gfp_out` with the activation between, always
in float32 as the flax CNF's Dense layers have no dtype), self-conditioning (the field reads cat(x,
x1_hat), x1_hat its own endpoint estimate, zeros when none is given), and the
in-model normalisers of `CNFStack`. The EPiC
branch takes `dropout`, which the JAX CNF hands its EPiC encoder; the
flow-matching loss runs the network deterministic there, as here. The
cosine ladder's frequency table is a non-persistent buffer built on the CPU
the reference's way (see nets/time_emb.py); a test may overwrite it with the
JAX package's table.

`dtype` (None or bfloat16) is the networks' compute type (nets/common.py).
The time embedding is computed in t's type (float32) and cast to x's, as
the JAX CNF casts it (`models/cnf.py:140`): x is the solver's float32
state, so the embedding reaches the networks in float32 and each Dense
casts it.

One convention inside the port: the network is handed the per-set time
embedding (B, T). The JAX CNF hands its networks a (B, N, T) broadcast, and
its transformers and MDMA slice the first particle back out (`t[..., 0, :]`,
`t[:, 0, :]`, `t_in[:, :1, :]`).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from particle_fm_tpu_torch.nets.common import WNDense, get_act
from particle_fm_tpu_torch.nets.epic import EPiCEncoder
from particle_fm_tpu_torch.nets.mdma import MDMA
from particle_fm_tpu_torch.nets.norm_layer import IterativeNormLayer
from particle_fm_tpu_torch.nets.transformer import FullCrossAttentionEncoder, FullTransformerEncoder
from particle_fm_tpu_torch.nets.time_emb import (GaussianFourierProjection, cosine_frequencies,
                                                 time_embedding)


class CNF(nn.Module):
    """One flow transform: time embedding + vector-field network."""

    def __init__(
        self,
        model: str = "epic",
        features: int = 3,
        frequencies: int = 6,
        hidden_dim: int = 128,
        layers: int = 8,
        global_cond_dim: int = 0,
        local_cond_dim: int = 0,
        latent: int = 16,
        activation: str = "leaky_relu",
        use_weight_norm: bool = True,
        t_local_cat: bool = False,
        t_global_cat: bool = False,
        add_time_to_input: bool = True,
        t_emb: str = "sincos",
        sum_scale: float = 1e-2,
        dropout: float = 0.0,
        net_config: Mapping[str, Any] | None = None,
        self_cond: bool = False,
        generator: torch.Generator | None = None,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        if t_emb not in ("sincos", "cosine", "gaussian"):
            raise NotImplementedError(f"Unknown time embedding t_emb={t_emb}")
        self.frequencies = frequencies
        self.t_emb = t_emb
        self.activation = activation
        self.add_time_to_input = add_time_to_input
        self.self_cond = self_cond
        t_dim = 2 * frequencies
        if t_emb == "gaussian":
            self.gfp = GaussianFourierProjection(hidden_dim, generator=generator)
            self.gfp_dense = WNDense(hidden_dim // 2 * 2, hidden_dim, use_weight_norm=False,
                                     generator=generator)
            self.gfp_out = WNDense(hidden_dim, t_dim, use_weight_norm=False, generator=generator)
        point_feats = 2 * features if self_cond else features
        in_feats = point_feats + t_dim if add_time_to_input else point_feats
        freqs = cosine_frequencies(t_dim) if t_emb == "cosine" else torch.empty(0)
        self.register_buffer("cos_freqs", freqs, persistent=False)
        encoders = {"droid_fulltransformer": FullTransformerEncoder,
                    "droid_fullcrossattention": FullCrossAttentionEncoder}
        if model in encoders:
            self.net = encoders[model](
                in_feats, outp_dim=features, ctxt_dim=global_cond_dim + t_dim,
                generator=generator, dtype=dtype, **dict(net_config or {}),
            )
            return
        if model == "mdma":
            cfg = dict(net_config or {})
            cfg.setdefault("out_features", features)
            self.net = MDMA(in_feats, t_dim, cond_dim=global_cond_dim, generator=generator,
                            dtype=dtype, **cfg)
            return
        if model != "epic":
            raise NotImplementedError(
                f"model={model} is not ported (the port carries epic, droid_fulltransformer, "
                "droid_fullcrossattention and mdma)"
            )
        if net_config:
            raise NotImplementedError("net_config for the epic model is not ported")
        self.net = EPiCEncoder(
            in_feats=in_feats,
            feats=features,
            hid_dim=hidden_dim,
            latent_dim=latent,
            equiv_layers=layers,
            t_dim=t_dim,
            cond_dim=global_cond_dim,
            global_cond_dim=global_cond_dim,
            local_cond_dim=local_cond_dim,
            t_local_cat=t_local_cat,
            t_global_cat=t_global_cat,
            activation=activation,
            use_weight_norm=use_weight_norm,
            sum_scale=sum_scale,
            dropout=dropout,
            generator=generator,
            dtype=dtype,
        )

    def time_embedding(self, t: torch.Tensor) -> torch.Tensor:
        """t scalar or (B,) -> the per-set embedding (B, 2*frequencies), in t's type."""
        if self.t_emb == "gaussian":
            if t.ndim == 0:
                t = t[None]
            emb = get_act(self.activation)(self.gfp_dense(self.gfp(t)))
            return self.gfp_out(emb)
        freqs = self.cos_freqs if self.t_emb == "cosine" else None
        return time_embedding(t, self.t_emb, self.frequencies, freqs)

    def forward(
        self,
        t: torch.Tensor,
        x: torch.Tensor,
        cond: torch.Tensor | None = None,
        mask: torch.Tensor | None = None,
        x_sc: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """t: scalar or (B,) -> v(t, x) of x's shape; `x_sc` is the
        self-conditioning estimate."""
        if self.self_cond:
            x = torch.cat([x, torch.zeros_like(x) if x_sc is None else x_sc], dim=-1)
        b, n, _ = x.shape
        emb = self.time_embedding(t).to(x.dtype)
        # scalar sampling times give batch-1 embeddings; broadcast to x's batch
        emb = emb.expand(b, emb.shape[-1])
        if self.add_time_to_input:
            x = torch.cat([emb[:, None, :].expand(b, n, emb.shape[-1]), x], dim=-1)
        return self.net(emb, x, cond, mask)


class CNFStack(nn.Module):
    """`n_transforms` CNFs applied in sequence, and the optional in-model
    normalisers (`normaliser` for the features, `ctxt_normaliser` for the
    global cond), whose statistics the training loss updates."""

    def __init__(self, n_transforms: int = 1, features: int = 3, global_cond_dim: int = 0,
                 use_normaliser: bool = False, normaliser_config: Mapping[str, Any] | None = None,
                 generator: torch.Generator | None = None, **cnf_config):
        super().__init__()
        self.flows = nn.ModuleList(
            CNF(features=features, global_cond_dim=global_cond_dim, generator=generator,
                **cnf_config)
            for _ in range(n_transforms)
        )
        if use_normaliser:
            self.normaliser = IterativeNormLayer(features, **dict(normaliser_config or {}))
            if global_cond_dim > 0:
                self.ctxt_normaliser = IterativeNormLayer(global_cond_dim,
                                                          **dict(normaliser_config or {}))

    def forward(self, t, x, cond=None, mask=None, x_sc=None):
        """Vector field v(t, x): the composition of all flow transforms."""
        for flow in self.flows:
            x = flow(t, x, cond=cond, mask=mask, x_sc=x_sc)
        return x

    def flow_k(self, k: int, t, x, cond=None, mask=None, x_sc=None):
        """Apply a single flow transform (for per-flow ODE integration)."""
        return self.flows[k](t, x, cond=cond, mask=mask, x_sc=x_sc)

    def normalise(self, x, mask=None, update_stats: bool = False):
        return self.normaliser(x, mask, update_stats=update_stats)

    def normalise_cond(self, cond, update_stats: bool = False):
        return self.ctxt_normaliser(cond, update_stats=update_stats)

    def reverse_norm(self, x, mask=None):
        return self.normaliser.reverse(x, mask)
