"""EPiC (Equivariant Point Cloud) generator; counterpart of particle_fm_tpu/nets/epic.py.

Parameter names follow the JAX modules (`fc_global1`, `fc_local1`,
`epic_layer_0`, ...), so utils/from_jax.py maps one tree onto the other by
name. The time embedding is per set: where the JAX modules take t as
(B, N, T) and slice its first particle, these take the (B, T) slice itself.

After `fold()` (weight norm folded once, before sampling) an `EPiCLayer`
runs through `ops.epic_layer.epic_layer`: the fused CUDA kernel for CUDA
tensors, its plain PyTorch version for CPU tensors. Unfolded, it runs the
concat-free module path below, which holds the same arithmetic.

`dtype` (None or bfloat16) is the compute type of every Dense, as in the
JAX modules. In bfloat16 the module path rounds where the JAX module rounds
(after every Dense); the folded path hands the fused layer bfloat16 weights,
x, g and per-set features (the mask stays float32), and the layer rounds
where the Pallas kernel rounds (ops/epic_layer.py::epic_layer_reference).
"""

from __future__ import annotations

import torch
from torch import nn

from particle_fm_tpu_torch.nets.common import WNDense, WNDenseSplit, cat, get_act
from particle_fm_tpu_torch.ops import epic_layer as epic_layer_ops
from particle_fm_tpu_torch.ops.masked import meansum_pool


def _split_set_rows(w: torch.Tensor, t: int, h: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(in, out) weight over cat(t, x (h wide), rest) -> (x rows, cat(t rows, rest rows))."""
    return w[t : t + h].contiguous(), torch.cat([w[:t], w[t + h :]], dim=0).contiguous()


class EPiCLayer(nn.Module):
    """One EPiC global-local block: (x_global (B, L), x_local (B, N, H)) ->
    updated (x_global, x_local). `cond_dim` is the width of the conditioning
    vector; it enters the global MLPs when `global_cond_dim > 0` and the
    local ones when `local_cond_dim > 0`, as in the JAX layer."""

    def __init__(
        self,
        hid_dim: int = 256,
        latent_dim: int = 16,
        t_dim: int = 0,
        cond_dim: int = 0,
        global_cond_dim: int = 0,
        local_cond_dim: int = 0,
        t_local_cat: bool = False,
        t_global_cat: bool = False,
        activation: str = "leaky_relu",
        use_weight_norm: bool = True,
        sum_scale: float = 1e-2,
        generator: torch.Generator | None = None,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.hid_dim = hid_dim
        self.latent_dim = latent_dim
        self.activation = activation
        self.sum_scale = sum_scale
        self.dtype = dtype
        self.tg = t_dim if t_global_cat else 0
        self.tl = t_dim if t_local_cat else 0
        self.gc = cond_dim if global_cond_dim > 0 else 0
        self.lc = cond_dim if local_cond_dim > 0 else 0
        h, lat = hid_dim, latent_dim
        wn = dict(use_weight_norm=use_weight_norm, generator=generator, dtype=dtype)
        self.fc_global1 = WNDense(self.tg + 2 * h + lat + self.gc, h, **wn)
        self.fc_global2 = WNDense(self.tg + h + self.gc, lat, **wn)
        self.fc_local1 = WNDenseSplit(
            [(self.tl, "set"), (h, "particle"), (lat, "set"), (self.lc, "set")], h, **wn
        )
        self.fc_local2 = WNDenseSplit(
            [(self.tl, "set"), (h, "particle"), (self.lc, "set")], h, **wn
        )
        self._kernel_weights: dict[str, torch.Tensor] | None = None

    @torch.no_grad()
    def fold(self) -> None:
        """Fold weight norm (in float32) and cut the weights into the fused
        layer's layout (`ops/epic_layer.py`), cast to `dtype` when it is set
        (then also laying them out as the bfloat16 kernels read them:
        `bf16_weight_image`), once."""
        if self.activation != "leaky_relu":
            raise NotImplementedError(f"the fused EPiC layer computes leaky_relu, not {self.activation}")
        fcs = (self.fc_global1, self.fc_global2, self.fc_local1, self.fc_local2)
        for fc in fcs:
            fc.fold()
        wg1, wg2, w1, w2 = (fc.effective_weight().t() for fc in fcs)
        w1x, w1s = _split_set_rows(w1, self.tl, self.hid_dim)
        w2x, w2s = _split_set_rows(w2, self.tl, self.hid_dim)
        weights = dict(
            wg1=wg1.contiguous(), bg1=self.fc_global1.bias.detach(),
            wg2=wg2.contiguous(), bg2=self.fc_global2.bias.detach(),
            w1x=w1x, w1s=w1s, b1=self.fc_local1.bias.detach(),
            w2x=w2x, w2s=w2s, b2=self.fc_local2.bias.detach(),
        )
        if self.dtype is not None:
            weights = {k: w.to(self.dtype) for k, w in weights.items()}
            # the bfloat16 kernels' image of the weights, laid out once
            weights["weight_image"] = epic_layer_ops.bf16_weight_image(
                *(weights[k] for k in ("wg1", "wg2", "w1s", "w2s", "w1x", "w2x")))
        self._kernel_weights = weights

    def unfold(self) -> None:
        for fc in (self.fc_global1, self.fc_global2, self.fc_local1, self.fc_local2):
            fc.unfold()
        self._kernel_weights = None

    def forward(
        self,
        t_set: torch.Tensor | None,
        x_global: torch.Tensor,
        x_local: torch.Tensor,
        cond: torch.Tensor | None = None,
        mask: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        t_g = t_set if self.tg else None
        t_l = t_set if self.tl else None
        g_cond = cond if self.gc else None
        l_cond = cond if self.lc else None

        if self._kernel_weights is not None:
            b, n, _ = x_local.shape
            set_feat = cat(t_set if (self.tg or self.tl) else None,
                           cond if (self.gc or self.lc) else None)
            if set_feat is None:
                set_feat = x_local.new_zeros(b, 0)
            elif self.dtype is not None:
                set_feat = set_feat.to(self.dtype)
            m = x_local.new_ones(b, n, dtype=torch.float32) if mask is None else mask[..., 0]
            w = self._kernel_weights
            x_local, x_global = epic_layer_ops.epic_layer(
                x_local.contiguous(), x_global.contiguous(), m.contiguous(),
                set_feat.contiguous(),
                w["wg1"], w["bg1"], w["wg2"], w["bg2"],
                w["w1x"], w["w1s"], w["b1"], w["w2x"], w["w2s"], w["b2"],
                sum_scale=self.sum_scale, tg_dim=self.tg, tl_dim=self.tl, cg_dim=self.gc,
                cl_dim=self.lc, weight_image=w.get("weight_image"),
            )
            return x_global, x_local

        act = get_act(self.activation)
        pooled_mean, pooled_sum = meansum_pool(x_local, mask, self.sum_scale)
        g_in = cat(t_g, pooled_mean, pooled_sum, x_global, g_cond)
        x_global1 = act(self.fc_global1(g_in))
        x_global = act(self.fc_global2(cat(t_g, x_global1, g_cond)) + x_global)
        x_local1 = act(
            self.fc_local1(
                [(t_l, "set"), (x_local, "particle"), (x_global, "set"), (l_cond, "set")]
            )
        )
        x_local = act(
            self.fc_local2([(t_l, "set"), (x_local1, "particle"), (l_cond, "set")]) + x_local
        )
        return x_global, x_local


class EPiCEncoder(nn.Module):
    """EPiC generator: local embed -> pooled global init -> `equiv_layers`
    EPiC layers -> local output head, multiplied by the mask.

    Call: (t_set (B, T) | None, x (B, N, in_feats), cond (B, C) | None,
    mask (B, N, 1) | None) -> (B, N, feats)
    """

    def __init__(
        self,
        in_feats: int,
        feats: int = 3,
        hid_dim: int = 256,
        latent_dim: int = 16,
        equiv_layers: int = 8,
        t_dim: int = 0,
        cond_dim: int = 0,
        global_cond_dim: int = 0,
        local_cond_dim: int = 0,
        t_local_cat: bool = False,
        t_global_cat: bool = False,
        activation: str = "leaky_relu",
        use_weight_norm: bool = True,
        sum_scale: float = 1e-2,
        generator: torch.Generator | None = None,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.activation = activation
        self.sum_scale = sum_scale
        self.equiv_layers = equiv_layers
        self.tg = t_dim if t_global_cat else 0
        self.tl = t_dim if t_local_cat else 0
        self.gc = cond_dim if global_cond_dim > 0 else 0
        self.lc = cond_dim if local_cond_dim > 0 else 0
        h = hid_dim
        wn = dict(use_weight_norm=use_weight_norm, generator=generator, dtype=dtype)
        self.fc_l1 = WNDenseSplit(
            [(self.tl, "set"), (in_feats, "particle"), (self.lc, "set")], h, **wn
        )
        self.fc_l2 = WNDenseSplit([(self.tl, "set"), (h, "particle"), (self.lc, "set")], h, **wn)
        self.fc_g1 = WNDense(self.tg + 2 * h + self.gc, h, **wn)
        self.fc_g2 = WNDense(self.tg + h + self.gc, latent_dim, **wn)
        for i in range(equiv_layers):
            self.add_module(
                f"epic_layer_{i}",
                EPiCLayer(
                    hid_dim=h, latent_dim=latent_dim, t_dim=t_dim, cond_dim=cond_dim,
                    global_cond_dim=global_cond_dim, local_cond_dim=local_cond_dim,
                    t_local_cat=t_local_cat, t_global_cat=t_global_cat,
                    activation=activation, sum_scale=sum_scale, **wn,
                ),
            )
        self.fc_l3 = WNDenseSplit(
            [(self.tl, "set"), (h, "particle"), (self.lc, "set")], feats, **wn
        )

    def layers(self) -> list[EPiCLayer]:
        return [getattr(self, f"epic_layer_{i}") for i in range(self.equiv_layers)]

    def forward(
        self,
        t_set: torch.Tensor | None,
        x: torch.Tensor,
        cond: torch.Tensor | None = None,
        mask: torch.Tensor | None = None,
    ) -> torch.Tensor:
        act = get_act(self.activation)
        t_g = t_set if self.tg else None
        t_l = t_set if self.tl else None
        g_cond = cond if self.gc else None
        l_cond = cond if self.lc else None

        h = act(self.fc_l1([(t_l, "set"), (x, "particle"), (l_cond, "set")]))
        h = act(self.fc_l2([(t_l, "set"), (h, "particle"), (l_cond, "set")]) + h)

        z_mean, z_sum = meansum_pool(h, mask, self.sum_scale)
        g = cat(z_sum, z_mean)
        g = act(self.fc_g1(cat(t_g, g, g_cond)))
        g = act(self.fc_g2(cat(t_g, g, g_cond)))

        for layer in self.layers():
            g, h = layer(t_set, g, h, cond=cond, mask=mask)

        out = act(self.fc_l3([(t_l, "set"), (h, "particle"), (l_cond, "set")]))
        if mask is not None:
            out = out * mask
        return out
