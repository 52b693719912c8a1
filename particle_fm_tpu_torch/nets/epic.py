"""EPiC (Equivariant Point Cloud) generator and discriminators; counterpart of
particle_fm_tpu/nets/epic.py.

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

`dropout` is applied where the JAX modules apply it (nets/common.py::
Dropout: only inside `dropout_generator`, as the classifiers' training loss
runs them). The folded route serves inference, where dropout is the
identity; a folded layer asked to draw raises.

The discriminators (`EPiCDiscriminator`, `EPiCDiscriminator2`,
`EPiCDiscriminator3`) are the gen-vs-real classifiers' set networks. Their
EPiC layers have no time embedding, and no cond where the classifiers call
them, so after `fold()` they run the fused layer with a 0-wide per-set
feature.

Under trainer.strategy=dp_tp (parallel/tp.py) the local MLPs of each
EPiCLayer and of the EPiCEncoder's input block run column-then-row parallel
over the model axis (nets/common.py), one all-reduce a layer; the encoder's
residual after `fc_l2` gathers `fc_l1`'s output. Under sp the pools sum
over the model axis (ops/masked.py).
"""

from __future__ import annotations

import torch
from torch import nn

from particle_fm_tpu_torch.nets.common import Dropout, WNDense, WNDenseSplit, cat, get_act
from particle_fm_tpu_torch.ops import epic_layer as epic_layer_ops
from particle_fm_tpu_torch.ops.masked import meansum_pool


# the fused layer's arguments that `EPiCLayer.fold` lays out (the bfloat16
# image last, in bfloat16 only)
KERNEL_WEIGHTS = ("wg1", "bg1", "wg2", "bg2", "w1x", "w1s", "b1", "w2x", "w2s", "b2",
                  "weight_image")


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
        dropout: float = 0.0,
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
        self.drop_global, self.drop_local = Dropout(dropout), Dropout(dropout)
        # the fused layer's weights while folded: buffers (not saved), so that
        # torch.export takes them as the program's inputs (serving.py)
        for k in KERNEL_WEIGHTS:
            self.register_buffer(f"_kw_{k}", None, persistent=False)

    @property
    def _kernel_weights(self) -> dict[str, torch.Tensor] | None:
        """The fused layer's weights by name while folded, else None."""
        if self._kw_wg1 is None:
            return None
        return {k: getattr(self, f"_kw_{k}") for k in KERNEL_WEIGHTS
                if getattr(self, f"_kw_{k}") is not None}

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
        for k, w in weights.items():
            setattr(self, f"_kw_{k}", w)

    def unfold(self) -> None:
        for fc in (self.fc_global1, self.fc_global2, self.fc_local1, self.fc_local2):
            fc.unfold()
        for k in KERNEL_WEIGHTS:
            setattr(self, f"_kw_{k}", None)

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

        if self._kw_wg1 is not None:
            if self.drop_global.active:
                raise RuntimeError("the folded EPiC layer serves inference: it has no dropout")
            b, n, _ = x_local.shape
            set_feat = cat(t_set if (self.tg or self.tl) else None,
                           cond if (self.gc or self.lc) else None)
            if set_feat is None:
                set_feat = x_local.new_zeros(b, 0)
            elif self.dtype is not None:
                set_feat = set_feat.to(self.dtype)
            m = x_local.new_ones(b, n, dtype=torch.float32) if mask is None else mask[..., 0]
            x_local, x_global = epic_layer_ops.epic_layer(
                x_local.contiguous(), x_global.contiguous(), m.contiguous(),
                set_feat.contiguous(),
                self._kw_wg1, self._kw_bg1, self._kw_wg2, self._kw_bg2, self._kw_w1x,
                self._kw_w1s, self._kw_b1, self._kw_w2x, self._kw_w2s, self._kw_b2,
                sum_scale=self.sum_scale, tg_dim=self.tg, tl_dim=self.tl, cg_dim=self.gc,
                cl_dim=self.lc, weight_image=self._kw_weight_image,
            )
            return x_global, x_local

        act = get_act(self.activation)
        pooled_mean, pooled_sum = meansum_pool(x_local, mask, self.sum_scale)
        g_in = cat(t_g, pooled_mean, pooled_sum, x_global, g_cond)
        x_global1 = act(self.fc_global1(g_in))
        x_global = self.drop_global(
            act(self.fc_global2(cat(t_g, x_global1, g_cond)) + x_global))
        x_local1 = act(
            self.fc_local1(
                [(t_l, "set"), (x_local, "particle"), (x_global, "set"), (l_cond, "set")]
            )
        )
        x_local = act(
            self.fc_local2([(t_l, "set"), (x_local1, "particle"), (l_cond, "set")]) + x_local
        )
        return x_global, self.drop_local(x_local)


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
        dropout: float = 0.0,
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
        self.drop = Dropout(dropout)
        self.fc_g1 = WNDense(self.tg + 2 * h + self.gc, h, **wn)
        self.fc_g2 = WNDense(self.tg + h + self.gc, latent_dim, **wn)
        for i in range(equiv_layers):
            self.add_module(
                f"epic_layer_{i}",
                EPiCLayer(
                    hid_dim=h, latent_dim=latent_dim, t_dim=t_dim, cond_dim=cond_dim,
                    global_cond_dim=global_cond_dim, local_cond_dim=local_cond_dim,
                    t_local_cat=t_local_cat, t_global_cat=t_global_cat,
                    activation=activation, sum_scale=sum_scale, dropout=dropout, **wn,
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
        h = self.drop(act(self.fc_l2([(t_l, "set"), (h, "particle"), (l_cond, "set")])
                          + self.fc_l1.whole(h)))

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


class EPiCDiscriminator2(nn.Module):
    """Headless EPiC trunk: local embed -> EPiC layers -> cat(scaled sum,
    mean, global), 2 * hid_dim + latent_dim per set. `cond_dim` is the
    conditioning width; it enters the global MLPs when `global_cond_dim > 0`
    and the EPiC layers' local MLPs when `local_cond_dim > 0` (the
    discriminator also feeds it, per particle, to the local embed).

    Call: (x (B, N, in_feats), cond (B, C) | None, mask (B, N, 1) | None)
    -> (B, 2 * hid_dim + latent_dim)
    """

    local_cond_in_embed = False

    def __init__(
        self,
        in_feats: int,
        hid_dim: int = 256,
        latent_dim: int = 16,
        equiv_layers: int = 6,
        cond_dim: int = 0,
        global_cond_dim: int = 0,
        local_cond_dim: int = 0,
        activation: str = "leaky_relu",
        use_weight_norm: bool = True,
        sum_scale: float = 1e-2,
        dropout: float = 0.0,
        generator: torch.Generator | None = None,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.activation, self.sum_scale, self.equiv_layers = activation, sum_scale, equiv_layers
        self.gc = cond_dim if global_cond_dim > 0 else 0
        self.lc = cond_dim if (local_cond_dim > 0 and self.local_cond_in_embed) else 0
        h, lat = hid_dim, latent_dim
        wn = dict(use_weight_norm=use_weight_norm, generator=generator, dtype=dtype)
        self.fc_l1 = WNDenseSplit([(in_feats, "particle"), (self.lc, "set")], h, **wn)
        self.fc_l2 = WNDenseSplit([(h, "particle"), (self.lc, "set")], h, **wn)
        self.drop = Dropout(dropout)
        self.fc_g1 = WNDense(2 * h + self.gc, h, **wn)
        self.fc_g2 = WNDense(h + self.gc, lat, **wn)
        for i in range(equiv_layers):
            self.add_module(f"epic_layer_{i}", EPiCLayer(
                hid_dim=h, latent_dim=lat, cond_dim=cond_dim, global_cond_dim=global_cond_dim,
                local_cond_dim=local_cond_dim, activation=activation, sum_scale=sum_scale,
                dropout=dropout, **wn))

    def layers(self) -> list[EPiCLayer]:
        return [getattr(self, f"epic_layer_{i}") for i in range(self.equiv_layers)]

    def forward(self, x, cond=None, mask=None) -> torch.Tensor:
        act = get_act(self.activation)
        g_cond = cond if self.gc else None
        if self.lc and cond is None:
            raise ValueError("local_cond_dim > 0 requires cond")
        l_cond = cond if self.lc else None
        h = act(self.fc_l1([(x, "particle"), (l_cond, "set")]))
        h = self.drop(act(self.fc_l2([(h, "particle"), (l_cond, "set")]) + h))
        z_mean, z_sum = meansum_pool(h, mask, self.sum_scale)
        g = act(self.fc_g1(cat(z_sum, z_mean, g_cond)))
        g = act(self.fc_g2(cat(g, g_cond)))
        for layer in self.layers():
            g, h = layer(None, g, h, cond=cond, mask=mask)
        x_mean, x_sum = meansum_pool(h, mask, self.sum_scale)
        return torch.cat([x_sum, x_mean, g], dim=-1)


class EPiCDiscriminator(EPiCDiscriminator2):
    """EPiC set classifier: the trunk (with cond, per particle, in the local
    embed too) -> the pooled global MLP head (`fc_d1`, `fc_d2`, `fc_out`).
    With `num_sup_sets` S > 1, S adjacent rows of the batch form one event:
    the S per-set features are summed and the head reads cat(sum *
    sum_scale, sum / S), one logit row per event.

    Call: (x (B, N, in_feats), cond (B, C) | None, mask (B, N, 1) | None)
    -> (B / S, out_dim)
    """

    local_cond_in_embed = True

    def __init__(self, in_feats: int, hid_dim: int = 256, latent_dim: int = 16,
                 equiv_layers: int = 8, num_sup_sets: int = 1, out_dim: int = 1, **kw):
        super().__init__(in_feats, hid_dim, latent_dim, equiv_layers, **kw)
        self.num_sup_sets = num_sup_sets
        wn = {k: kw[k] for k in ("use_weight_norm", "generator", "dtype") if k in kw}
        feat = 2 * hid_dim + latent_dim
        # under super-sets the head reads cat(scaled sum, mean) of the S features
        self.fc_d1 = WNDense((2 if num_sup_sets > 1 else 1) * feat, hid_dim, **wn)
        self.fc_d2 = WNDense(hid_dim, hid_dim, **wn)
        self.fc_out = WNDense(hid_dim, out_dim, **wn)

    def forward(self, x, cond=None, mask=None) -> torch.Tensor:
        act = get_act(self.activation)
        g_final = super().forward(x, cond, mask)
        if self.num_sup_sets > 1:
            s2 = g_final.reshape(-1, self.num_sup_sets, g_final.shape[-1]).sum(dim=-2)
            g_final = cat(s2 * self.sum_scale, s2 / self.num_sup_sets)
        out = act(self.fc_d1(g_final))
        out = act(self.fc_d2(out))
        return self.fc_out(out)


class EPiCDiscriminator3(nn.Module):
    """Two-level discriminator for events of `num_sup_sets` jets: a particle
    trunk per jet (`particle_trunk`), a distinct jet trunk over the event's
    jets (`jet_trunk`, on the S jet features, no mask), then the head
    (`fc_g3`, `fc_g4`, `out`) on cat(event feature, the S jet features).

    Call: (x (B * S, N, in_feats), cond ignored, mask (B * S, N, 1) | None),
    adjacent rows forming one event -> (B, 1)
    """

    def __init__(
        self,
        in_feats: int,
        hid_dim: int = 128,
        latent_dim: int = 16,
        equiv_layers: int = 3,
        num_sup_sets: int = 2,
        activation: str = "leaky_relu",
        use_weight_norm: bool = True,
        sum_scale: float = 1e-2,
        dropout: float = 0.0,
        generator: torch.Generator | None = None,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.activation, self.num_sup_sets = activation, num_sup_sets
        self.feat_dim = feat = 2 * hid_dim + latent_dim
        trunk = dict(hid_dim=hid_dim, latent_dim=latent_dim, equiv_layers=equiv_layers,
                     activation=activation, use_weight_norm=use_weight_norm,
                     sum_scale=sum_scale, dropout=dropout, generator=generator, dtype=dtype)
        self.particle_trunk = EPiCDiscriminator2(in_feats, **trunk)
        self.jet_trunk = EPiCDiscriminator2(feat, **trunk)
        wn = dict(use_weight_norm=use_weight_norm, generator=generator, dtype=dtype)
        self.fc_g3 = WNDense(feat * (1 + num_sup_sets), hid_dim, **wn)
        self.fc_g4 = WNDense(hid_dim, hid_dim, **wn)
        self.out = WNDense(hid_dim, 1, **wn)

    def forward(self, x, cond=None, mask=None) -> torch.Tensor:
        act = get_act(self.activation)
        s = self.num_sup_sets
        jet_set = self.particle_trunk(x, mask=mask).reshape(-1, s, self.feat_dim)
        event = self.jet_trunk(jet_set, mask=None)
        head_in = torch.cat([event, jet_set.reshape(jet_set.shape[0], -1)], dim=-1)
        out = act(self.fc_g3(head_in))
        out = act(self.fc_g4(out))
        return self.out(out)
