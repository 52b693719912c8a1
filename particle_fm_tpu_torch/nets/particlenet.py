"""ParticleNet: dynamic-kNN EdgeConv point-cloud classifier; counterpart of
particle_fm_tpu/nets/particlenet.py.

Block 0 builds the kNN graph in coordinate space (the `point_indices`
columns), later blocks in the learned feature space; the per-edge MLP runs
on cat(x_i, x_j - x_i) as (B, N, k, C) Dense ops, then the mean over
neighbours plus a shortcut projection. LayerNorm (epsilon 1e-6, flax's
default) in place of weaver's BatchNorm, as in the JAX package.

Module names are flax's automatic ones (`EdgeConvBlock_0/Dense_0`,
`LayerNorm_0`, ..., the fusion's `Dense_0`/`LayerNorm_0`, the head's
`Dense_{i}`, and the named `fts_norm`, `head`, `particle_net`), so that
utils/from_jax.py carries a flax tree across and `reinit_head` finds the
head. Dense layers are drawn as flax's `nn.Dense`: lecun-normal kernels,
zero biases.

`knn_indices` orders the neighbours as `lax.top_k` does: by distance, ties
to the lower index. The diagonal and the padded columns are pushed to 1e9,
where a query's own distance ties with every padded column: the query comes
first, as in JAX. It is looked up at the call, so a test can hand the
network another package's indices.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Sequence

import torch
from torch import nn

from particle_fm_tpu_torch.nets.common import Dropout, LayerNorm, WNDense
from particle_fm_tpu_torch.nets.part import truncated_normal
from particle_fm_tpu_torch.ops.masked import masked_mean

PARTICLENET_CONV_PARAMS = ((16, (64, 64, 64)), (16, (128, 128, 128)), (16, (256, 256, 256)))
PARTICLENET_FC_PARAMS = ((256, 0.1),)
_LN_EPS = 1e-6  # flax.linen.LayerNorm's default


def knn_indices(points: torch.Tensor, mask: torch.Tensor | None, k: int) -> torch.Tensor:
    """Indices (B, N, k) of the k nearest neighbours (self excluded) in
    `points` (B, N, D), by |a|^2 + |b|^2 - 2 a.b; padded points (mask
    (B, N, 1)) are never picked before real ones. Ties go to the lower index
    (a stable sort), as in `lax.top_k`."""
    n = points.shape[1]
    sq = torch.sum(points * points, dim=-1)
    d = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.einsum("bnd,bmd->bnm", points, points)
    big = torch.full((), 1e9, dtype=d.dtype, device=d.device)
    if mask is not None:
        d = torch.where((mask[..., 0] > 0)[:, None, :], d, big)
    d = d + torch.eye(n, dtype=d.dtype, device=d.device) * big
    k = min(k, n - 1)
    return torch.sort(d, dim=-1, stable=True).indices[..., :k]


def gather_neighbors(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats (B, N, C), idx (B, N, k) -> neighbour features (B, N, k, C)."""
    b = torch.arange(feats.shape[0], device=feats.device)[:, None, None]
    return feats[b, idx]


def _dense(fan_in: int, features: int, use_bias: bool, generator, dtype) -> WNDense:
    """flax nn.Dense: lecun-normal kernel, zero bias."""
    lin = WNDense(fan_in, features, use_weight_norm=False, use_bias=use_bias,
                  generator=generator, dtype=dtype)
    with torch.no_grad():
        lin.weight.copy_(truncated_normal((features, fan_in), 1.0 / math.sqrt(fan_in), generator))
        if use_bias:
            lin.bias.zero_()
    return lin


class EdgeConvBlock(nn.Module):
    """EdgeConv with shortcut: per-edge MLP on [x_i, x_j - x_i], mean over
    neighbours, plus a 1x1 shortcut projection, relu, masked."""

    def __init__(self, in_channels: int, k: int, channels: Sequence[int],
                 generator: torch.Generator | None = None, dtype: torch.dtype | None = None):
        super().__init__()
        self.k, self.depth = k, len(channels)
        widths = [2 * in_channels] + list(channels)
        for i in range(self.depth):
            self.add_module(f"Dense_{i}", _dense(widths[i], widths[i + 1], False, generator, dtype))
            self.add_module(f"LayerNorm_{i}", LayerNorm(widths[i + 1], eps=_LN_EPS, dtype=dtype))
        self.add_module(f"Dense_{self.depth}",
                        _dense(in_channels, channels[-1], False, generator, dtype))
        self.add_module(f"LayerNorm_{self.depth}",
                        LayerNorm(channels[-1], eps=_LN_EPS, dtype=dtype))

    def forward(self, points, feats, mask=None) -> torch.Tensor:
        idx = knn_indices(points, mask, self.k)
        nbr = gather_neighbors(feats, idx)
        center = feats[:, :, None, :].expand_as(nbr)
        h = torch.cat([center, nbr - center], dim=-1)
        for i in range(self.depth):
            h = torch.relu(getattr(self, f"LayerNorm_{i}")(getattr(self, f"Dense_{i}")(h)))
        h = h.mean(dim=2)
        sc = getattr(self, f"LayerNorm_{self.depth}")(getattr(self, f"Dense_{self.depth}")(feats))
        out = torch.relu(h + sc)
        return out if mask is None else out * mask


class ParticleNet(nn.Module):
    """Stacked dynamic-graph EdgeConv blocks, optional fusion of their
    outputs, masked mean pooling (`use_counts`) and the FC head with
    dropout."""

    def __init__(
        self,
        in_feats: int,
        num_classes: int = 10,
        conv_params: Sequence = PARTICLENET_CONV_PARAMS,
        fc_params: Sequence = PARTICLENET_FC_PARAMS,
        use_fusion: bool = False,
        use_fts_bn: bool = True,
        use_counts: bool = True,
        generator: torch.Generator | None = None,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.use_fusion, self.use_fts_bn, self.use_counts = use_fusion, use_fts_bn, use_counts
        if use_fts_bn:
            self.fts_norm = LayerNorm(in_feats, eps=_LN_EPS, dtype=dtype)
        self.num_blocks = len(conv_params)
        width = in_feats
        for i, (k, channels) in enumerate(conv_params):
            self.add_module(f"EdgeConvBlock_{i}", EdgeConvBlock(
                width, int(k), tuple(int(c) for c in channels), generator, dtype))
            width = int(channels[-1])
        dense = 0
        if use_fusion:
            fused = sum(int(c[-1][-1]) for c in conv_params)
            out_ch = max(128, min(1024, (fused // 128) * 128))
            self.Dense_0 = _dense(fused, out_ch, False, generator, dtype)
            self.LayerNorm_0 = LayerNorm(out_ch, eps=_LN_EPS, dtype=dtype)
            width, dense = out_ch, 1
        self.fc_ids = []
        for out_dim, drop_rate in fc_params:
            name = f"Dense_{dense}"
            self.add_module(name, _dense(width, int(out_dim), True, generator, dtype))
            self.add_module(f"Dropout_{dense}", Dropout(float(drop_rate)))
            self.fc_ids.append(dense)
            width, dense = int(out_dim), dense + 1
        self.head = _dense(width, num_classes, True, generator, dtype)

    def forward(self, points, feats, mask=None) -> torch.Tensor:
        fts = feats
        if self.use_fts_bn:
            fts = self.fts_norm(fts)
            if mask is not None:
                fts = fts * mask
        outputs = []
        for i in range(self.num_blocks):
            fts = getattr(self, f"EdgeConvBlock_{i}")(points if i == 0 else fts, fts, mask=mask)
            outputs.append(fts)
        if self.use_fusion:
            fts = torch.relu(self.LayerNorm_0(self.Dense_0(torch.cat(outputs, dim=-1))))
            if mask is not None:
                fts = fts * mask
        h = masked_mean(fts, mask) if self.use_counts else fts.mean(dim=1)
        for j in self.fc_ids:
            h = getattr(self, f"Dropout_{j}")(torch.relu(getattr(self, f"Dense_{j}")(h)))
        return self.head(h)


class ParticleNetClassifierNet(nn.Module):
    """(x, mask) -> logits: the `point_indices` columns of x are the
    coordinates of the first graph; the network is `particle_net`.

    Call: (x (B, N, F), mask (B, N, 1) | None, cond ignored) -> (B, n_classes)
    """

    def __init__(self, in_feats: int, n_classes: int = 10, point_indices: Sequence[int] = (0, 1),
                 net_config: Mapping[str, Any] | None = None,
                 generator: torch.Generator | None = None, dtype: torch.dtype | None = None):
        super().__init__()
        self.point_indices = list(point_indices)
        self.particle_net = ParticleNet(in_feats, num_classes=n_classes,
                                        generator=generator, dtype=dtype, **dict(net_config or {}))

    def forward(self, x, mask=None, cond=None) -> torch.Tensor:
        # columns by slicing: indexing with a list copies an index from the host,
        # which a captured CUDA graph cannot
        points = torch.stack([x[..., i] for i in self.point_indices], dim=-1)
        return self.particle_net(points, x, mask=mask)
