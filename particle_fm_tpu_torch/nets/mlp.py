"""Plain MLP / ResNet networks for flat (non-set) data and the cathode
classifier; counterpart of particle_fm_tpu/nets/mlp.py.

Module and parameter names follow the flax modules (`lin_0`, `mlp1`,
`linear`, `linear2`, `lin_out`, ...), so utils/from_jax.py carries one tree
into the other. As everywhere in the port, a module is given its input
widths at construction (flax infers them at the first call): `in_features`
for the plain stacks, and the widths of t, x and cond for the conditioned
ones, whose every stage reads cat(t, previous output, cond).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from particle_fm_tpu_torch.nets.common import WNDense, cat, get_act


def _dense(fan_in: int, features: int, generator, dtype) -> WNDense:
    return WNDense(fan_in, features, use_weight_norm=False, generator=generator, dtype=dtype)


class MLP(nn.Module):
    """Dense stack: Linear -> act between all layers, no act after the last."""

    def __init__(self, in_features: int, out_features: int,
                 hidden_features: Sequence[int] = (64, 64), activation: str = "elu",
                 generator: torch.Generator | None = None, dtype: torch.dtype | None = None):
        super().__init__()
        self.activation = activation
        dims = [in_features] + list(hidden_features) + [out_features]
        self.depth = len(dims) - 1
        for i in range(self.depth):
            self.add_module(f"lin_{i}", _dense(dims[i], dims[i + 1], generator, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = get_act(self.activation)
        for i in range(self.depth):
            x = getattr(self, f"lin_{i}")(x)
            if i < self.depth - 1:
                x = act(x)
        return x


class _CondStages(nn.Module):
    """Stages each reading cat(t, previous output, cond)."""

    def __init__(self, in_features: int, t_dim: int, cond_dim: int, stages, make):
        super().__init__()
        self.names = []
        width = in_features
        for name, out, arg in stages:
            self.add_module(name, make(t_dim + width + cond_dim, out, arg))
            self.names.append(name)
            width = out

    def forward(self, t, x, cond=None) -> torch.Tensor:
        for name in self.names:
            x = getattr(self, name)(cat(t, x, cond))
        return x


class SmallCondMLP(_CondStages):
    """4 MLP stages, (t, cond) re-concatenated at each stage input."""

    def __init__(self, in_features: int, out_features: int, t_dim: int = 0, cond_dim: int = 0,
                 activation: str = "elu", generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        stages = [("mlp1", 64, (64, 64)), ("mlp2", 256, (256, 256)), ("mlp3", 256, (256, 256)),
                  ("mlp4", out_features, (64, 64))]
        super().__init__(in_features, t_dim, cond_dim, stages,
                         lambda fan_in, out, hidden: MLP(fan_in, out, hidden, activation,
                                                         generator, dtype))


class VerySmallCondMLP(_CondStages):
    def __init__(self, in_features: int, out_features: int, t_dim: int = 0, cond_dim: int = 0,
                 activation: str = "elu", generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__(in_features, t_dim, cond_dim, [("mlp1", out_features, (64, 64))],
                         lambda fan_in, out, hidden: MLP(fan_in, out, hidden, activation,
                                                         generator, dtype))


class ResNetBlock(nn.Module):
    """leaky_relu(linear2(h) + h), h = leaky_relu(linear(x)); the residual
    only where h is as wide as the output."""

    def __init__(self, in_features: int, out_features: int, hidden_features: int = 64,
                 generator: torch.Generator | None = None, dtype: torch.dtype | None = None):
        super().__init__()
        self.linear = _dense(in_features, hidden_features, generator, dtype)
        self.linear2 = _dense(hidden_features, out_features, generator, dtype)
        self.residual = hidden_features == out_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = get_act("leaky_relu")
        h = act(self.linear(x))
        y = self.linear2(h)
        return act(y + h if self.residual else y)


class SmallCondResNet(_CondStages):
    def __init__(self, in_features: int, out_features: int, t_dim: int = 0, cond_dim: int = 0,
                 generator: torch.Generator | None = None, dtype: torch.dtype | None = None):
        stages = [("mlp1", 64, 64), ("mlp2", 256, 256), ("mlp3", 256, 256), ("mlp4", 256, 256),
                  ("mlp5", out_features, 64)]
        super().__init__(in_features, t_dim, cond_dim, stages,
                         lambda fan_in, out, hidden: ResNetBlock(fan_in, out, hidden, generator,
                                                                 dtype))


class CathodeClassifier(nn.Module):
    """ReLU MLP -> 1 logit, for the high-level-feature classifier test."""

    def __init__(self, in_features: int, layers: Sequence[int] = (64, 64, 64),
                 generator: torch.Generator | None = None, dtype: torch.dtype | None = None):
        super().__init__()
        dims = [in_features] + list(layers)
        self.depth = len(layers)
        for i in range(self.depth):
            self.add_module(f"lin_{i}", _dense(dims[i], dims[i + 1], generator, dtype))
        self.lin_out = _dense(dims[-1], 1, generator, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = torch.relu(getattr(self, f"lin_{i}")(x))
        return self.lin_out(x)
