"""Shared network building blocks: activations, weight-normalized Dense.

Counterpart of particle_fm_tpu/nets/common.py. Parameters are stored the
torch way, `weight_v (out, in)`, `g (out,)`, `bias (out,)` (the flax tree
holds `kernel (in, out)`; utils/from_jax.py carries one into the other).

Weight norm is written out as `g * v / max(||v||, 1e-12)` per output feature
(the norm runs over the input axis). `torch.nn.utils.weight_norm` has no
clamp, so it is not used.

For sampling, `fold()` computes the normalized weight once and keeps it;
every later forward uses it until `unfold()`.

`dtype` is the compute type, as the flax modules' `dtype`: None computes in
the parameters' float32; bfloat16 keeps the parameters float32 and casts the
input, the weight and the bias to bfloat16 before the product and the bias
add, which then run in bfloat16 (the product accumulated in float32 and
rounded once). With a `dtype`, `fold()` keeps the weight and the bias cast.
Unfolded, as training runs it, the weight norm is computed in float32 and
cast once, as in the JAX module; the casts' backward hands `v`, `g` and the
bias float32 gradients.
`LayerNorm` is `flax.linen.LayerNorm(epsilon=1e-5, dtype=...)` on float32
parameters.

Dropout is flax's `nn.Dropout`: a `Dropout` module is the identity unless a
generator is set on it, which `dropout_generator(net, generator)` does for
every `Dropout` of a network for the length of a `with` block (a classifier's
training loss); outside such a block, as in every evaluation, the network is
deterministic. The keep mask is drawn by `dropout_keep`, the one draw a test
replaces to hand both packages the same masks.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from particle_fm_tpu_torch.parallel.mesh import copy_to, gather_from, reduce_from


def _to_bf16(v: float) -> float:
    """v rounded to bfloat16, as a Python float."""
    return float(torch.tensor(v, dtype=torch.bfloat16))


# the slopes of the shipped activations, rounded once: a traced program
# (serving.py) holds them as numbers, not as tensors made at each call
_BF16_SLOPES = {v: _to_bf16(v) for v in (0.01, 0.1)}


def leaky_relu(x: torch.Tensor, negative_slope: float) -> torch.Tensor:
    """jax.nn.leaky_relu: where(x >= 0, x, slope * x). In bfloat16 the slope
    is a weakly typed constant that JAX rounds to bfloat16 before the
    product (0.01 becomes 0.010009765625); torch's leaky_relu multiplies by
    the slope as given, so it is handed the rounded one (the product of two
    bfloat16 values is exact in float32, rounded once, as in JAX). Under
    autograd it is written as JAX writes it, whose derivative at x = 0 is 1
    (torch's leaky_relu takes the slope there); in bfloat16 a sum cancels to
    exactly 0 often enough for that to show in the gradients."""
    if x.dtype == torch.bfloat16:
        negative_slope = _BF16_SLOPES.get(negative_slope) or _to_bf16(negative_slope)
    if torch.is_grad_enabled() and x.requires_grad:
        return torch.where(x >= 0, x, negative_slope * x)
    return F.leaky_relu(x, negative_slope=negative_slope)


_ACTS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "leaky_relu": lambda x: leaky_relu(x, 0.01),
    "lrlu": lambda x: leaky_relu(x, 0.1),
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "elu": F.elu,
    "selu": F.selu,
    "silu": F.silu,
    "swish": F.silu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "identity": lambda x: x,
    "none": lambda x: x,
}


def check_compute_dtype(dtype: torch.dtype | None) -> None:
    """Raise unless `dtype` is a compute type the port has: None (float32) or
    bfloat16."""
    if dtype is not None and dtype != torch.bfloat16:
        raise NotImplementedError(
            f"dtype={dtype} is not ported: the port computes in float32 (None) or bfloat16")


def get_act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation registry; unknown names fall back to identity, as in the
    JAX package. `gelu` is the tanh approximation, jax.nn.gelu's default."""
    return _ACTS.get(name, lambda x: x)


def _uniform_(t: torch.Tensor, fan_in: int, generator: torch.Generator | None) -> None:
    """torch.nn.Linear's default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def fold_weight(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """w = v * (g / max(||v||, 1e-12)), the norm per output row of v (out, in)."""
    norm = torch.linalg.vector_norm(v, dim=1, keepdim=True)
    return v * (g[:, None] / torch.clamp(norm, min=1e-12))


class WNDense(nn.Module):
    """Dense layer with weight normalization, y = x @ w.T + b."""

    def __init__(
        self,
        in_features: int,
        features: int,
        use_weight_norm: bool = True,
        use_bias: bool = True,
        init_zeros: bool = False,
        generator: torch.Generator | None = None,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        check_compute_dtype(dtype)
        self.in_features = in_features
        self.features = features
        self.use_weight_norm = use_weight_norm
        self.dtype = dtype
        v = torch.empty(features, in_features)
        if init_zeros:
            v.zero_()
        else:
            _uniform_(v, in_features, generator)
        if use_weight_norm:
            self.weight_v = nn.Parameter(v)
            self.g = nn.Parameter(torch.linalg.vector_norm(v, dim=1))
        else:
            self.weight = nn.Parameter(v)
        if use_bias:
            b = torch.zeros(features)
            if not init_zeros:
                _uniform_(b, in_features, generator)
            self.bias = nn.Parameter(b)
        else:
            self.bias = None
        # the folded weight and bias while folded: buffers (not saved), so that
        # torch.export takes them as the program's inputs (serving.py)
        self.register_buffer("_folded", None, persistent=False)
        self.register_buffer("_folded_bias", None, persistent=False)
        self.tp = None  # (kind, ModelAxis) of the sharded form (parallel/tp.py)

    def shard(self, kind: str, axis) -> None:
        """Take the sharded form `kind` ("column" or "row") over the model
        axis `axis`; the parameters already hold this rank's entries."""
        if kind != "column":
            raise NotImplementedError(f"a {type(self).__name__} has no {kind}-parallel form")
        self.features //= axis.size
        self.tp = (kind, axis)

    def whole(self, y: torch.Tensor) -> torch.Tensor:
        """This layer's output `y` whole (a column-parallel one gathered)."""
        if self.tp is None or self.tp[0] != "column":
            return y
        return gather_from(y, self.tp[1], -1)

    def effective_weight(self) -> torch.Tensor:
        """The (out, in) weight the layer applies."""
        if self._folded is not None:
            return self._folded
        if self.use_weight_norm:
            return fold_weight(self.weight_v, self.g)
        return self.weight

    @torch.no_grad()
    def fold(self) -> None:
        """Keep the normalised weight (computed in float32), cast to `dtype`
        with the bias when there is one; nothing to do for a plain float32
        Dense."""
        if self.tp is not None:
            raise RuntimeError("a sharded Dense serves training only: fold a whole copy "
                               "(TrainState.network_copy)")
        if self.dtype is not None:
            self._folded = self.effective_weight().detach().to(self.dtype)
            if self.bias is not None:
                self._folded_bias = self.bias.detach().to(self.dtype)
        elif self.use_weight_norm:
            self._folded = self.effective_weight().detach().clone()

    def unfold(self) -> None:
        self._folded = None
        self._folded_bias = None

    def compute_weight(self) -> torch.Tensor:
        """The (out, in) weight in the compute type."""
        w = self.effective_weight()
        return w if self.dtype is None else w.to(self.dtype)

    def compute_bias(self) -> torch.Tensor | None:
        """The bias in the compute type."""
        if self._folded_bias is not None:
            return self._folded_bias
        if self.bias is None or self.dtype is None:
            return self.bias
        return self.bias.to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x = copy_to(x, self.tp[1])
        if self.dtype is not None:
            x = x.to(self.dtype)
        y = x @ self.compute_weight().t()
        if self.bias is not None:
            y = y + self.compute_bias()
        return y


class WNDenseSplit(WNDense):
    """Weight-norm Dense over a concat of per-particle and per-set segments,
    without materializing the concat.

    `segments` at construction is the concat layout, a list of
    (width, kind) with kind in {"set", "particle"}; zero-width segments are
    dropped, as the JAX module drops None/zero-width inputs. The forward
    takes the matching list of (tensor or None, kind): "set" tensors are
    (B, k), "particle" tensors (B, N, k). It computes
    x @ W_x + broadcast(cat(set segments) @ W_set) + b: one per-particle
    matmul and one tiny per-set matmul.
    """

    def __init__(
        self,
        segments: Sequence[tuple[int, str]],
        features: int,
        use_weight_norm: bool = True,
        use_bias: bool = True,
        generator: torch.Generator | None = None,
        dtype: torch.dtype | None = None,
    ):
        self.segments = [(k, kind) for k, kind in segments if k > 0]
        super().__init__(
            sum(k for k, _ in self.segments),
            features,
            use_weight_norm=use_weight_norm,
            use_bias=use_bias,
            generator=generator,
            dtype=dtype,
        )

    def shard(self, kind: str, axis) -> None:
        if kind == "column":
            return super().shard(kind, axis)
        k = next(k for k, seg in self.segments if seg == "particle")
        self.segments = [(k // axis.size if seg == "particle" else w, seg)
                         for w, seg in self.segments]
        self.in_features -= k - k // axis.size
        self.tp = (kind, axis)

    def forward(self, segments) -> torch.Tensor:
        segments = [(a, kind) for a, kind in segments if a is not None and a.shape[-1] > 0]
        layout = [(a.shape[-1], kind) for a, kind in segments]
        if layout != self.segments:
            raise ValueError(f"segment layout {layout} != constructed {self.segments}")
        if self.tp is not None and self.tp[0] == "row":
            return self._row_parallel(segments)
        if self.tp is not None:
            segments = [(copy_to(a, self.tp[1]), kind) for a, kind in segments]
        w = self.compute_weight()
        out = None
        set_parts, set_ws = [], []
        col = 0
        for a, kind in segments:
            if self.dtype is not None:
                a = a.to(self.dtype)
            k = a.shape[-1]
            w_seg = w[:, col : col + k]
            col += k
            if kind == "particle":
                part = a @ w_seg.t()
                out = part if out is None else out + part
            else:
                set_parts.append(a)
                set_ws.append(w_seg)
        if set_parts:
            set_in = torch.cat(set_parts, dim=-1) if len(set_parts) > 1 else set_parts[0]
            set_w = torch.cat(set_ws, dim=1) if len(set_ws) > 1 else set_ws[0]
            set_out = (set_in @ set_w.t())[..., None, :]
            out = set_out if out is None else out + set_out
        if self.bias is not None:
            out = out + self.compute_bias()
        return out

    def _row_parallel(self, segments) -> torch.Tensor:
        """The row-parallel form (module docstring): products in the compute
        type, the sum, the scale and the bias in float32, one cast last."""
        axis = self.tp[1]
        v = self.weight_v if self.use_weight_norm else self.weight
        dt = self.dtype

        def mm(a, w):
            if dt is not None:
                return (a.to(dt) @ w.to(dt).t()).float()
            return a @ w.t()

        col, set_parts, set_cols = 0, [], []
        for a, kind in segments:
            k = a.shape[-1]
            if kind == "particle":
                x_p, v_p = a, v[:, col:col + k]
            else:
                set_parts.append(a)
                set_cols.append(v[:, col:col + k])
            col += k
        partial = mm(x_p, v_p)
        flat = [partial.reshape(-1)]
        if self.use_weight_norm:
            flat.append(torch.sum(v_p * v_p, dim=1))
        summed = reduce_from(torch.cat(flat), axis)
        out = summed[:partial.numel()].view_as(partial)
        v_s = torch.cat(set_cols, dim=1) if set_cols else None
        if set_parts:
            out = out + mm(torch.cat(set_parts, dim=-1), v_s)[..., None, :]
        if self.use_weight_norm:
            sq = summed[partial.numel():]
            if v_s is not None:
                sq = sq + torch.sum(v_s * v_s, dim=1)
            out = out * (self.g / torch.clamp(torch.sqrt(sq), min=1e-12))
        if self.bias is not None:
            out = out + self.bias
        return out if dt is None else out.to(dt)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis with float32 parameters `weight` (flax's
    `scale`) and `bias`. Without `dtype`, torch's LayerNorm. With one,
    flax's `LayerNorm(dtype=...)`: the input upcast to float32, statistics,
    scale and bias in float32, then one cast to `dtype` (torch's LayerNorm
    on a bfloat16 tensor returns its own rounding of the same). flax takes
    the variance as E[x^2] - E[x]^2 and torch in two passes: the two differ
    in float32's last bits, below one bfloat16 rounding. Under autograd
    torch rounds a bfloat16 x's gradient once. JAX's autodiff of flax's
    LayerNorm rounds two parts of it to bfloat16 before adding them (the
    part through the centring x - mean and the part through the
    statistics: flax casts x to float32 for each), and these nearly cancel,
    so its bfloat16 gradient is further from float32 than the port's."""

    def __init__(self, normalized_shape: int, eps: float = 1e-5,
                 dtype: torch.dtype | None = None):
        super().__init__(normalized_shape, eps=eps)
        check_compute_dtype(dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x)
        return super().forward(x.to(torch.float32)).to(self.compute_dtype)


def dropout_keep(generator: torch.Generator, keep: float, shape: tuple[int, ...],
                 device: torch.device) -> torch.Tensor:
    """Bernoulli(keep) draw of a dropout keep mask."""
    return torch.rand(shape, generator=generator, device=device) < keep


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """flax's nn.Dropout: x unchanged without a generator or at rate 0, zeros
    at rate 1, else where(keep mask, x / keep, 0) with inverted scaling. In
    bfloat16 x is divided by keep rounded to bfloat16, as JAX rounds the
    weakly typed constant."""
    if generator is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = dropout_keep(generator, keep, tuple(x.shape), x.device)
    scale = float(torch.tensor(keep, dtype=x.dtype)) if x.dtype == torch.bfloat16 else keep
    return torch.where(mask, x / scale, torch.zeros_like(x))


class Dropout(nn.Module):
    """Dropout at `rate`, drawn from `generator` while one is set
    (`dropout_generator`), else the identity."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator: torch.Generator | None = None

    @property
    def active(self) -> bool:
        return self.generator is not None and self.rate > 0.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.rate, self.generator)


@contextlib.contextmanager
def dropout_generator(net: nn.Module, generator: torch.Generator | None):
    """Inside the block every `Dropout` of `net` draws from `generator`, in
    the order the forward reaches them (None: the network stays
    deterministic); after it, none draws."""
    drops = [m for m in net.modules() if isinstance(m, Dropout)]
    for m in drops:
        m.generator = generator
    try:
        yield
    finally:
        for m in drops:
            m.generator = None


def cat(*parts: torch.Tensor | None) -> torch.Tensor | None:
    """Concatenate along the last axis, skipping None and zero-width parts;
    None when no part is left."""
    kept = [p for p in parts if p is not None and p.shape[-1] > 0]
    if not kept:
        return None
    if len(kept) == 1:
        return kept[0]
    return torch.cat(kept, dim=-1)
