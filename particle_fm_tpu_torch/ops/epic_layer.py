"""Fused EPiC layer: the CUDA kernel's wrapper and its plain PyTorch version.

Counterpart of particle_fm_tpu/ops/pallas/epic_layer.py::epic_layer_fused_fwd.
One EPiC layer, forward only, weights already folded:

  1. masked mean and `sum_scale`-scaled sum pooling over the particles;
  2. global MLP1 on cat(t_g, mean, sum, g, cond);
  3. global MLP2 on cat(t_g, g1, cond) plus the residual g;
  4. per-set biases cat(t_l, g_new, cond) @ w1s and cat(t_l, cond) @ w2s;
  5. two H x H local matmuls with leaky_relu(0.01), the second with the
     residual x.

Weight layout ((in, out), as the JAX kernel takes it):
  wg1: (tg + 2H + L + C, H)   bg1: (H,)
  wg2: (tg + H + C, L)        bg2: (L,)
  w1x: (H, H)  w1s: (tl + L + C, H)  b1: (H,)
  w2x: (H, H)  w2s: (tl + C, H)      b2: (H,)
set_feat (B, S) is laid out [t_emb, cond]: t_g = set_feat[:, :tg],
t_l = set_feat[:, :tl], cond = set_feat[:, S-C:].

`epic_layer` runs the plain version for a tensor on the CPU and launches
`csrc/epic_layer.cu` for a CUDA tensor; it never falls back from one to the
other. The CUDA library is built with nvcc at first use (ops/_build.py).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F

from particle_fm_tpu_torch.ops import _build
from particle_fm_tpu_torch.ops._build import check_tensor as _check

SOURCE = _build.CSRC_DIR / "epic_layer.cu"
MAX_WIDTH = 256  # the largest H and L the kernel takes


def _act(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.01)


def epic_layer_reference(
    x_local, x_global, mask, set_feat,
    wg1, bg1, wg2, bg2, w1x, w1s, b1, w2x, w2s, b2,
    sum_scale: float = 1e-2,
    tg_dim: int = 0,
    tl_dim: int = 0,
    c_dim: int = 0,
):
    """Plain PyTorch version of the fused layer. Returns (x_local, x_global)."""
    x, g = x_local, x_global
    m = mask.to(torch.float32)
    pooled_sum = torch.sum(x * m[..., None], dim=1)
    count = torch.sum(m, dim=1, keepdim=True)
    pooled_mean = pooled_sum / count
    pooled_scaled = pooled_sum * sum_scale

    s = set_feat.shape[-1]
    t_g = set_feat[:, :tg_dim]
    t_l = set_feat[:, :tl_dim]
    cond = set_feat[:, s - c_dim :]

    g_in = torch.cat([t_g, pooled_mean, pooled_scaled, g, cond], dim=-1)
    g1 = _act(g_in @ wg1 + bg1)
    g_new = _act(torch.cat([t_g, g1, cond], dim=-1) @ wg2 + bg2 + g)

    bias1 = torch.cat([t_l, g_new, cond], dim=-1) @ w1s + b1
    bias2 = torch.cat([t_l, cond], dim=-1) @ w2s + b2  # zero-width inputs give b2

    x1 = _act(x @ w1x + bias1[:, None, :])
    out = _act(x1 @ w2x + bias2[:, None, :] + x)
    return out, g_new


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.epic_layer_fwd_f32
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int


def build_library(source: Path | None = None) -> Path:
    """Compile `source` (default csrc/epic_layer.cu); see ops/_build.py."""
    return _build.build_library(source or SOURCE)


def load_library(source: Path | None = None) -> ctypes.CDLL:
    """The kernel library built from `source` (default: `SOURCE` as it is
    at the call), loaded once."""
    return _build.load_library(source or SOURCE, _declare)


def epic_layer(
    x_local, x_global, mask, set_feat,
    wg1, bg1, wg2, bg2, w1x, w1s, b1, w2x, w2s, b2,
    sum_scale: float = 1e-2,
    tg_dim: int = 0,
    tl_dim: int = 0,
    c_dim: int = 0,
):
    """One EPiC layer: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. Arguments as in `epic_layer_reference`."""
    args = (x_local, x_global, mask, set_feat, wg1, bg1, wg2, bg2, w1x, w1s, b1, w2x, w2s, b2)
    dims = dict(sum_scale=sum_scale, tg_dim=tg_dim, tl_dim=tl_dim, c_dim=c_dim)
    if x_local.device.type == "cpu":
        return epic_layer_reference(*args, **dims)
    if x_local.device.type != "cuda":
        raise ValueError(f"epic_layer runs on cuda or cpu, got {x_local.device}")

    dev = x_local.device
    if x_local.ndim != 3:
        raise ValueError(f"x_local must be (B, N, H), got {tuple(x_local.shape)}")
    b, n, h = x_local.shape
    l = x_global.shape[-1]
    s = set_feat.shape[-1] if set_feat.ndim == 2 else -1
    if not (0 < h <= MAX_WIDTH and 0 < l <= MAX_WIDTH):
        raise ValueError(f"hidden width {h} or latent width {l} outside the kernel's 1..{MAX_WIDTH}")
    if min(tg_dim, tl_dim, c_dim) < 0 or max(tg_dim, tl_dim) + c_dim > s:
        raise ValueError(f"set_feat width {s} cannot hold t ({tg_dim}, {tl_dim}) and cond {c_dim}")
    for name, t, shape in (
        ("x_local", x_local, (b, n, h)),
        ("x_global", x_global, (b, l)),
        ("mask", mask, (b, n)),
        ("set_feat", set_feat, (b, s)),
        ("wg1", wg1, (tg_dim + 2 * h + l + c_dim, h)),
        ("bg1", bg1, (h,)),
        ("wg2", wg2, (tg_dim + h + c_dim, l)),
        ("bg2", bg2, (l,)),
        ("w1x", w1x, (h, h)),
        ("w1s", w1s, (tl_dim + l + c_dim, h)),
        ("b1", b1, (h,)),
        ("w2x", w2x, (h, h)),
        ("w2s", w2s, (tl_dim + c_dim, h)),
        ("b2", b2, (h,)),
    ):
        _check(name, t, shape, dev)

    if x_local.data_ptr() % 16:
        raise ValueError("x_local must start on 16 bytes (the kernel reads it as float4)")

    xo = torch.empty_like(x_local)
    go = torch.empty_like(x_global)
    if b == 0:
        return xo, go
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.epic_layer_fwd_f32(
            *(t.data_ptr() for t in args), xo.data_ptr(), go.data_ptr(),
            b, n, h, l, s, tg_dim, tl_dim, c_dim, float(sum_scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"epic_layer kernel launch failed: cudaError {err}")
    epic_layer.launches += 1
    return xo, go


epic_layer.launches = 0
