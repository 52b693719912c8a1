"""Fused EPiC layer: the CUDA kernel's wrapper and its plain PyTorch version.

Counterpart of particle_fm_tpu/ops/pallas/epic_layer.py::epic_layer_fused_fwd.
One EPiC layer, forward only, weights already folded:

  1. masked mean and `sum_scale`-scaled sum pooling over the particles;
  2. global MLP1 on cat(t_g, mean, sum, g, cond_g);
  3. global MLP2 on cat(t_g, g1, cond_g) plus the residual g;
  4. per-set biases cat(t_l, g_new, cond_l) @ w1s and cat(t_l, cond_l) @ w2s;
  5. two H x H local matmuls with leaky_relu(0.01), the second with the
     residual x.

Weight layout ((in, out), as the JAX kernel takes it):
  wg1: (tg + 2H + L + cg, H)   bg1: (H,)
  wg2: (tg + H + cg, L)        bg2: (L,)
  w1x: (H, H)  w1s: (tl + L + cl, H)  b1: (H,)
  w2x: (H, H)  w2s: (tl + cl, H)      b2: (H,)
set_feat (B, S) is laid out [t_emb, cond]: t_g = set_feat[:, :tg],
t_l = set_feat[:, :tl]. The conditioning vector is C wide and feeds the
global MLPs when cg = C, the local biases when cl = C (each of cg and cl is 0
or C, as the JAX layer's global_cond_dim and local_cond_dim choose):
cond_g = set_feat[:, S-cg:], cond_l = set_feat[:, S-cl:]. The JAX kernel
takes one width for both; jetclass_cond feeds cond to the global path only.

`epic_layer` runs the plain version for a tensor on the CPU and launches
`csrc/epic_layer.cu` for a CUDA tensor; it never falls back from one to the
other. The CUDA library is built with nvcc at first use (ops/_build.py). The
kernel runs the two local matmuls on the tensor cores, each float32 product
as three TF32 products (csrc/mma_tf32.cuh); `epic_layer_tf32` models that
arithmetic on any device, and `launch_report` asks the built library what its
launcher gives the kernel at a shape.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F

from particle_fm_tpu_torch.ops import _build
from particle_fm_tpu_torch.ops._build import check_tensor as _check
from particle_fm_tpu_torch.ops.tf32 import product_tf32

SOURCE = _build.CSRC_DIR / "epic_layer.cu"
MAX_WIDTH = 512  # the largest H and L the kernel takes


def _act(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.01)


def epic_layer_reference(
    x_local, x_global, mask, set_feat,
    wg1, bg1, wg2, bg2, w1x, w1s, b1, w2x, w2s, b2,
    sum_scale: float = 1e-2,
    tg_dim: int = 0,
    tl_dim: int = 0,
    cg_dim: int = 0,
    cl_dim: int = 0,
    local_matmul=torch.matmul,
):
    """Plain PyTorch version of the fused layer. Returns (x_local, x_global)
    in x_local's dtype. `local_matmul(x, w)` computes the two H x H local
    products.

    In bfloat16 it keeps the Pallas kernel's arithmetic: every product in
    float32 on the bfloat16 values (a bfloat16 product is exact in float32,
    so a float32 product on the values is the kernel's bfloat16 product with
    float32 accumulation), the mask, the pool, the biases and the residual
    in float32, and four roundings to bfloat16: g1 before the second global
    MLP, g_new (for the per-set bias and the output), x1 before the second
    local product, and the output. In float32 (and float64) every cast is a
    no-op."""
    lowp = x_local.dtype
    work = torch.promote_types(lowp, torch.float32)
    x, g = x_local.to(work), x_global.to(work)
    m = mask.to(work)
    sf = set_feat.to(work)
    wg1, bg1, wg2, bg2, w1x, w1s, b1, w2x, w2s, b2 = (
        w.to(work) for w in (wg1, bg1, wg2, bg2, w1x, w1s, b1, w2x, w2s, b2))
    pooled_sum = torch.sum(x * m[..., None], dim=1)
    count = torch.sum(m, dim=1, keepdim=True)
    pooled_mean = pooled_sum / count
    pooled_scaled = pooled_sum * sum_scale

    s = sf.shape[-1]
    t_g = sf[:, :tg_dim]
    t_l = sf[:, :tl_dim]
    cond_g = sf[:, s - cg_dim :]
    cond_l = sf[:, s - cl_dim :]

    def rounded(v):
        return v.to(lowp).to(work)

    g_in = torch.cat([t_g, pooled_mean, pooled_scaled, g, cond_g], dim=-1)
    g1 = rounded(_act(g_in @ wg1 + bg1))
    g_new = rounded(_act(torch.cat([t_g, g1, cond_g], dim=-1) @ wg2 + bg2 + g))

    bias1 = torch.cat([t_l, g_new, cond_l], dim=-1) @ w1s + b1
    bias2 = torch.cat([t_l, cond_l], dim=-1) @ w2s + b2  # zero-width inputs give b2

    x1 = rounded(_act(local_matmul(x, w1x) + bias1[:, None, :]))
    out = _act(local_matmul(x1, w2x) + bias2[:, None, :] + x)
    return out.to(lowp), g_new.to(lowp)


def epic_layer_tf32(*args, products: int = 3, **dims):
    """The kernel's arithmetic on any device: the plain version with its two
    local matmuls as `products` TF32 products per float32 product
    (ops/tf32.py); the pool, the per-set MLPs and the epilogues stay float32,
    as in the kernel. Not on any serving path."""
    matmul = lambda a, w: product_tf32("bnk,kh->bnh", a, w, products)
    return epic_layer_reference(*args, **dims, local_matmul=matmul)


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.epic_layer_fwd_f32
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    geometry = lib.epic_layer_geometry
    geometry.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_int)]
    geometry.restype = ctypes.c_int
    lib.epic_layer_mma_instruction.argtypes = []
    lib.epic_layer_mma_instruction.restype = ctypes.c_char_p
    if hasattr(lib, "epic_layer_fwd_bf16"):  # an earlier source, timed beside, may lack it
        fn = lib.epic_layer_fwd_bf16
        fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.epic_layer_bf16_mma_instruction.argtypes = []
        lib.epic_layer_bf16_mma_instruction.restype = ctypes.c_char_p


def launch_report(b: int, n: int, h: int, l: int, s: int, tg: int = 0, tl: int = 0,
                  cg: int = 0, cl: int = 0, source: Path | None = None) -> dict:
    """What the built library's launcher gives the kernel at this shape (the
    launcher's own code with a report in place of the launch; needs a CUDA
    device): blocks, warps, rows of a tile, bytes of shared memory, registers
    per thread, TF32 products per float32 product, whether the local weights
    sit in shared memory, and the instruction."""
    lib = load_library(source)
    report = (ctypes.c_int * 7)()
    err = lib.epic_layer_geometry(b, n, h, l, s, tg, tl, cg, cl, report)
    if err != 0:
        raise RuntimeError(f"epic_layer_geometry failed: cudaError {err}")
    names = ("blocks", "warps", "tile_rows", "smem_bytes", "registers_per_thread",
             "tf32_products_per_float32_product", "weights_in_shared_memory")
    return dict(zip(names, report), instruction=lib.epic_layer_mma_instruction().decode())


def build_library(source: Path | None = None) -> Path:
    """Compile `source` (default csrc/epic_layer.cu); see ops/_build.py."""
    return _build.build_library(source or SOURCE)


def load_library(source: Path | None = None) -> ctypes.CDLL:
    """The kernel library built from `source` (default: `SOURCE` as it is
    at the call), loaded once."""
    return _build.load_library(source or SOURCE, _declare)


def bf16_instruction() -> str:
    """The tensor-core instruction of the bfloat16 kernel's local products,
    as the built library names it (needs the library; no device)."""
    return load_library().epic_layer_bf16_mma_instruction().decode()


def _check_shapes(args, dims, dtype: torch.dtype) -> tuple[int, int, int, int, int]:
    """Raise unless the arguments are a shape the kernels take, every tensor
    of `dtype` but the float32 mask; (b, n, h, l, s)."""
    x_local, x_global, mask, set_feat = args[:4]
    tg_dim, tl_dim, cg_dim, cl_dim = (dims[k] for k in ("tg_dim", "tl_dim", "cg_dim", "cl_dim"))
    if x_local.ndim != 3:
        raise ValueError(f"x_local must be (B, N, H), got {tuple(x_local.shape)}")
    b, n, h = x_local.shape
    l = x_global.shape[-1]
    s = set_feat.shape[-1] if set_feat.ndim == 2 else -1
    if not (0 < h <= MAX_WIDTH and 0 < l <= MAX_WIDTH):
        raise ValueError(f"hidden width {h} or latent width {l} outside the kernel's 1..{MAX_WIDTH}")
    c = max(cg_dim, cl_dim)
    if min(tg_dim, tl_dim, cg_dim, cl_dim) < 0 or max(tg_dim, tl_dim) + c > s:
        raise ValueError(f"set_feat width {s} cannot hold t ({tg_dim}, {tl_dim}) and cond {c}")
    if cg_dim not in (0, c) or cl_dim not in (0, c):
        raise ValueError(f"cond widths {cg_dim} (global) and {cl_dim} (local) must each be 0 or C")
    dev = x_local.device
    for name, t, shape in (
        ("x_local", x_local, (b, n, h)),
        ("x_global", x_global, (b, l)),
        ("mask", mask, (b, n)),
        ("set_feat", set_feat, (b, s)),
        ("wg1", args[4], (tg_dim + 2 * h + l + cg_dim, h)),
        ("bg1", args[5], (h,)),
        ("wg2", args[6], (tg_dim + h + cg_dim, l)),
        ("bg2", args[7], (l,)),
        ("w1x", args[8], (h, h)),
        ("w1s", args[9], (tl_dim + l + cl_dim, h)),
        ("b1", args[10], (h,)),
        ("w2x", args[11], (h, h)),
        ("w2s", args[12], (tl_dim + cl_dim, h)),
        ("b2", args[13], (h,)),
    ):
        # the mask stays float32 in both kernels, as in the Pallas kernel
        _check(name, t, shape, dev, dtype=torch.float32 if name == "mask" else dtype)
    if x_local.data_ptr() % 16:
        raise ValueError("x_local must start on 16 bytes (the kernel reads it in 16-byte pieces)")
    return b, n, h, l, s


def epic_layer_bf16(
    x_local, x_global, mask, set_feat,
    wg1, bg1, wg2, bg2, w1x, w1s, b1, w2x, w2s, b2,
    sum_scale: float = 1e-2,
    tg_dim: int = 0,
    tl_dim: int = 0,
    cg_dim: int = 0,
    cl_dim: int = 0,
):
    """The bfloat16 kernel on CUDA tensors (`epic_layer_fwd_bf16`): every
    tensor bfloat16 but the float32 mask; arguments as in
    `epic_layer_reference`, whose bfloat16 arithmetic it computes. Counts
    its launches in `epic_layer_bf16.launches`."""
    args = (x_local, x_global, mask, set_feat, wg1, bg1, wg2, bg2, w1x, w1s, b1, w2x, w2s, b2)
    dims = dict(tg_dim=tg_dim, tl_dim=tl_dim, cg_dim=cg_dim, cl_dim=cl_dim)
    if x_local.device.type != "cuda" or x_local.dtype != torch.bfloat16:
        raise ValueError(f"epic_layer_bf16 takes bfloat16 CUDA tensors, got {x_local.dtype} on "
                         f"{x_local.device}")
    b, n, h, l, s = _check_shapes(args, dims, torch.bfloat16)
    dev = x_local.device
    xo = torch.empty_like(x_local)
    go = torch.empty_like(x_global)
    if b == 0:
        return xo, go
    # the per-set biases of the two local products, float32, between the
    # library's two kernels
    biases = torch.empty((b, 2, h), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.epic_layer_fwd_bf16(
            *(t.data_ptr() for t in args), xo.data_ptr(), go.data_ptr(), biases.data_ptr(),
            b, n, h, l, s, tg_dim, tl_dim, cg_dim, cl_dim, float(sum_scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"epic_layer_bf16 kernel launch failed: cudaError {err}")
    epic_layer_bf16.launches += 1
    return xo, go


epic_layer_bf16.launches = 0


def epic_layer(
    x_local, x_global, mask, set_feat,
    wg1, bg1, wg2, bg2, w1x, w1s, b1, w2x, w2s, b2,
    sum_scale: float = 1e-2,
    tg_dim: int = 0,
    tl_dim: int = 0,
    cg_dim: int = 0,
    cl_dim: int = 0,
):
    """One EPiC layer: for CUDA tensors the float32 kernel, or the bfloat16
    one (`epic_layer_bf16`) for bfloat16 tensors; the plain version for CPU
    tensors. Arguments as in `epic_layer_reference`."""
    args = (x_local, x_global, mask, set_feat, wg1, bg1, wg2, bg2, w1x, w1s, b1, w2x, w2s, b2)
    dims = dict(sum_scale=sum_scale, tg_dim=tg_dim, tl_dim=tl_dim, cg_dim=cg_dim,
                cl_dim=cl_dim)
    if x_local.device.type == "cpu":
        return epic_layer_reference(*args, **dims)
    if x_local.device.type != "cuda":
        raise ValueError(f"epic_layer runs on cuda or cpu, got {x_local.device}")
    if x_local.dtype == torch.bfloat16:
        return epic_layer_bf16(*args, **dims)

    dev = x_local.device
    b, n, h, l, s = _check_shapes(args, dims, torch.float32)
    xo = torch.empty_like(x_local)
    go = torch.empty_like(x_global)
    if b == 0:
        return xo, go
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.epic_layer_fwd_f32(
            *(t.data_ptr() for t in args), xo.data_ptr(), go.data_ptr(),
            b, n, h, l, s, tg_dim, tl_dim, cg_dim, cl_dim, float(sum_scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"epic_layer kernel launch failed: cudaError {err}")
    epic_layer.launches += 1
    return xo, go


epic_layer.launches = 0
