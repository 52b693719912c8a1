"""Whole-set attention for short particle sets: the two CUDA kernels' wrappers
and their plain PyTorch versions.

Counterpart of particle_fm_tpu/ops/pallas/short_attention.py. Layout as
there: q (B, Lq, H, D), k/v (B, Lk, H, D), `kv_mask` (B, Lk) with 1 for a
real key (None: all keys), `attn_bias` (B, H, Lq, Lk) additive, result
(B, Lq, H, D). Only keys are masked, by adding (mask - 1) * 1e9 to the
scores, never -inf: a set whose keys are all masked gets uniform weights over
its keys and stays finite. Padded query rows are computed like real rows.

  `packed_short_attention`  self-attention shapes, Lq == Lk <= 256; the row
      normalisation comes after the PV product. Differentiable: the backward
      recomputes the plain version under autograd (the JAX custom_vjp does
      the same with its einsum form; there is no backward kernel).
  `fused_short_attention`   Lq != Lk allowed, both <= 512; full softmax
      before the PV product. Forward only: it refuses tensors that require
      grad.

Each wrapper runs its plain version (`*_reference`) for tensors on the CPU
and launches `csrc/short_attention.cu` for CUDA tensors; it never falls back
from one to the other. The kernels take float32 and read q, k and v where
they lie, as long as the last two axes (H, D) are packed: a slice of a fused
QKV projection needs no copy. Each wrapper counts its launches in
`<wrapper>.launches`.

The packed kernel does its two products on the tensor cores, each float32
product as three TF32 products (`csrc/attention_mma.cuh`; the arithmetic is
modelled in `ops/attention_tf32.py`). `packed_geometry` mirrors what its
launcher gives a block, and the wrapper refuses a shape whose bytes would not
fit one; `packed_launch_report` asks the built library for the same numbers,
and the kernel tests and chip_smoke.py hold the mirror against it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from particle_fm_tpu_torch.ops import _build

SOURCE = _build.CSRC_DIR / "short_attention.cu"
NEG = -1e9
MAX_PACKED_LEN = 256
MAX_FUSED_LEN = 512
MAX_HEAD_DIM = 64  # the kernels keep a query row and its output in registers
MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90
# the tile of csrc/attention_mma.cuh (m16n8k8): a warp owns 16 query rows and
# takes the staged keys 8 at a time
MMA_ROWS, MMA_KEYS = 16, 8
MMA_PRODUCTS = 3  # TF32 products per float32 product (head and remainder of each operand)


def mask_add(kv_mask: torch.Tensor | None, b: int, lk: int, like: torch.Tensor) -> torch.Tensor:
    """The (B, Lk) float32 term added to the scores: 0 for a real key, -1e9 for a masked one."""
    if kv_mask is None:
        return torch.zeros(b, lk, dtype=torch.float32, device=like.device)
    return (kv_mask.to(torch.float32) - 1.0) * (-NEG)


def padded_head_dim(d: int) -> int:
    """The head dim the kernels are compiled for: 8, 16, 32 or 64."""
    return next(p for p in (8, 16, 32, 64) if d <= p)


def packed_geometry(l: int, d: int) -> dict:
    """What `launch_packed` of csrc/short_attention.cu gives a block of the
    packed kernel for sets of `l` particles at head dim `d`: its warps (one
    per tile of 16 query rows, at most 16, 8 at head dim 64), the keys it
    stages (padded to whole tiles of 8) and its bytes of shared memory (K and
    V rows at a stride of D+4 floats, and the additive mask)."""
    dp = padded_head_dim(d)
    max_warps = MAX_PACKED_LEN // MMA_ROWS // (1 if dp <= 32 else 2)
    keys = -(-l // MMA_KEYS) * MMA_KEYS
    return {"warps": min(-(-l // MMA_ROWS), max_warps), "keys": keys,
            "smem_bytes": 4 * (2 * keys * (dp + 4) + keys)}


def launch_report(geometry_fn, instruction_fn, keys_name: str, *shape: int) -> dict:
    """What a library's `*_geometry` entry point says its launcher gives a
    block of a tensor-core kernel at `shape`: blocks per (set, head), warps,
    keys staged (under `keys_name`), bytes of shared memory, registers per
    thread, TF32 products per float32 product, and the instruction."""
    report = (ctypes.c_int * 6)()
    err = geometry_fn(*shape, report)
    if err != 0:
        raise RuntimeError(f"{geometry_fn.__name__}{shape} failed: cudaError {err}")
    names = ("blocks", "warps", keys_name, "smem_bytes", "registers_per_thread",
             "tf32_products_per_float32_product")
    return dict(zip(names, report), instruction=instruction_fn().decode())


def packed_launch_report(l: int, d: int, biased: bool = False) -> dict:
    """`launch_report` of the packed kernel, from the built library (needs a
    CUDA device); `packed_geometry(l, d)` mirrors its warps, keys and bytes."""
    lib = load_library()
    return launch_report(lib.packed_short_attention_geometry, lib.attention_mma_instruction,
                         "keys", l, d, int(biased))


def packed_short_attention_reference(q, k, v, kv_mask=None, attn_bias=None):
    """Plain version of the packed kernel: the JAX package's `_ref_math`."""
    b, d = q.shape[0], q.shape[-1]
    madd = mask_add(kv_mask, b, k.shape[1], q)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    s = s / math.sqrt(d) + madd[:, None, None, :]
    if attn_bias is not None:
        s = s + attn_bias.to(torch.float32)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(q.dtype), v)


def fused_short_attention_reference(q, k, v, kv_mask=None, attn_bias=None):
    """Plain version of the fused kernel: q scaled first, bias, then the
    additive mask, the softmax divided before the PV product."""
    b, _, _, d = q.shape
    scale = 1.0 / (d ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32) * scale, k.to(torch.float32))
    if attn_bias is not None:
        s = s + attn_bias.to(torch.float32)
    s = s + mask_add(kv_mask, b, k.shape[1], q)[:, None, None, :]
    s = s - s.max(dim=-1, keepdim=True).values
    p = torch.exp(s)
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32)).to(q.dtype)


def _declare(lib: ctypes.CDLL) -> None:
    for name in ("packed_short_attention_f32", "fused_short_attention_f32"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    geometry = lib.packed_short_attention_geometry
    geometry.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    geometry.restype = ctypes.c_int
    lib.attention_mma_instruction.argtypes = []
    lib.attention_mma_instruction.restype = ctypes.c_char_p


def load_library() -> ctypes.CDLL:
    """The kernel library built from `SOURCE`, loaded once."""
    return _build.load_library(SOURCE, _declare)


def check_heads(name: str, t: torch.Tensor, shape: tuple[int, ...], device: torch.device) -> None:
    """q, k or v: float32 on `device`, of `shape`, the last two axes packed."""
    _build.check_tensor(name, t, shape, device, contiguous=False)
    d = shape[-1]
    if t.stride(3) != 1 or t.stride(2) != d or t.stride(1) < shape[2] * d or t.stride(0) < 0:
        raise ValueError(f"{name} is not contiguous in its last two axes (strides {t.stride()})")


def _launch(entry: str, q, k, v, kv_mask, attn_bias, max_len: int) -> torch.Tensor:
    """Checks shared by both wrappers, then the launch of `entry`."""
    dev = q.device
    if q.ndim != 4:
        raise ValueError(f"q must be (B, Lq, H, D), got {tuple(q.shape)}")
    b, lq, h, d = q.shape
    lk = k.shape[1] if k.ndim == 4 else -1
    if not (0 < lq <= max_len and 0 < lk <= max_len):
        raise ValueError(f"{entry}: set lengths Lq={lq}, Lk={lk} outside the kernel's 1..{max_len}: "
                         "use the einsum path or attn_impl='flash'")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"{entry}: head dim {d} outside the kernel's 1..{MAX_HEAD_DIM}")
    check_heads("q", q, (b, lq, h, d), dev)
    check_heads("k", k, (b, lk, h, d), dev)
    check_heads("v", v, (b, lk, h, d), dev)
    if kv_mask is not None:
        kv_mask = kv_mask.to(torch.float32).contiguous()
        _build.check_tensor("kv_mask", kv_mask, (b, lk), dev)
    if attn_bias is not None:
        _build.check_tensor("attn_bias", attn_bias, (b, h, lq, lk), dev)

    out = torch.empty((b, lq, h, d), dtype=torch.float32, device=dev)
    if b == 0 or h == 0:
        return out
    fn = getattr(load_library(), entry)
    with torch.cuda.device(dev):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_mask is None else kv_mask.data_ptr(),
            None if attn_bias is None else attn_bias.data_ptr(),
            out.data_ptr(), b, lq, lk, h, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    return out


def _packed_forward(q, k, v, kv_mask, attn_bias) -> torch.Tensor:
    if q.device.type == "cpu":
        return packed_short_attention_reference(q, k, v, kv_mask, attn_bias)
    if q.device.type != "cuda":
        raise ValueError(f"packed_short_attention runs on cuda or cpu, got {q.device}")
    l, d = q.shape[1], q.shape[-1]
    if 0 < l <= MAX_PACKED_LEN and 0 < d <= MAX_HEAD_DIM:  # else `_launch` says what is wrong
        smem = packed_geometry(l, d)["smem_bytes"]
        if smem > MAX_SMEM:
            raise ValueError(
                f"packed_short_attention keeps one head's keys and values in shared memory: "
                f"L={l} at head dim {d} needs {smem} bytes of {MAX_SMEM}: use the einsum path or "
                "attn_impl='flash'"
            )
    out = _launch("packed_short_attention_f32", q, k, v, kv_mask, attn_bias, MAX_PACKED_LEN)
    packed_short_attention.launches += 1
    return out


class _PackedAttention(torch.autograd.Function):
    """Forward through the kernel; backward through the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, attn_bias):
        ctx.save_for_backward(q, k, v, kv_mask, attn_bias)
        return _packed_forward(q, k, v, kv_mask, attn_bias)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, kv_mask, attn_bias = ctx.saved_tensors
        need = (*ctx.needs_input_grad[:3], ctx.needs_input_grad[4])
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip((q, k, v, attn_bias), need)]
            out = packed_short_attention_reference(*inputs[:3], kv_mask, inputs[3])
            wanted = [i for i, n in enumerate(need) if n]
            grads = dict(zip(wanted, torch.autograd.grad(out, [inputs[i] for i in wanted],
                                                         grad_out)))
        return grads.get(0), grads.get(1), grads.get(2), None, grads.get(3)


def packed_short_attention(q, k, v, kv_mask=None, attn_bias=None) -> torch.Tensor:
    """Whole-set self-attention (Lq == Lk <= 256): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    lq, lk = q.shape[1], k.shape[1]
    if lk != lq:
        raise ValueError(
            "packed_short_attention requires Lq == Lk (self-attention shapes); "
            f"got Lq={lq}, Lk={lk}: use the einsum path or attn_impl='flash'."
        )
    if attn_bias is not None:
        attn_bias = attn_bias.to(torch.float32)
    tensors = [t for t in (q, k, v, attn_bias) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _PackedAttention.apply(q, k, v, kv_mask, attn_bias)
    return _packed_forward(q, k, v, kv_mask, attn_bias)


packed_short_attention.launches = 0


def fused_short_attention(q, k, v, kv_mask=None, attn_bias=None) -> torch.Tensor:
    """Whole-set attention, Lq != Lk allowed (both <= 512), forward only: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    tensors = [t for t in (q, k, v, attn_bias) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "fused_short_attention is forward only (the JAX kernel has no VJP either): "
            "call it under torch.no_grad(), or use attn_impl='packed' or 'auto' to train"
        )
    if q.device.type == "cpu":
        return fused_short_attention_reference(q, k, v, kv_mask, attn_bias)
    if q.device.type != "cuda":
        raise ValueError(f"fused_short_attention runs on cuda or cpu, got {q.device}")
    out = _launch("fused_short_attention_f32", q, k, v, kv_mask, attn_bias, MAX_FUSED_LEN)
    fused_short_attention.launches += 1
    return out


fused_short_attention.launches = 0
