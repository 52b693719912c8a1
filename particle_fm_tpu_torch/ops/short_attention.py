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
and the kernel tests and chip_smoke.py hold the mirror against it. The
bfloat16 variants have their own mirrors: `packed_bf16_geometry` (against
`packed_bf16_launch_report`) and `fused_bf16_geometry` (against
`fused_bf16_launch_report`).
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
# the bfloat16 fused kernels (csrc/short_attention.cu): "from" (more than
# FUSED_REG_KEYS keys) and "to" (at most FUSED_REG_KEYS, in registers)
FUSED_REG_KEYS = 8  # kFusedRegKeys
FROM_WARPS, FROM_BLOCKS_PER_SM = 4, 5  # kFromWarps, kFromBlocksPerSm
FROM_ROWS, FROM_KEYS = 4, 2  # kFromRows (query rows of a lane), kFromKeys (keys loaded at once)
TO_WARPS, TO_BLOCKS_PER_SM = 8, 2  # kToWarps, kToBlocksPerSm
# the bfloat16 packed kernel: a block per (set, group of heads at least
# PACKED_BF16_COLS wide), its rows staged 8 elements more apart
PACKED_BF16_WARPS, PACKED_BF16_COLS = 4, 32  # kPackedBf16Warps, kPackedBf16Cols


def mask_add(kv_mask: torch.Tensor | None, b: int, lk: int, like: torch.Tensor) -> torch.Tensor:
    """The (B, Lk) float32 term added to the scores: 0 for a real key, -1e9 for a masked one."""
    if kv_mask is None:
        return torch.zeros(b, lk, dtype=torch.float32, device=like.device)
    return (kv_mask.to(torch.float32) - 1.0) * (-NEG)


def real_key_extents(kv_mask: torch.Tensor | None, b: int, lk: int) -> torch.Tensor:
    """How many keys of each set the bfloat16 packed, fused ("from") and flash
    kernels step over, (B,) int64: up to the set's last key with a nonzero mask when
    one of its keys has a mask of exactly 1 (the keys after it score about
    1e9 below the running maximum: exp gives exactly 0 for them, and the
    result is the same bit for bit), else all `lk` (a set whose keys are all
    masked, masks with fractional values only). None: all `lk`."""
    if kv_mask is None:
        return torch.full((b,), lk, dtype=torch.int64)
    m = kv_mask.to(torch.float32)
    nonzero = m != 0
    last = lk - 1 - nonzero.flip(-1).to(torch.int64).argmax(-1)
    return torch.where((m == 1).any(-1), last + 1, torch.full_like(last, lk))


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


def packed_bf16_steps(l: int) -> int:
    """The steps of 16 keys whose scores a warp of the bfloat16 packed kernel
    keeps in registers, at most (`packed_bf16_steps`): 4, 10 or 16 for sets
    of up to 64, 160 or 256 particles."""
    return 4 if l <= 64 else 10 if l <= 160 else 16


def packed_bf16_geometry(b: int, l: int, h: int, d: int, biased: bool = False) -> dict:
    """What `launch_packed_bf16` of csrc/short_attention.cu gives the bfloat16
    packed kernel for B sets of `l` particles at H heads of `d`: a block per
    (set, group of heads; DP the head dim padded to 16, 32 or 64, a group
    PACKED_BF16_COLS / DP heads or one head where DP is wider), its warps (at
    most PACKED_BF16_WARPS, taking the group's (head, tile of 16 query rows)
    pairs in turn), the heads of a group, the steps of 16 keys a warp keeps
    scores for (`packed_bf16_steps`), the bytes of shared memory (Q, K and V
    of the group for every row, rows 8 elements more apart than the group is
    wide, and the additive mask) and the resident blocks an SM its launch
    bounds ask for (16 warps where the scores, Q's fragments, O and, with a
    bias, its rows leave room in 128 registers a thread, else 8)."""
    dp = max(16, padded_head_dim(d))
    cols = max(PACKED_BF16_COLS, dp)
    group = cols // dp
    heads, rows = min(group, h), -(-l // MMA_ROWS) * MMA_ROWS
    steps = packed_bf16_steps(l)
    warps_per_sm = 16 if steps * 8 + dp + (16 if biased else 0) <= 96 else 8
    return {"blocks": b * -(-h // group), "warps": min(PACKED_BF16_WARPS, heads * rows // MMA_ROWS),
            "heads": heads, "register_steps": steps,
            "smem_bytes": 2 * 3 * rows * (cols + 8) + 4 * rows,
            "min_blocks_per_sm": -(-warps_per_sm // PACKED_BF16_WARPS)}


def packed_bf16_launch_report(b: int, l: int, h: int, d: int, biased: bool = False) -> dict:
    """What the built library's launcher gives the bfloat16 packed kernel at
    this shape (needs a CUDA device): `packed_bf16_geometry`'s numbers, the
    registers per thread, the resident blocks an SM (CUDA's occupancy
    calculator) and the instruction of its products."""
    lib = load_library()
    report = (ctypes.c_int * 8)()
    err = lib.packed_short_attention_bf16_geometry(b, l, h, d, int(biased), report)
    if err != 0:
        raise RuntimeError(f"packed_short_attention_bf16_geometry failed: cudaError {err}")
    names = ("blocks", "warps", "heads", "register_steps", "smem_bytes", "registers_per_thread",
             "resident_blocks_per_sm", "min_blocks_per_sm")
    return {**dict(zip(names, report)), "instruction": bf16_instruction()}


def _row_lanes(h: int, qp8: int) -> int:
    """Lanes that hold one row of `h` heads at `qp8` lanes a head (row_lanes)."""
    n = 1
    while n < h * qp8 and n < 32:
        n *= 2
    return n


def fused_bf16_geometry(b: int, lq: int, lk: int, h: int, d: int, sms: int) -> dict:
    """What `launch_fused_bf16` of csrc/short_attention.cu gives the bfloat16
    fused kernels: a lane holds 8 values of a head, a head spans `qp8`
    lanes, a row `_row_lanes` lanes (wider rows take `chunks` of 32).
    "from" (more than FUSED_REG_KEYS keys): a block per (set, chunk), each
    lane keeping FROM_ROWS query rows and loading FROM_KEYS keys at a time,
    the warps' partial results meeting in static shared memory. "to": an
    item is 32 / lanes query rows a load times 4 (2 with 5 to 8 keys), the
    items dealt in equal runs to TO_BLOCKS_PER_SM blocks on each of `sms`
    SMs. (The "from" kernel's static shared memory is the compiler's layout:
    the library reports it.)"""
    qp8 = next(p for p in (1, 2, 4, 8) if d <= 8 * p)
    chunks = -(-h * qp8 // 32)
    if lk > FUSED_REG_KEYS:
        return {"kernel": "from", "blocks": b * chunks, "warps": FROM_WARPS, "rows": FROM_ROWS,
                "keys": FROM_KEYS, "items_per_warp": 0,
                "resident_blocks_per_sm": FROM_BLOCKS_PER_SM}
    keys = 4 if lk <= 4 else FUSED_REG_KEYS
    rows = (4 if keys == 4 else 2) * (32 // _row_lanes(h, qp8))
    items = b * chunks * -(-lq // rows)
    per_warp = -(-items // (sms * TO_BLOCKS_PER_SM * TO_WARPS))
    return {"kernel": "to", "blocks": -(-items // (per_warp * TO_WARPS)), "warps": TO_WARPS,
            "rows": rows, "keys": keys, "items_per_warp": per_warp,
            "resident_blocks_per_sm": TO_BLOCKS_PER_SM}


def fused_bf16_launch_report(b: int, lq: int, lk: int, h: int, d: int,
                             biased: bool = False) -> dict:
    """What the built library's launcher gives the bfloat16 fused kernels at
    this shape (needs a CUDA device): `fused_bf16_geometry`'s numbers (the
    resident blocks an SM from CUDA's occupancy calculator) and the
    registers per thread."""
    report = (ctypes.c_int * 8)()
    err = load_library().fused_short_attention_bf16_geometry(b, lq, lk, h, d, int(biased), report)
    if err != 0:
        raise RuntimeError(f"fused_short_attention_bf16_geometry failed: cudaError {err}")
    names = ("blocks", "warps", "rows", "keys", "items_per_warp", "smem_bytes",
             "registers_per_thread", "resident_blocks_per_sm")
    return {"kernel": "from" if lk > FUSED_REG_KEYS else "to", **dict(zip(names, report))}


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
    """Plain version of the packed kernel. In float32 the JAX package's
    `_ref_math` (float64 alike); in bfloat16 the Pallas `_packed_kernel`'s
    arithmetic (`_packed_lowp`)."""
    if q.dtype == torch.bfloat16:
        return _packed_lowp(q, k, v, kv_mask, attn_bias)
    b, d = q.shape[0], q.shape[-1]
    madd = mask_add(kv_mask, b, k.shape[1], q)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    s = s / math.sqrt(d) + madd[:, None, None, :]
    if attn_bias is not None:
        s = s + attn_bias.to(torch.float32)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(q.dtype), v)


def _packed_lowp(q, k, v, kv_mask, attn_bias):
    """The Pallas `_packed_kernel` on bfloat16 q, k, v: Q . K^T as products of
    the bfloat16 values summed in float32, s * scale + mask (+ bias), the
    softmax over the whole row in float32, P rounded to q's type for the PV
    product (float32 sum), the normalisation after PV, one rounding of the
    output."""
    f32, b, d = torch.float32, q.shape[0], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(f32), k.to(f32))
    s = s * (1.0 / (d ** 0.5)) + mask_add(kv_mask, b, k.shape[1], q)[:, None, None, :]
    if attn_bias is not None:
        s = s + attn_bias.to(f32)
    p = torch.exp(s - s.max(dim=-1, keepdim=True).values)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype).to(f32), v.to(f32)) / denom
    return o.permute(0, 2, 1, 3).to(q.dtype)


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
    names = ["packed_short_attention_f32", "fused_short_attention_f32"]
    if hasattr(lib, "packed_short_attention_bf16"):  # an earlier source, timed beside, may lack it
        names += ["packed_short_attention_bf16", "fused_short_attention_bf16"]
        lib.attention_mma_bf16_instruction.argtypes = []
        lib.attention_mma_bf16_instruction.restype = ctypes.c_char_p
    for name, n_ints in (("fused_short_attention_bf16_geometry", 6),
                         ("packed_short_attention_bf16_geometry", 5)):
        if hasattr(lib, name):
            geometry = getattr(lib, name)
            geometry.argtypes = [ctypes.c_int] * n_ints + [ctypes.POINTER(ctypes.c_int)]
            geometry.restype = ctypes.c_int
    for name in names:
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


def bf16_instruction() -> str:
    """The tensor-core instruction of the bfloat16 packed kernel, as the built
    library names it (needs the library; no device)."""
    return load_library().attention_mma_bf16_instruction().decode()


def check_heads(name: str, t: torch.Tensor, shape: tuple[int, ...], device: torch.device,
                dtype: torch.dtype = torch.float32) -> None:
    """q, k or v: of `dtype` on `device`, of `shape`, the last two axes packed."""
    _build.check_tensor(name, t, shape, device, contiguous=False, dtype=dtype)
    d = shape[-1]
    if t.stride(3) != 1 or t.stride(2) != d or t.stride(1) < shape[2] * d or t.stride(0) < 0:
        raise ValueError(f"{name} is not contiguous in its last two axes (strides {t.stride()})")


def _launch(entry: str, q, k, v, kv_mask, attn_bias, max_len: int) -> torch.Tensor:
    """Checks shared by the wrappers, then the launch of `entry`, which takes
    q's type (`*_f32` float32, `*_bf16` bfloat16) and writes its output in it."""
    dev = q.device
    dtype = torch.bfloat16 if entry.endswith("_bf16") else torch.float32
    if q.ndim != 4:
        raise ValueError(f"q must be (B, Lq, H, D), got {tuple(q.shape)}")
    b, lq, h, d = q.shape
    lk = k.shape[1] if k.ndim == 4 else -1
    if not (0 < lq <= max_len and 0 < lk <= max_len):
        raise ValueError(f"{entry}: set lengths Lq={lq}, Lk={lk} outside the kernel's 1..{max_len}: "
                         "use the einsum path or attn_impl='flash'")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"{entry}: head dim {d} outside the kernel's 1..{MAX_HEAD_DIM}")
    check_heads("q", q, (b, lq, h, d), dev, dtype)
    check_heads("k", k, (b, lk, h, d), dev, dtype)
    check_heads("v", v, (b, lk, h, d), dev, dtype)
    if kv_mask is not None:
        kv_mask = kv_mask.to(torch.float32).contiguous()
        _build.check_tensor("kv_mask", kv_mask, (b, lk), dev)
    if attn_bias is not None:
        _build.check_tensor("attn_bias", attn_bias, (b, h, lq, lk), dev)

    out = torch.empty((b, lq, h, d), dtype=dtype, device=dev)
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


def packed_short_attention_bf16(q, k, v, kv_mask=None, attn_bias=None) -> torch.Tensor:
    """The bfloat16 packed kernel on CUDA tensors: q, k, v bfloat16, the mask
    and the bias float32; the result bfloat16, as `_packed_lowp` computes it
    (one pass over Q . K^T, keys past a set's last real key skipped,
    `packed_bf16_geometry`). Forward only. Counts its launches in
    `packed_short_attention_bf16.launches`."""
    if q.device.type != "cuda" or q.dtype != torch.bfloat16:
        raise ValueError(f"packed_short_attention_bf16 takes bfloat16 CUDA tensors, got "
                         f"{q.dtype} on {q.device}")
    if k.shape[1] != q.shape[1]:
        raise ValueError("packed_short_attention_bf16 requires Lq == Lk")
    out = _launch("packed_short_attention_bf16", q, k, v, kv_mask, attn_bias, MAX_PACKED_LEN)
    packed_short_attention_bf16.launches += 1
    return out


packed_short_attention_bf16.launches = 0


def _packed_forward(q, k, v, kv_mask, attn_bias) -> torch.Tensor:
    if q.device.type == "cpu":
        return packed_short_attention_reference(q, k, v, kv_mask, attn_bias)
    if q.device.type != "cuda":
        raise ValueError(f"packed_short_attention runs on cuda or cpu, got {q.device}")
    if q.dtype == torch.bfloat16:
        return packed_short_attention_bf16(q, k, v, kv_mask, attn_bias)
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
        if q.dtype != torch.float32:
            raise NotImplementedError(
                f"packed_short_attention trains in float32 only: its {q.dtype} backward comes "
                "with bfloat16 training")
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
    if q.dtype == torch.bfloat16:
        return fused_short_attention_bf16(q, k, v, kv_mask, attn_bias)
    out = _launch("fused_short_attention_f32", q, k, v, kv_mask, attn_bias, MAX_FUSED_LEN)
    fused_short_attention.launches += 1
    return out


fused_short_attention.launches = 0


def fused_short_attention_bf16(q, k, v, kv_mask=None, attn_bias=None) -> torch.Tensor:
    """The bfloat16 fused kernels on CUDA tensors: the float32 arithmetic of
    `fused_short_attention_reference` on the bfloat16 values, 16-byte loads,
    keys past a set's last real key skipped (`fused_bf16_geometry`).
    Forward only. Counts its launches in `fused_short_attention_bf16.launches`."""
    if q.device.type != "cuda" or q.dtype != torch.bfloat16:
        raise ValueError(f"fused_short_attention_bf16 takes bfloat16 CUDA tensors, got "
                         f"{q.dtype} on {q.device}")
    out = _launch("fused_short_attention_bf16", q, k, v, kv_mask, attn_bias, MAX_FUSED_LEN)
    fused_short_attention_bf16.launches += 1
    return out


fused_short_attention_bf16.launches = 0
