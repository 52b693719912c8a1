"""Blockwise (flash) masked attention for sets of any length: the CUDA kernel's
wrapper and its plain PyTorch version.

Counterpart of particle_fm_tpu/ops/pallas/flash_attention.py. Layout as
there: q (B, Lq, H, D), k/v (B, Lk, H, D), `kv_mask` (B, Lk) with 1 for a
real key (None: all keys), result (B, Lq, H, D). No bias, forward only. The
softmax streams over the keys with a running maximum (from -1e9), a running
sum and an accumulator, so the (Lq, Lk) scores never exist in memory. Keys
are masked by adding (mask - 1) * 1e9, never -inf: a set whose keys are all
masked stays finite and spreads its weight over its Lk keys, as
`ops.attention.masked_attention` does. (The TPU kernel pads Lk to its chunk
and spreads such a set over the padded keys too; with one real key the two
agree.)

`flash_masked_attention` runs its plain version
(`flash_masked_attention_reference`) for tensors on the CPU and launches
`csrc/flash_attention.cu` for CUDA tensors; it never falls back from one to
the other. Both go through the custom ops `particle_fm::flash_masked_attention`
and `particle_fm::flash_masked_attention_bf16` (`torch.library`; as in
ops/short_attention.py): the launch geometry, the splits' scratch and the
class-token kernel's tickets are taken in the CUDA implementation, at the
call, so that an exported program builds its own in the process that runs
it. The kernel takes float32 and reads q, k and v where they lie, as long
as the last two axes (H, D) are packed, and head dims up to 128. It
counts its launches in `flash_masked_attention.launches`. With more than 4
query rows and head dims up to 64 the kernel runs on the tensor cores
(`csrc/attention_mma.cuh`, three TF32 products per float32 product;
`mma_geometry` mirrors its launcher and `mma_launch_report` asks the built
library for the same numbers), else on the CUDA cores. In bfloat16, at most
`DIRECT_MAX_ROWS` query rows (class tokens) take a kernel of their own that
splits the keys over one wave of resident blocks (`token_splits`;
`token_geometry` mirrors its launch, `token_launch_report` asks the library)
and merges the splits in the same launch; more rows at head dims up to 64 a
kernel that stages each (set, head)'s K and V once and stops at the set's
last real key (`mma_bf16_geometry`, `mma_bf16_launch_report`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from particle_fm_tpu_torch.ops import _build
from particle_fm_tpu_torch.ops._build import OPS_NAMESPACE
from particle_fm_tpu_torch.ops.short_attention import (MMA_KEYS, MMA_ROWS, check_heads,
                                                       launch_report, mask_add, padded_head_dim)

SOURCE = _build.CSRC_DIR / "flash_attention.cu"
NEG_INF = -1e9
BLOCK_K = 128  # keys per step of the plain version, the JAX kernel's block_k
MAX_HEAD_DIM = 128
MMA_MAX_HEAD_DIM = 64  # beyond, and with at most `DIRECT_MAX_ROWS` query rows, the CUDA cores
DIRECT_MAX_ROWS = 4
ROWS_PER_BLOCK = 128  # most query rows of a block (kRowsPerBlock in csrc/flash_attention.cu)
# blocks that fill the card's 132 SMs some 16 times over; with fewer (set,
# head, query tile) triples than this the keys are split over several blocks
_MIN_BLOCKS = 2048
_MIN_KEYS_PER_SPLIT = 256
# bfloat16 class tokens (at most `DIRECT_MAX_ROWS` query rows):
# flash_token_bf16_kernel in csrc/flash_attention.cu
TOKEN_WARPS = 8  # kTokWarps
TOKEN_BLOCKS_PER_SM = 2  # kTokBlocksPerSm, the kernel's launch bounds
_TOKEN_MIN_KEYS_PER_SPLIT = 128
# bfloat16, more than `DIRECT_MAX_ROWS` query rows at head dims up to 64:
# flash_mma_bf16_kernel in csrc/flash_attention.cu
BF16_WARPS = 6  # kFbWarps: most warps of a block, a tile of 16 query rows each
BF16_PV_PRODUCTS = 2  # kFbPvProducts: TF32 products of P . V (P's head and remainder)


def flash_masked_attention_reference(q, k, v, kv_mask=None, block_k: int = BLOCK_K):
    """Plain version: the streaming recurrence over chunks of `block_k` keys,
    as the JAX kernel's `_kernel` runs it (the last chunk may be short:
    nothing is padded)."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    qs = q.to(torch.float32) * (1.0 / (d ** 0.5))
    madd = mask_add(kv_mask, b, lk, q)
    m = torch.full((b, h, lq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, lq, d), dtype=torch.float32, device=q.device)
    for c0 in range(0, lk, block_k):
        ks = k[:, c0:c0 + block_k].to(torch.float32)
        vs = v[:, c0:c0 + block_k].to(torch.float32)
        s = torch.einsum("bqhd,bkhd->bhqk", qs, ks) + madd[:, None, None, c0:c0 + block_k]
        m_new = torch.maximum(m, s.max(dim=-1, keepdim=True).values)
        p = torch.exp(s - m_new)
        correction = torch.exp(m - m_new)
        l = l * correction + p.sum(dim=-1, keepdim=True)
        acc = acc * correction + torch.einsum("bhqk,bkhd->bhqd", p, vs)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def mma_geometry(lq: int, d: int) -> dict:
    """What `launch_flash_mma` of csrc/flash_attention.cu gives the
    tensor-core variant (more than 4 query rows, head dim <= 64): the blocks
    that share a set's query rows, equal in size, the warps of each (one per
    tile of 16 query rows), the keys of a staged tile and a block's bytes of
    shared memory (K and V rows at a stride of D+4 floats, and the mask)."""
    dp = padded_head_dim(d)
    tiles = -(-lq // MMA_ROWS)
    blocks = -(-tiles // (ROWS_PER_BLOCK // MMA_ROWS))
    tile_keys = 256 if dp <= 16 else 4096 // dp
    assert tile_keys % MMA_KEYS == 0
    return {"blocks": blocks, "warps": -(-tiles // blocks), "tile_keys": tile_keys,
            "smem_bytes": 4 * (2 * tile_keys * (dp + 4) + tile_keys)}


def mma_launch_report(lq: int, d: int) -> dict:
    """`short_attention.launch_report` of the tensor-core variant, from the
    built library (needs a CUDA device); `mma_geometry(lq, d)` mirrors its
    blocks, warps, keys of a tile and bytes."""
    lib = load_library()
    return launch_report(lib.flash_masked_attention_geometry, lib.attention_mma_instruction,
                         "tile_keys", lq, d)


def bf16_tile_keys(dp: int) -> int:
    """Keys of a staged tile of the bfloat16 tensor-core variant at padded head
    dim `dp` (fb_tile_keys): path D's 279 keys at head dim 16 fit one."""
    return 288 if dp <= 16 else 256 if dp <= 32 else 128


def mma_bf16_geometry(b: int, lq: int, lk: int, h: int, d: int) -> dict:
    """What `launch_flash_mma_bf16` of csrc/flash_attention.cu gives the
    bfloat16 tensor-core variant (more than 4 query rows, head dim <= 64):
    one block per (set, head, split) (`key_splits`, counted again from the
    keys each split takes), its warps (one per tile of 16 query rows, at most
    `BF16_WARPS`, equal passes over the set's tiles), the keys of a staged
    tile, its stages (2, a ring, when a split's keys exceed one tile) and the
    bytes of shared memory: V as float32 and the mask once, K and V as
    bfloat16 per stage (K at a row stride of D + 8)."""
    dp = max(16, padded_head_dim(d))
    per_split = -(-lk // key_splits(b, lq, lk, h))
    tile_keys = bf16_tile_keys(dp)
    stages = 1 if per_split <= tile_keys else 2
    tiles = -(-lq // MMA_ROWS)
    passes = -(-tiles // BF16_WARPS)
    return {"blocks": b * h * -(-lk // per_split), "warps": -(-tiles // passes), "passes": passes,
            "tile_keys": tile_keys, "stages": stages,
            "smem_bytes": 4 * (tile_keys * dp + tile_keys) + 2 * stages * tile_keys * (2 * dp + 8)}


def mma_bf16_launch_report(b: int, lq: int, lk: int, h: int, d: int) -> dict:
    """What the built library's launcher gives the bfloat16 tensor-core
    variant at this shape (needs a CUDA device): `mma_bf16_geometry`'s
    numbers, the registers per thread and the TF32 products of P . V, and
    the instructions of its two products."""
    lib = load_library()
    report = (ctypes.c_int * 8)()
    err = lib.flash_mma_bf16_geometry(b, lq, lk, h, d, key_splits(b, lq, lk, h), report)
    if err != 0:
        raise RuntimeError(f"flash_mma_bf16_geometry failed: cudaError {err}")
    names = ("blocks", "warps", "passes", "tile_keys", "stages", "smem_bytes",
             "registers_per_thread", "pv_tf32_products")
    return {**dict(zip(names, report)), "instruction": bf16_instruction(),
            "pv_instruction": lib.attention_mma_instruction().decode()}


def key_splits(b: int, lq: int, lk: int, h: int) -> int:
    """Over how many blocks the kernel splits one head's keys: 1 when the
    (set, head, block of `ROWS_PER_BLOCK` query rows) triples alone fill the
    card, else enough to reach `_MIN_BLOCKS` blocks, each with at least
    `_MIN_KEYS_PER_SPLIT` keys."""
    blocks = b * h * -(-lq // ROWS_PER_BLOCK)
    if blocks >= _MIN_BLOCKS:
        return 1
    return max(1, min(-(-_MIN_BLOCKS // blocks), lk // _MIN_KEYS_PER_SPLIT))


def token_splits(b: int, h: int, lk: int, sms: int) -> int:
    """Over how many blocks the bfloat16 class-token kernel splits one
    head's keys: as many as fit one wave of resident blocks
    (`TOKEN_BLOCKS_PER_SM` on each of `sms` SMs) beside the other (set,
    head) pairs, each with at least `_TOKEN_MIN_KEYS_PER_SPLIT` keys; 1 when
    the pairs alone fill a wave."""
    pairs = b * h
    wave = sms * TOKEN_BLOCKS_PER_SM
    if pairs >= wave:
        return 1
    return max(1, min(wave // pairs, lk // _TOKEN_MIN_KEYS_PER_SPLIT))


def token_geometry(b: int, lk: int, h: int, sms: int) -> dict:
    """What the launcher gives the bfloat16 class-token kernel: blocks (one
    per (set, head) and split, the splits counted again from the keys each
    takes, so that none is empty), warps of a block, the resident blocks an
    SM that the split count assumed, and the keys of a split."""
    splits = token_splits(b, h, lk, sms)
    per_split = -(-lk // splits)
    blocks = b * h * -(-lk // per_split)
    return {"blocks": blocks, "warps": TOKEN_WARPS,
            "resident_blocks_per_sm": TOKEN_BLOCKS_PER_SM, "keys_per_split": per_split}


def token_launch_report(b: int, lq: int, lk: int, h: int, d: int) -> dict:
    """What the built library's launcher gives the bfloat16 class-token
    kernel at this shape (needs a CUDA device): blocks, warps of a block,
    resident blocks an SM (CUDA's occupancy calculator), registers per
    thread; `token_geometry` mirrors the first three."""
    sms = _sm_count(torch.device("cuda", torch.cuda.current_device()))
    report = (ctypes.c_int * 4)()
    err = load_library().flash_token_bf16_geometry(b, lq, lk, h, d, token_splits(b, h, lk, sms),
                                                   report)
    if err != 0:
        raise RuntimeError(f"flash_token_bf16_geometry failed: cudaError {err}")
    names = ("blocks", "warps", "resident_blocks_per_sm", "registers_per_thread")
    return dict(zip(names, report))


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


_counters: dict[torch.device, torch.Tensor] = {}


def _token_counters(dev: torch.device, n: int) -> torch.Tensor:
    """The class-token kernel's tickets, one int per (set, head): zeroed
    once per device and size, and left at zero by every launch."""
    if dev not in _counters or _counters[dev].numel() < n:
        _counters[dev] = torch.zeros(n, dtype=torch.int32, device=dev)
    return _counters[dev]


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.flash_masked_attention_f32
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    geometry = lib.flash_masked_attention_geometry
    geometry.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    geometry.restype = ctypes.c_int
    lib.attention_mma_instruction.argtypes = []
    lib.attention_mma_instruction.restype = ctypes.c_char_p
    if hasattr(lib, "flash_masked_attention_bf16"):  # an earlier source, timed beside, may lack it
        fn = lib.flash_masked_attention_bf16
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        geometry = lib.flash_token_bf16_geometry
        geometry.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
        geometry.restype = ctypes.c_int
    if hasattr(lib, "flash_mma_bf16_geometry"):
        geometry = lib.flash_mma_bf16_geometry
        geometry.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
        geometry.restype = ctypes.c_int
        lib.attention_mma_bf16_instruction.argtypes = []
        lib.attention_mma_bf16_instruction.restype = ctypes.c_char_p


def load_library() -> ctypes.CDLL:
    """The kernel library built from `SOURCE`, loaded once."""
    return _build.load_library(SOURCE, _declare)


def bf16_instruction() -> str:
    """The tensor-core instruction of the bfloat16 kernel's Q . K^T, as the
    built library names it (needs the library; no device)."""
    return load_library().attention_mma_bf16_instruction().decode()


def _launch(entry: str, q, k, v, kv_mask) -> torch.Tensor:
    """Checks, then the op of `entry`, which takes q's type (`*_f32` float32,
    `*_bf16` bfloat16) and writes its output in it."""
    dev = q.device
    dtype = torch.bfloat16 if entry.endswith("_bf16") else torch.float32
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"q and k must be (B, L, H, D), got {tuple(q.shape)} and {tuple(k.shape)}")
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if lq <= 0 or lk <= 0:
        raise ValueError(f"flash_masked_attention: empty set (Lq={lq}, Lk={lk})")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_masked_attention: head dim {d} outside the kernel's 1..{MAX_HEAD_DIM}")
    check_heads("q", q, (b, lq, h, d), dev, dtype)
    check_heads("k", k, (b, lk, h, d), dev, dtype)
    check_heads("v", v, (b, lk, h, d), dev, dtype)
    if kv_mask is not None:
        kv_mask = kv_mask.to(torch.float32).contiguous()
        _build.check_tensor("kv_mask", kv_mask, (b, lk), dev)
    return _OPS[entry](q, k, v, kv_mask)


def _run(entry: str, q, k, v, kv_mask) -> torch.Tensor:
    """The CUDA implementation of the op of `entry`: the splits (from the
    card's SMs for class tokens in bfloat16), their scratch, the tickets,
    and the launch on the current stream (the arguments as `_launch`
    checked them)."""
    dev = q.device
    dtype = q.dtype
    b, lq, h, d = q.shape
    lk = k.shape[1]
    out = torch.empty((b, lq, h, d), dtype=dtype, device=dev)
    if b == 0 or h == 0:
        return out
    token = dtype == torch.bfloat16 and lq <= DIRECT_MAX_ROWS
    if token:
        splits = token_splits(b, h, lk, _sm_count(dev))
    else:
        splits = key_splits(b, lq, lk, h)
    scratch = None
    if splits > 1:  # per split an accumulator (B, Lq, H, D) and a pair (m, l), float32
        scratch = torch.empty(splits * b * lq * h * (d + 2), dtype=torch.float32, device=dev)
    counters = () if dtype == torch.float32 else (
        _token_counters(dev, b * h).data_ptr() if token and splits > 1 else None,)
    fn = getattr(load_library(), entry)
    with torch.cuda.device(dev):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_mask is None else kv_mask.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), *counters, b, lq, lk, h, d, splits,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    return out


def flash_masked_attention(q, k, v, kv_mask=None) -> torch.Tensor:
    """Streaming-softmax masked attention, any Lq and Lk, forward only: for
    CUDA tensors the float32 kernel, or the bfloat16 one
    (`flash_masked_attention_bf16`) for bfloat16 tensors; the plain version
    for CPU tensors."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_masked_attention is forward only (the JAX kernel has no VJP either): "
            "call it under torch.no_grad(), or use attn_impl='einsum' to train"
        )
    dev = q.device
    if dev.type == "cpu":
        bf16 = q.dtype == torch.bfloat16
        return (torch.ops.particle_fm.flash_masked_attention_bf16 if bf16
                else torch.ops.particle_fm.flash_masked_attention)(q, k, v, kv_mask)
    if dev.type != "cuda":
        raise ValueError(f"flash_masked_attention runs on cuda or cpu, got {dev}")
    if q.dtype == torch.bfloat16:
        return flash_masked_attention_bf16(q, k, v, kv_mask)
    return _launch("flash_masked_attention_f32", q, k, v, kv_mask)


flash_masked_attention.launches = 0


def flash_masked_attention_bf16(q, k, v, kv_mask=None) -> torch.Tensor:
    """The bfloat16 kernel on CUDA tensors: q, k, v bfloat16, the mask
    float32, the result bfloat16, as `flash_masked_attention_reference`
    computes it on bfloat16 inputs (Q . K^T as bfloat16 products with the
    scale applied to S, P kept in float32; with at most `DIRECT_MAX_ROWS`
    query rows float32 arithmetic on the upcast values, in one launch that
    merges its own splits). Forward only. Counts its launches in
    `flash_masked_attention_bf16.launches`."""
    if q.device.type != "cuda" or q.dtype != torch.bfloat16:
        raise ValueError(f"flash_masked_attention_bf16 takes bfloat16 CUDA tensors, got "
                         f"{q.dtype} on {q.device}")
    return _launch("flash_masked_attention_bf16", q, k, v, kv_mask)


flash_masked_attention_bf16.launches = 0


# The custom ops, as in ops/short_attention.py: the CUDA implementation
# launches and counts in the wrapper's `launches`.

_LIB = torch.library.Library(OPS_NAMESPACE, "FRAGMENT")


def _register(op: str, entry: str, wrapper) -> None:
    _LIB.define(f"{op}(Tensor q, Tensor k, Tensor v, Tensor? kv_mask) -> Tensor")

    def launch(q, k, v, kv_mask):
        out = _run(entry, q, k, v, kv_mask)
        wrapper.launches += 1
        return out

    def plain(q, k, v, kv_mask):
        return flash_masked_attention_reference(q, k, v, kv_mask).contiguous()

    _LIB.impl(op, launch, "CUDA")
    _LIB.impl(op, plain, "CPU")
    torch.library.register_fake(f"{OPS_NAMESPACE}::{op}",
                                lambda q, k, v, kv_mask: q.new_empty(q.shape), lib=_LIB)


_register("flash_masked_attention", "flash_masked_attention_f32", flash_masked_attention)
_register("flash_masked_attention_bf16", "flash_masked_attention_bf16", flash_masked_attention_bf16)
# by library entry, as `_launch` takes them
_OPS = {"flash_masked_attention_f32": torch.ops.particle_fm.flash_masked_attention,
        "flash_masked_attention_bf16": torch.ops.particle_fm.flash_masked_attention_bf16}
