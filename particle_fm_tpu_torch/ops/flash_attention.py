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
the other. The kernel takes float32 and reads q, k and v where they lie, as
long as the last two axes (H, D) are packed, and head dims up to 128. It
counts its launches in `flash_masked_attention.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from particle_fm_tpu_torch.ops import _build
from particle_fm_tpu_torch.ops.short_attention import check_heads, mask_add

SOURCE = _build.CSRC_DIR / "flash_attention.cu"
NEG_INF = -1e9
BLOCK_K = 128  # keys per step of the plain version, the JAX kernel's block_k
MAX_HEAD_DIM = 128
# blocks that fill the card's 132 SMs some 16 times over; with fewer (set,
# head, query tile) triples than this the keys are split over several blocks
_MIN_BLOCKS = 2048
_MIN_KEYS_PER_SPLIT = 256


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


def key_splits(b: int, lq: int, lk: int, h: int) -> int:
    """Over how many blocks the kernel splits one head's keys: 1 when the
    (set, head, 128-row query tile) triples alone fill the card, else enough
    to reach `_MIN_BLOCKS` blocks, each with at least `_MIN_KEYS_PER_SPLIT`
    keys."""
    blocks = b * h * -(-lq // 128)
    if blocks >= _MIN_BLOCKS:
        return 1
    return max(1, min(-(-_MIN_BLOCKS // blocks), lk // _MIN_KEYS_PER_SPLIT))


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.flash_masked_attention_f32
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


def load_library() -> ctypes.CDLL:
    """The kernel library built from `SOURCE`, loaded once."""
    return _build.load_library(SOURCE, _declare)


def flash_masked_attention(q, k, v, kv_mask=None) -> torch.Tensor:
    """Streaming-softmax masked attention, any Lq and Lk, forward only: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_masked_attention is forward only (the JAX kernel has no VJP either): "
            "call it under torch.no_grad(), or use attn_impl='einsum' to train"
        )
    dev = q.device
    if dev.type == "cpu":
        return flash_masked_attention_reference(q, k, v, kv_mask)
    if dev.type != "cuda":
        raise ValueError(f"flash_masked_attention runs on cuda or cpu, got {dev}")
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"q and k must be (B, L, H, D), got {tuple(q.shape)} and {tuple(k.shape)}")
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if lq <= 0 or lk <= 0:
        raise ValueError(f"flash_masked_attention: empty set (Lq={lq}, Lk={lk})")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_masked_attention: head dim {d} outside the kernel's 1..{MAX_HEAD_DIM}")
    check_heads("q", q, (b, lq, h, d), dev)
    check_heads("k", k, (b, lk, h, d), dev)
    check_heads("v", v, (b, lk, h, d), dev)
    if kv_mask is not None:
        kv_mask = kv_mask.to(torch.float32).contiguous()
        _build.check_tensor("kv_mask", kv_mask, (b, lk), dev)

    out = torch.empty((b, lq, h, d), dtype=torch.float32, device=dev)
    if b == 0 or h == 0:
        return out
    splits = key_splits(b, lq, lk, h)
    scratch = None
    if splits > 1:  # per split an accumulator (B, Lq, H, D) and a pair (m, l)
        scratch = torch.empty(splits * b * lq * h * (d + 2), dtype=torch.float32, device=dev)
    fn = load_library().flash_masked_attention_f32
    with torch.cuda.device(dev):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_mask is None else kv_mask.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), b, lq, lk, h, d, splits,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_masked_attention_f32 launch failed: cudaError {err}")
    flash_masked_attention.launches += 1
    return out


flash_masked_attention.launches = 0
