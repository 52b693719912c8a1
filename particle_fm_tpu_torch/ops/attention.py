"""Masked multi-head attention core; counterpart of particle_fm_tpu/ops/attention.py.

Layout as in the JAX package: q (B, Lq, H, D), k/v (B, Lk, H, D), `kv_mask`
(B, Lk) bool or float, `attn_bias` (B, H, Lq, Lk) additive, result
(B, Lq, H, D). Only keys are masked ("let the padded nodes receive what they
want"): no query masking, and never a fully masked row as long as each set
has one real particle. The mask value is NEG_INF = -1e9, not -inf, so even a
fully masked row stays finite.

`masked_attention` and `class_token_attention` are plain tensor code, as in
the JAX package. `attention` dispatches by `impl` to them or to the three
attention CUDA kernels: the two of ops/short_attention.py (whole short sets)
and the blockwise one of ops/flash_attention.py (sets of any length).
"""

from __future__ import annotations

import contextlib
import math

import torch

from particle_fm_tpu_torch.ops import flash_attention, short_attention

NEG_INF = -1e9

_SCORES_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def scores_dtype_from(name: str | torch.dtype | None) -> torch.dtype | None:
    """A configuration's `scores_dtype` ("float32", "bfloat16", None) as a torch dtype."""
    if name is None or isinstance(name, torch.dtype):
        return name
    if name not in _SCORES_DTYPES:
        raise ValueError(f"unknown scores_dtype {name!r}")
    return _SCORES_DTYPES[name]


def masked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    attn_bias: torch.Tensor | None = None,
    scores_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Scaled dot-product attention with a key-side padding mask.

    `scores_dtype` is the storage type of the (B, H, Lq, Lk) score tensors.
    None or float32: float32 logits and softmax, the weights cast to q's
    type for the PV product. Another type (bfloat16): logits and exp() are
    stored in it, the maximum and the sum still accumulate in float32, and
    the row normalisation is applied to the (B, Lq, H, D) output after the PV
    product.
    """
    d = q.shape[-1]
    keep = None if kv_mask is None else kv_mask.to(torch.bool)[:, None, None, :]
    if scores_dtype is None or scores_dtype == torch.float32:
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
        logits = logits / math.sqrt(d)
        if attn_bias is not None:
            logits = logits + attn_bias.to(torch.float32)
        if keep is not None:
            logits = torch.where(keep, logits, NEG_INF)
        weights = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", weights, v)

    sdt = scores_dtype
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(sdt)
    # scalars made on the device: a copy from the host cannot be captured in a CUDA graph
    logits = logits * torch.full((), 1.0 / (d ** 0.5), dtype=sdt, device=q.device)
    if attn_bias is not None:
        logits = logits + attn_bias.to(sdt)
    if keep is not None:
        logits = torch.where(keep, logits, torch.full((), NEG_INF, dtype=sdt, device=q.device))
    m = logits.max(dim=-1, keepdim=True).values.detach()
    p = torch.exp((logits - m).to(torch.float32)).to(sdt)
    denom = p.sum(dim=-1, keepdim=True, dtype=torch.float32)  # (B, H, Lq, 1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)
    inv = (1.0 / denom[..., 0]).permute(0, 2, 1)[..., None]  # (B, Lq, H, 1)
    return (out * inv).to(q.dtype)


def class_token_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Single-query attention (Lq == 1) as elementwise products and
    reductions: q (B, 1, H, D), k/v (B, Lk, H, D) -> (B, 1, H, D), float32
    accumulation."""
    d = q.shape[-1]
    scale = 1.0 / (d ** 0.5)
    logits = torch.sum(q.to(torch.float32) * k.to(torch.float32), dim=-1) * scale  # (B, Lk, H)
    if kv_mask is not None:
        logits = torch.where(kv_mask.to(torch.bool)[..., None], logits, NEG_INF)
    weights = torch.softmax(logits, dim=1)
    out = torch.sum(weights[..., None] * v.to(torch.float32), dim=1, keepdim=True)
    return out.to(q.dtype)


_forward_mode = [0]  # depth of `forward_mode_ad` blocks


@contextlib.contextmanager
def forward_mode_ad():
    """A block that differentiates the network forward (`log_prob`): inside
    it `attention` raises NotImplementedError where it would launch an
    attention kernel (a CUDA tensor at a shape the kernel takes), since the
    kernels' autograd Functions have no forward-mode rule. Where the
    dispatcher takes the einsum path, or a kernel's plain version for CPU
    tensors, it computes as anywhere else; the plain version is called
    directly there, not through the kernel's custom op, which has no
    forward-mode or batching rule either (torch.func would see its output
    as constant)."""
    _forward_mode[0] += 1
    try:
        yield
    finally:
        _forward_mode[0] -= 1


def _kernel_launches(impl: str) -> None:
    if _forward_mode[0]:
        raise NotImplementedError(
            f"log_prob differentiates forward through the network, and the {impl} attention "
            "kernel, which would launch here (a CUDA tensor at a shape it takes), has no "
            "forward-mode rule: build the model with attn_impl='einsum'")


def auto_picks_flash(on_accel: bool, lk: int, d: int, has_bias: bool) -> bool:
    """The JAX package's rule for `impl="auto"`: long sets with head dims that
    are multiples of 128, on an accelerator, without bias."""
    return on_accel and not has_bias and lk >= 1024 and d % 128 == 0


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    attn_bias: torch.Tensor | None = None,
    impl: str = "auto",
    scores_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Dispatching front end, `impl` in {"auto", "einsum", "flash", "fused",
    "packed", "class_token"}, with the JAX package's rules.

    "auto": the blockwise flash kernel for long sets (Lk >= 1024) with head
      dims that are multiples of 128, without bias, on the card
      (`auto_picks_flash`); else the einsum path (`masked_attention`).
    "flash": `flash_attention.flash_masked_attention`, any Lq and Lk, head
      dims up to 128, forward only. It has no bias: one raises (the JAX
      dispatcher drops it unseen).
    "packed": `short_attention.packed_short_attention` for self-attention
      shapes (Lq == Lk <= 256) on the card; the einsum path for
      cross-attention shapes, longer sets or CPU tensors, so a model
      configuration can set it for a whole architecture. Differentiable.
    "fused": `short_attention.fused_short_attention`, explicit only, forward
      only.
    "class_token": `class_token_attention` for Lq == 1 without bias; it has
      no `scores_dtype` variant and rejects the option.
    """
    lq, lk, d = q.shape[1], k.shape[1], k.shape[-1]
    on_accel = q.device.type == "cuda"
    if impl == "class_token" and lq == 1 and attn_bias is None:
        if scores_dtype is not None:
            raise ValueError(
                "impl='class_token' does not support scores_dtype "
                "(always f32 accumulation); drop the option or use einsum"
            )
        return class_token_attention(q, k, v, kv_mask)
    if impl == "auto":
        impl = "flash" if auto_picks_flash(on_accel, lk, d, attn_bias is not None) else "einsum"
    if impl == "packed":
        if on_accel and lq == lk and lk <= short_attention.MAX_PACKED_LEN:
            _kernel_launches(impl)
            return short_attention.packed_short_attention(q, k, v, kv_mask, attn_bias)
        impl = "einsum"
    if impl == "flash":
        if attn_bias is not None:
            raise ValueError("impl='flash' takes no attn_bias; use 'einsum', 'packed' or 'fused'")
        if on_accel:
            _kernel_launches(impl)
        elif _forward_mode[0]:
            return flash_attention.flash_masked_attention_reference(q, k, v, kv_mask)
        return flash_attention.flash_masked_attention(q, k, v, kv_mask)
    if impl == "fused":
        if on_accel:
            _kernel_launches(impl)
        elif _forward_mode[0]:
            return short_attention.fused_short_attention_reference(q, k, v, kv_mask, attn_bias)
        return short_attention.fused_short_attention(q, k, v, kv_mask, attn_bias)
    return masked_attention(q, k, v, kv_mask, attn_bias, scores_dtype)
