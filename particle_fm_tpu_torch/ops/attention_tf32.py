"""Numerics of the tensor-core attention kernels, in plain PyTorch.

`csrc/attention_mma.cuh` does the two products of attention (scores = q . k,
out = p . v) with `mma.sync` in split-precision TF32: three TF32 products per
float32 product (ops/tf32.py says what they are and models one).

This module models the kernels' attention on any device, so that the choice (one
product or three, which operands are split) is settled and tested without a
GPU: `streaming_attention_tf32` walks over the keys in steps with a running
maximum, a running sum and an accumulator as the kernels' tile step does,
the scale, mask and bias added in float32 to the accumulated score, and
`packed_attention_tf32` / `flash_attention_tf32` give it the two kernels'
conventions. The functions are not on any serving path.
"""

from __future__ import annotations

import torch

from particle_fm_tpu_torch.ops.short_attention import mask_add
from particle_fm_tpu_torch.ops.tf32 import product_tf32

STEP_KEYS = 8  # keys of one tile step of the kernels (the n of m16n8k8)


def streaming_attention_tf32(q, k, v, madd, attn_bias=None, *, products: int = 3,
                             pv_products: int | None = None, step: int = STEP_KEYS,
                             m_init: float = float("-inf"), min_sum: float = 0.0) -> torch.Tensor:
    """q (B, Lq, H, D), k/v (B, Lk, H, D), madd (B, Lk) additive mask,
    attn_bias (B, H, Lq, Lk) or None -> (B, Lq, H, D).

    Per step of `step` keys: s = (q . k) * scale + madd (+ bias) in float32 on
    the accumulated product, running maximum m (from `m_init`), p = exp(s - m),
    running sum l and accumulator o rescaled by exp(m_old - m). Result
    o / max(l, min_sum). `products` TF32 products per float32 product in
    q . k, `pv_products` (default: the same) in p . v."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    pv_products = products if pv_products is None else pv_products
    scale = 1.0 / (d ** 0.5)
    q, k, v = (t.to(torch.float32) for t in (q, k, v))
    m = torch.full((b, h, lq, 1), m_init, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros((b, h, lq, d), dtype=torch.float32, device=q.device)
    for j0 in range(0, lk, step):
        ks, vs = k[:, j0:j0 + step], v[:, j0:j0 + step]
        s = product_tf32("bqhd,bkhd->bhqk", q, ks, products) * scale
        s = s + madd[:, None, None, j0:j0 + step]
        if attn_bias is not None:
            s = s + attn_bias[..., j0:j0 + step].to(torch.float32)
        m_new = torch.maximum(m, s.max(dim=-1, keepdim=True).values)
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        o = o * corr + product_tf32("bhqk,bkhd->bhqd", p, vs, pv_products)
        m = m_new
    return (o / torch.clamp(l, min=min_sum)).permute(0, 2, 1, 3).contiguous()


def packed_attention_tf32(q, k, v, kv_mask=None, attn_bias=None, products: int = 3, **kw):
    """The packed kernel's conventions: maximum from -inf, normalised after
    the PV product, optional bias."""
    madd = mask_add(kv_mask, q.shape[0], k.shape[1], q)
    return streaming_attention_tf32(q, k, v, madd, attn_bias, products=products, **kw)


def flash_attention_tf32(q, k, v, kv_mask=None, products: int = 3, **kw):
    """The flash kernel's conventions: maximum from -1e9, sum floored at
    1e-30, no bias."""
    madd = mask_add(kv_mask, q.shape[0], k.shape[1], q)
    return streaming_attention_tf32(q, k, v, madd, None, products=products, m_init=-1e9,
                                    min_sum=1e-30, **kw)
