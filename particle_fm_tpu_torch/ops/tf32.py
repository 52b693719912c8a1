"""Split-precision TF32 in plain PyTorch: what the tensor-core kernels compute.

The kernels (`csrc/attention_mma.cuh`, `csrc/epic_layer.cu`, both on
`csrc/mma_tf32.cuh`) multiply on `mma.sync` in TF32: the matrix unit reads
the sign, the exponent and the upper 10 mantissa bits of each float32
operand and sums the exact products in float32. One such product keeps three
decimal digits. So every operand is split into a TF32 head and a remainder,

    hi = x rounded to 10 mantissa bits,   lo = x - hi   (exact),

and each float32 product is issued as three TF32 products, small terms
first: lo . hi + hi . lo + hi . hi. The unit reads the upper bits of lo,
which drops at most 2^-21 of x; the dropped lo . lo term is 2^-22 of the
product. `product_tf32` models this on any device, with 1, 2 or 3 products,
so that the choice is settled and tested without a GPU
(ops/attention_tf32.py, ops/epic_layer.py::epic_layer_tf32).
"""

from __future__ import annotations

import torch


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """What the matrix unit reads of a float32 operand: its low 13 mantissa
    bits cleared (10 mantissa bits stay, rounded towards zero)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to 10 mantissa bits, to nearest, ties away from zero
    (what `cvt.rna.tf32.f32` gives): half an ulp added to the magnitude, then
    the low 13 bits cleared."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(head, remainder as the unit reads it) of a float32 tensor. x - head
    is exact in float32 and at most 2^-11 |x|; head + remainder differs from
    x by less than 2^-21 |x|."""
    hi = tf32_round(x)
    return hi, tf32_truncate(x - hi)


def product_tf32(eq: str, a: torch.Tensor, b: torch.Tensor, products: int) -> torch.Tensor:
    """`einsum(eq, a, b)` as the matrix unit computes it with 1, 2 or 3 TF32
    products per float32 product (2: the remainder of `a` is dropped). The
    operands of each einsum hold TF32 values, so every product in it is exact
    in float32."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    mma = torch.einsum
    if products == 1:
        return mma(eq, a_hi, b_hi)
    if products == 2:
        return mma(eq, a_hi, b_lo) + mma(eq, a_hi, b_hi)
    if products == 3:
        return mma(eq, a_lo, b_hi) + mma(eq, a_hi, b_lo) + mma(eq, a_hi, b_hi)
    raise ValueError(f"products must be 1, 2 or 3, got {products}")
