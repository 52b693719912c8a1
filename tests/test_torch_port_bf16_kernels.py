"""PyTorch port, the four bfloat16 kernels held against their plain versions
on the same bfloat16 inputs on the card: `epic_layer_bf16` against
`epic_layer_reference`, `packed_short_attention_bf16` against the packed
plain version's bfloat16 arithmetic (the Pallas `_packed_kernel`'s),
`fused_short_attention_bf16` and `flash_masked_attention_bf16` against
theirs (float32 on the upcast inputs, one rounding of the output).

Tolerance: 2 bfloat16 ulps of the largest |out| of the plain version
(`bf16_tol`). Kernel and plain version sum their float32 products in other
orders and take exp by other means; a value that lands next to a rounding
boundary of bfloat16 then rounds the other way, 1 ulp of that value, and an
intermediate that does (x1 in EPiC, P in packed) moves the output by a
fraction of that. Every test needs an NVIDIA GPU and skips without one.

This file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_bf16_kernels.py
"""

from __future__ import annotations

import math

import pytest
import torch

from particle_fm_tpu_torch.ops import epic_layer as ops
from particle_fm_tpu_torch.ops import flash_attention as fa
from particle_fm_tpu_torch.ops import short_attention as sa

BF16 = torch.bfloat16


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def bf16_tol(ref: torch.Tensor, ulps: int = 2) -> float:
    """`ulps` bfloat16 ulps of the largest |ref| (8 bits of mantissa)."""
    top = float(ref.float().abs().max())
    return ulps * 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def assert_within(got: torch.Tensor, want: torch.Tensor) -> None:
    torch.cuda.synchronize()
    assert got.dtype == BF16 and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    err = float((got.float() - want.float()).abs().max())
    assert err <= bf16_tol(want), (err, bf16_tol(want))


def _epic_args(b, n, h, lat, tg, tl, cg, cl, seed, device):
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen) * 0.3
    w = lambda *s: torch.randn(*s, generator=gen) / s[0] ** 0.5
    s = max(tg, tl) + max(cg, cl)
    counts = torch.randint(1, n + 1, (b, 1), generator=gen)
    mask = (torch.arange(n)[None, :] < counts).float()
    args = [r(b, n, h), r(b, lat), mask, r(b, s),
            w(tg + 2 * h + lat + cg, h), r(h), w(tg + h + cg, lat), r(lat),
            w(h, h), w(tl + lat + cl, h), r(h), w(h, h), w(tl + cl, h), r(h)]
    args = [a.to(device) if i == 2 else a.to(device, BF16) for i, a in enumerate(args)]
    return [a.contiguous() for a in args], dict(sum_scale=1e-2, tg_dim=tg, tl_dim=tl, cg_dim=cg,
                                                cl_dim=cl)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,h,lat,tg,tl,cg,cl", [
    # the served flagship, lhco/bigPC, jetclass/jetclass_cond
    (640, 150, 128, 10, 32, 32, 2, 2), (128, 558, 256, 256, 32, 32, 10, 10),
    (512, 128, 300, 16, 32, 32, 12, 0),
    # tiles of 64 rows that span sets; widths off 16 and off 8; the cap
    (3, 17, 128, 10, 32, 32, 2, 2), (5, 41, 48, 10, 32, 0, 2, 0), (4, 70, 3, 16, 6, 6, 1, 1),
    (3, 33, 140, 7, 5, 5, 3, 3), (2, 1, 512, 512, 32, 32, 12, 12),
])
def test_epic_bf16_kernel_matches_plain_version(cuda, b, n, h, lat, tg, tl, cg, cl):
    args, dims = _epic_args(b, n, h, lat, tg, tl, cg, cl, b + n + h, cuda)
    before = ops.epic_layer_bf16.launches
    xo, go = ops.epic_layer(*args, **dims)
    assert ops.epic_layer_bf16.launches == before + 1
    rx, rg = ops.epic_layer_reference(*args, **dims)
    assert_within(xo, rx)
    assert_within(go, rg)


def _attention_inputs(b, lq, lk, h, d, seed, device, masked=True, bias=False, fused_qkv=False):
    gen = torch.Generator().manual_seed(seed)
    if fused_qkv:
        qkv = torch.randn(b, lq, 3 * h * d, generator=gen).to(device, BF16)
        q, k, v = (t.view(b, lq, h, d) for t in qkv.chunk(3, dim=-1))
    else:
        q, k, v = (torch.randn(b, l, h, d, generator=gen).to(device, BF16) for l in (lq, lk, lk))
    mask = None
    if masked:
        counts = torch.randint(1, lk + 1, (b, 1), generator=gen)
        mask = (torch.arange(lk)[None, :] < counts).float().to(device)
    ab = torch.randn(b, h, lq, lk, generator=gen).to(device) if bias else None
    return q, k, v, mask, ab


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,d,bias,fused_qkv", [
    (640, 150, 16, 16, False, True), (64, 150, 16, 16, True, False),
    (3, 1, 3, 8, False, False), (3, 15, 3, 12, True, False), (3, 16, 3, 32, False, False),
    (3, 17, 3, 64, True, False), (3, 256, 3, 64, False, False), (4, 37, 3, 33, False, False),
])
def test_packed_bf16_kernel_matches_plain_version(cuda, b, l, h, d, bias, fused_qkv):
    q, k, v, mask, ab = _attention_inputs(b, l, l, h, d, l + d, cuda, bias=bias,
                                          fused_qkv=fused_qkv)
    before = sa.packed_short_attention_bf16.launches
    out = sa.packed_short_attention(q, k, v, mask, ab)
    assert sa.packed_short_attention_bf16.launches == before + 1
    assert_within(out, sa.packed_short_attention_reference(q, k, v, mask, ab))


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,h,d,masked,bias", [
    (640, 4, 150, 16, 8, True, False), (640, 150, 4, 16, 8, False, False),
    (16, 37, 150, 16, 8, True, True), (3, 5, 5, 3, 12, True, True), (3, 17, 512, 3, 32, True, False),
    (3, 512, 17, 3, 64, True, True), (3, 1, 1, 3, 8, True, False), (3, 4, 7, 5, 6, True, False),
])
def test_fused_bf16_kernel_matches_plain_version(cuda, b, lq, lk, h, d, masked, bias):
    q, k, v, mask, ab = _attention_inputs(b, lq, lk, h, d, lq + lk + d, cuda, masked, bias)
    before = sa.fused_short_attention_bf16.launches
    with torch.no_grad():
        out = sa.fused_short_attention(q, k, v, mask, ab)
    assert sa.fused_short_attention_bf16.launches == before + 1
    assert_within(out, sa.fused_short_attention_reference(q, k, v, mask, ab))


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,h,d,masked,fused_qkv", [
    (32, 1, 6000, 2, 128, True, False), (256, 279, 279, 16, 16, True, True),
    (4, 1500, 1500, 4, 128, True, False), (3, 5, 5, 3, 8, True, False),
    (3, 17, 17, 3, 12, True, False), (3, 558, 558, 3, 32, True, False),
    (3, 558, 558, 3, 64, False, False), (2, 3, 900, 3, 64, True, False),
])
def test_flash_bf16_kernel_matches_plain_version(cuda, b, lq, lk, h, d, masked, fused_qkv):
    q, k, v, mask, _ = _attention_inputs(b, lq, lk, h, d, lq + d, cuda, masked,
                                         fused_qkv=fused_qkv)
    before = fa.flash_masked_attention_bf16.launches
    with torch.no_grad():
        out = fa.flash_masked_attention(q, k, v, mask)
    assert fa.flash_masked_attention_bf16.launches == before + 1
    assert_within(out, fa.flash_masked_attention_reference(q, k, v, mask))


@pytest.mark.cuda
def test_bf16_libraries_name_the_bf16_instruction(cuda):
    for lib_instruction in (ops.bf16_instruction, sa.bf16_instruction, fa.bf16_instruction):
        assert lib_instruction() == "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32"


@pytest.mark.cuda
def test_bf16_wrappers_refuse_float32_and_no_float32_kernel_takes_bf16(cuda):
    q, k, v, mask, _ = _attention_inputs(2, 16, 16, 2, 16, 0, cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        sa.packed_short_attention_bf16(q.float(), k.float(), v.float(), mask)
    with pytest.raises(TypeError, match="float32"):
        sa._launch("packed_short_attention_f32", q, k, v, mask, None, sa.MAX_PACKED_LEN)
    with pytest.raises(TypeError, match="bfloat16"):
        fa._launch("flash_masked_attention_bf16", q.float(), k.float(), v.float(), mask)
