"""PyTorch port, the two short-set attention CUDA kernels
(csrc/short_attention.cu) held against their plain PyTorch versions on the
same inputs on the card: atol 1e-4 / rtol 1e-4 (float32; the kernels sum in
another order and take exp through exp2). Every test needs an NVIDIA GPU and
skips without one.

This file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_attention_kernel.py
"""

from __future__ import annotations

import pytest
import torch

from particle_fm_tpu_torch.ops import attention as attn
from particle_fm_tpu_torch.ops import short_attention as ops

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, lq, lk, h, d, seed, device, masked=True, bias=False, fused_qkv=False):
    gen = torch.Generator().manual_seed(seed)
    if fused_qkv:  # three slices of one projection output, read in place
        qkv = torch.randn(b, lq, 3 * h * d, generator=gen).to(device)
        q, k, v = (t.view(b, lq, h, d) for t in qkv.chunk(3, dim=-1))
    else:
        q = torch.randn(b, lq, h, d, generator=gen).to(device)
        k = torch.randn(b, lk, h, d, generator=gen).to(device)
        v = torch.randn(b, lk, h, d, generator=gen).to(device)
    mask = None
    if masked:
        counts = torch.randint(1, lk + 1, (b, 1), generator=gen)
        mask = (torch.arange(lk)[None, :] < counts).float().to(device)
    ab = torch.randn(b, h, lq, lk, generator=gen).to(device) if bias else None
    return q, k, v, mask, ab


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,l,h,d,masked,bias,fused_qkv",
    [(640, 150, 16, 16, True, False, True), (64, 150, 16, 16, True, True, False),
     (3, 10, 4, 16, False, False, False), (5, 16, 2, 8, True, True, True),
     (2, 256, 3, 64, True, False, False), (4, 33, 5, 12, True, True, False),
     (3, 7, 2, 3, True, False, True), (2, 1, 1, 32, False, False, False),
     (2, 129, 2, 24, True, False, False)],
)
def test_packed_kernel_matches_plain_version(cuda, b, l, h, d, masked, bias, fused_qkv):
    q, k, v, mask, ab = _inputs(b, l, l, h, d, b + l + d, cuda, masked, bias, fused_qkv)
    before = ops.packed_short_attention.launches
    out = ops.packed_short_attention(q, k, v, mask, ab)
    torch.cuda.synchronize()
    assert ops.packed_short_attention.launches == before + 1
    assert out.shape == (b, l, h, d) and out.is_contiguous()
    assert torch.isfinite(out).all()  # padded query rows included
    torch.testing.assert_close(out, ops.packed_short_attention_reference(q, k, v, mask, ab), **TOL)
    torch.testing.assert_close(out, attn.masked_attention(q, k, v, mask, ab), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,lq,lk,h,d,masked,bias",
    [(640, 4, 150, 16, 8, True, False), (640, 150, 4, 16, 8, False, False),
     (16, 37, 150, 16, 8, True, True), (3, 5, 13, 4, 16, True, False),
     (3, 10, 10, 4, 16, True, True), (2, 512, 512, 2, 32, True, False),
     (2, 9, 300, 3, 64, True, False), (4, 20, 7, 3, 12, True, True),
     (3, 6, 1, 2, 3, False, False), (2, 3, 17, 2, 20, True, False), (2, 40, 2, 5, 8, True, False)],
)
def test_fused_kernel_matches_plain_version(cuda, b, lq, lk, h, d, masked, bias):
    q, k, v, mask, ab = _inputs(b, lq, lk, h, d, b + lq + lk + d, cuda, masked, bias)
    before = ops.fused_short_attention.launches
    out = ops.fused_short_attention(q, k, v, mask, ab)
    torch.cuda.synchronize()
    assert ops.fused_short_attention.launches == before + 1
    assert out.shape == (b, lq, h, d) and torch.isfinite(out).all()
    torch.testing.assert_close(out, ops.fused_short_attention_reference(q, k, v, mask, ab), **TOL)
    torch.testing.assert_close(out, attn.masked_attention(q, k, v, mask, ab), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["packed", "fused"])
def test_kernels_give_uniform_weights_to_a_fully_masked_set(cuda, kernel):
    q, k, v, mask, _ = _inputs(3, 20, 20, 4, 16, 0, cuda)
    mask[1] = 0.0
    fn = getattr(ops, f"{kernel}_short_attention")
    out = fn(q, k, v, mask)
    assert torch.isfinite(out).all()
    uniform = v[1].mean(dim=0, keepdim=True).expand(20, 4, 16)
    torch.testing.assert_close(out[1], uniform, **TOL)
    torch.testing.assert_close(out, getattr(ops, f"{kernel}_short_attention_reference")(q, k, v, mask), **TOL)


@pytest.mark.cuda
def test_packed_kernel_backward_is_the_plain_version(cuda):
    q, k, v, mask, ab = _inputs(2, 12, 12, 2, 8, 11, cuda, bias=True)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, ab)]
    before = ops.packed_short_attention.launches
    ops.packed_short_attention(leaves[0], leaves[1], leaves[2], mask, leaves[3]).pow(2).sum().backward()
    assert ops.packed_short_attention.launches == before + 1
    refs = [t.clone().requires_grad_(True) for t in (q, k, v, ab)]
    ops.packed_short_attention_reference(refs[0], refs[1], refs[2], mask, refs[3]).pow(2).sum().backward()
    for a, r in zip(leaves, refs):
        torch.testing.assert_close(a.grad, r.grad, **TOL)


@pytest.mark.cuda
def test_wrappers_refuse_bad_inputs(cuda):
    q, k, v, mask, _ = _inputs(2, 8, 8, 2, 16, 0, cuda)
    for fn in (ops.packed_short_attention, ops.fused_short_attention):
        with pytest.raises(TypeError, match="float32"):
            fn(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask)
        with pytest.raises(ValueError, match="contiguous"):
            fn(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, mask)
        with pytest.raises(ValueError, match="shape"):
            fn(q, k, v[:, :, :1], mask)
        with pytest.raises(ValueError, match="cpu"):
            fn(q, k.cpu(), v, mask)
        wide = torch.zeros(1, 4, 1, 128, device=cuda)
        with pytest.raises(ValueError, match="head dim"):
            fn(wide, wide, wide)
    long = torch.zeros(1, 300, 1, 8, device=cuda)
    with pytest.raises(ValueError, match="lengths"):
        ops.packed_short_attention(long, long, long)
    with pytest.raises(ValueError, match="Lq == Lk"):
        ops.packed_short_attention(q, k[:, :5], v[:, :5])
    with pytest.raises(NotImplementedError, match="forward only"):
        ops.fused_short_attention(q.clone().requires_grad_(True), k, v)
    big = torch.zeros(1, 4, 1, 64, device=cuda)
    keys = torch.zeros(1, 500, 1, 64, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ops.fused_short_attention(big, keys, keys)


@pytest.mark.cuda
def test_dispatcher_reaches_the_kernels_on_the_card(cuda):
    q, k, v, mask, _ = _inputs(2, 8, 8, 2, 16, 0, cuda)
    counts = lambda: (ops.packed_short_attention.launches, ops.fused_short_attention.launches)
    p0, f0 = counts()
    attn.attention(q, k, v, mask, impl="packed")
    attn.attention(q, k[:, :5], v[:, :5], mask[:, :5], impl="packed")  # cross shape: einsum path
    assert counts() == (p0 + 1, f0)
    attn.attention(q, k[:, :5], v[:, :5], mask[:, :5], impl="fused")
    assert counts() == (p0 + 1, f0 + 1)
    # long sets at head dim 128 go to the flash kernel, not to these two
    long = torch.zeros(1, 1024, 1, 128, device=cuda)
    assert attn.attention(long, long, long).shape == long.shape
    assert counts() == (p0 + 1, f0 + 1)
