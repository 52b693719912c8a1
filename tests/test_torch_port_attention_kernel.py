"""PyTorch port, the two short-set attention CUDA kernels
(csrc/short_attention.cu; the packed one on the tensor cores through
csrc/attention_mma.cuh) held against their plain PyTorch versions on the
same inputs on the card: atol 1e-4 / rtol 1e-4 (float32; the kernels sum in
another order and take exp through exp2; the packed kernel's products are
three TF32 products each, which drops terms of 2^-22; the fused kernel takes
its softmax with a running maximum and divides at the end). Every test needs
an NVIDIA GPU and skips without one.

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
    _check_packed(*_inputs(b, l, l, h, d, b + l + d, cuda, masked, bias, fused_qkv))


def _check_packed(q, k, v, mask, ab):
    before = ops.packed_short_attention.launches
    out = ops.packed_short_attention(q, k, v, mask, ab)
    torch.cuda.synchronize()
    assert ops.packed_short_attention.launches == before + 1
    assert out.shape == q.shape and out.is_contiguous()
    assert torch.isfinite(out).all()  # padded query rows included
    torch.testing.assert_close(out, ops.packed_short_attention_reference(q, k, v, mask, ab), **TOL)
    torch.testing.assert_close(out, attn.masked_attention(q, k, v, mask, ab), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 12, 16, 32, 64])
@pytest.mark.parametrize("l", [1, 15, 16, 17, 256])
def test_packed_kernel_at_the_edges_of_its_tiles(cuda, l, d):
    """Tiles of 16 query rows and 8 keys: sets that end one short of a tile,
    on it and one past it, the longest set, every padded head dim."""
    _check_packed(*_inputs(3, l, l, 3, d, l + d, cuda, bias=d in (12, 64)))


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True])
def test_packed_kernel_reads_operands_that_allow_no_16_byte_loads(cuda, bias):
    q, k, v, mask, ab = _inputs(3, 37, 37, 3, 16, 5, cuda, bias=bias)
    q, k, v = (_offset_by_one_float(t) for t in (q, k, v))
    assert q.data_ptr() % 16 == 4
    _check_packed(q, k, v, mask, ab)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,d", [(64, 150, 16, 16), (4, 256, 2, 64), (8, 40, 4, 8)])
def test_packed_kernel_with_scores_of_some_tens(cuda, b, l, h, d):
    """q and k times 4, as a trained network's sharp heads give: the error of
    split-precision TF32 grows with the operands, and unit-scale inputs do
    not show it."""
    q, k, v, mask, ab = _inputs(b, l, l, h, d, 21, cuda, fused_qkv=True)
    q, k = q * 4.0, k * 4.0
    assert torch.einsum("bqhd,bkhd->bhqk", q, k).abs().max() / d ** 0.5 > 30.0
    _check_packed(q, k, v, mask, ab)


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("d", [1, 8, 9, 16, 17, 32, 33, 64])
def test_packed_geometry_mirrors_the_launcher(cuda, d, bias):
    """The wrapper's `packed_geometry` against what the built library's
    launcher gives a block, at every set length the kernel takes."""
    for l in range(1, ops.MAX_PACKED_LEN + 1):
        mirror = ops.packed_geometry(l, d)
        report = ops.packed_launch_report(l, d, bias)
        assert {key: report[key] for key in mirror} == mirror, (l, d)
    assert report["blocks"] == 1 and report["tf32_products_per_float32_product"] == ops.MMA_PRODUCTS
    assert "m16n8k8" in report["instruction"] and "tf32" in report["instruction"]
    assert 0 < report["registers_per_thread"] * 32 * report["warps"] <= 65536


@pytest.mark.cuda
def test_packed_wrapper_refuses_what_does_not_fit_a_block(cuda, monkeypatch):
    q, k, v, mask, _ = _inputs(2, 150, 150, 4, 16, 0, cuda)
    monkeypatch.setattr(ops, "MAX_SMEM", ops.packed_geometry(150, 16)["smem_bytes"] - 1)
    with pytest.raises(ValueError, match="shared memory"):
        ops.packed_short_attention(q, k, v, mask)
    _check_packed(*_inputs(2, 144, 144, 4, 12, 1, cuda, bias=True))  # 8 keys fewer: it fits


def _offset_by_one_float(t):
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


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


def _check_fused(q, k, v, mask, ab):
    before = ops.fused_short_attention.launches
    out = ops.fused_short_attention(q, k, v, mask, ab)
    torch.cuda.synchronize()
    assert ops.fused_short_attention.launches == before + 1
    assert out.shape == q.shape and torch.isfinite(out).all()
    torch.testing.assert_close(out, ops.fused_short_attention_reference(q, k, v, mask, ab), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 12, 32, 64])
@pytest.mark.parametrize("lq,lk", [(l, l) for l in (1, 5, 17, 512)]
                         + [(4, l) for l in (1, 5, 17, 512)] + [(l, 4) for l in (5, 17, 512)])
def test_fused_kernel_at_its_edges(cuda, lq, lk, d):
    """Keys in registers (at most 8) or streamed by 8 warps, query rows in
    groups of 4 or 2; 3 heads, so H*D is no multiple of 128 and a row ends
    inside a warp's 32 slots; a bias at head dims 12 and 64."""
    _check_fused(*_inputs(3, lq, lk, 3, d, lq + lk + d, cuda, bias=d in (12, 64)))


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk", [(4, 150), (150, 4), (37, 150)])
@pytest.mark.parametrize("bias", [False, True])
def test_fused_kernel_reads_operands_that_allow_no_16_byte_loads(cuda, lq, lk, bias):
    q, k, v, mask, ab = _inputs(3, lq, lk, 16, 8, 5, cuda, bias=bias)
    q, k, v = (_offset_by_one_float(t) for t in (q, k, v))
    assert q.data_ptr() % 16 == 4
    _check_fused(q, k, v, mask, ab)


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
    # the fused kernel streams the keys: 500 keys at head dim 64 need no shared
    # memory of a block (the first version staged them and refused this)
    big = torch.zeros(1, 4, 1, 64, device=cuda)
    keys = torch.zeros(1, 500, 1, 64, device=cuda)
    assert torch.equal(ops.fused_short_attention(big, keys, keys), big)


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
