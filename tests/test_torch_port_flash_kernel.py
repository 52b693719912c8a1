"""PyTorch port, the blockwise flash attention CUDA kernel
(csrc/flash_attention.cu) held against its plain PyTorch version and against
the einsum attention on the same inputs on the card: atol 1e-4 / rtol 1e-4
(float32; the kernel sums in another order, rescales every 8 keys and takes
exp through exp2; with more than 4 query rows and head dims up to 64 it runs
on the tensor cores through csrc/attention_mma.cuh, three TF32 products per
float32 product, which drops terms of 2^-22). Every test needs an NVIDIA GPU
and skips without one.

This file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_flash_kernel.py
"""

from __future__ import annotations

import pytest
import torch

from particle_fm_tpu_torch.ops import attention as attn
from particle_fm_tpu_torch.ops import flash_attention as ops
from particle_fm_tpu_torch.ops import short_attention

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, lq, lk, h, d, seed, device, masked=True, strided=False):
    gen = torch.Generator().manual_seed(seed)
    if strided and lq == lk:  # three slices of one projection output, read in place
        qkv = torch.randn(b, lq, 3 * h * d, generator=gen).to(device)
        q, k, v = (t.view(b, lq, h, d) for t in qkv.chunk(3, dim=-1))
    elif strided:  # k and v as slices of one (B, Lk, 2*H*D) projection output
        q = torch.randn(b, lq, h, d, generator=gen).to(device)
        kv = torch.randn(b, lk, 2 * h * d, generator=gen).to(device)
        k, v = (t.view(b, lk, h, d) for t in kv.chunk(2, dim=-1))
    else:
        q = torch.randn(b, lq, h, d, generator=gen).to(device)
        k = torch.randn(b, lk, h, d, generator=gen).to(device)
        v = torch.randn(b, lk, h, d, generator=gen).to(device)
    mask = None
    if masked:
        counts = torch.randint(1, lk + 1, (b, 1), generator=gen)
        mask = (torch.arange(lk)[None, :] < counts).float().to(device)
    return q, k, v, mask


def _check(q, k, v, mask):
    before = ops.flash_masked_attention.launches
    out = ops.flash_masked_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert ops.flash_masked_attention.launches == before + 1
    assert out.shape == q.shape and out.is_contiguous()
    assert torch.isfinite(out).all()  # padded query rows included
    torch.testing.assert_close(out, ops.flash_masked_attention_reference(q, k, v, mask), **TOL)
    torch.testing.assert_close(out, attn.masked_attention(q, k, v, mask), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("lq", [1, 37, 279])
@pytest.mark.parametrize("lk", [4, 279, 1500, 6000])
def test_flash_kernel_matches_plain_version(cuda, d, lq, lk):
    h = 2 if d >= 64 else 3
    b = 2 if lq * lk > 300_000 else 3
    _check(*_inputs(b, lq, lk, h, d, d + lq + lk, cuda, strided=(lq + lk) % 2 == 0))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,lq,lk,h,d,masked,strided",
    [(32, 1, 6000, 2, 128, True, False),      # MDMA's class token on calorimeter showers
     (256, 279, 279, 16, 16, True, True),     # the transformer on 279-particle sets
     (4, 1500, 1500, 4, 128, True, False), (4, 1500, 1500, 4, 128, False, True),
     (2, 1, 6000, 2, 128, False, True), (1, 1, 6000, 8, 32, True, True),
     (3, 5, 1000, 2, 20, True, False), (3, 130, 9, 5, 3, True, False),
     (2, 4, 2049, 1, 100, True, False), (700, 2, 33, 2, 64, True, True)],
)
def test_flash_kernel_served_and_odd_shapes(cuda, b, lq, lk, h, d, masked, strided):
    _check(*_inputs(b, lq, lk, h, d, b + lq + lk + d, cuda, masked, strided))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 12, 16, 32, 64])
@pytest.mark.parametrize("l", [5, 16, 17, 129, 558])
def test_flash_kernel_at_the_edges_of_its_tiles(cuda, l, d):
    """The tensor-core variant's tiles of 16 query rows and 8 keys, its blocks
    of 128 rows and its staged tiles of keys: sets that end just past one."""
    _check(*_inputs(3, l, l, 3, d, l + d, cuda, strided=l % 2 == 1))


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk,d", [(37, 37, 16), (9, 300, 64), (2, 300, 64)])
def test_flash_kernel_reads_operands_that_allow_no_16_byte_loads(cuda, lq, lk, d):
    q, k, v, mask = _inputs(3, lq, lk, 3, d, 5, cuda)
    q, k, v = (_offset_by_one_float(t) for t in (q, k, v))
    assert k.data_ptr() % 16 == 4
    _check(q, k, v, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,h,d", [(32, 279, 279, 16, 16), (2, 600, 1500, 2, 64),
                                         (4, 1, 3000, 2, 128)])
def test_flash_kernel_with_scores_of_some_tens(cuda, b, lq, lk, h, d):
    """q and k times 4, as a trained network's sharp heads give: the error of
    split-precision TF32 grows with the operands, and unit-scale inputs do
    not show it. The middle case splits its keys over blocks and merges."""
    q, k, v, mask = _inputs(b, lq, lk, h, d, 21, cuda, strided=True)
    q, k = q * 4.0, k * 4.0
    assert torch.einsum("bqhd,bkhd->bhqk", q, k).abs().max() / d ** 0.5 > 30.0
    _check(q, k, v, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 8, 9, 16, 17, 32, 33, 64])
def test_mma_geometry_mirrors_the_launcher(cuda, d):
    """The wrapper's `mma_geometry` against what the built library's launcher
    gives a block of the tensor-core variant."""
    for lq in (*range(5, 300), 558, 1500, 6000):
        mirror = ops.mma_geometry(lq, d)
        report = ops.mma_launch_report(lq, d)
        assert {key: report[key] for key in mirror} == mirror, (lq, d)
    assert report["tf32_products_per_float32_product"] == short_attention.MMA_PRODUCTS
    assert report["instruction"] == short_attention.packed_launch_report(150, 16)["instruction"]
    for lq, d_ in ((4, d), (37, 128)):  # the CUDA-core variants have no such report
        with pytest.raises(RuntimeError, match="cudaError"):
            ops.mma_launch_report(lq, d_)


def _offset_by_one_float(t):
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk,d", [(20, 20, 16), (1, 3000, 128), (150, 40, 64)])
def test_flash_kernel_gives_uniform_weights_to_a_fully_masked_set(cuda, lq, lk, d):
    q, k, v, mask = _inputs(3, lq, lk, 2, d, 0, cuda)
    mask[1] = 0.0
    out = ops.flash_masked_attention(q, k, v, mask)
    assert torch.isfinite(out).all()
    uniform = v[1].mean(dim=0, keepdim=True).expand(lq, 2, d)
    torch.testing.assert_close(out[1], uniform, **TOL)
    torch.testing.assert_close(out, ops.flash_masked_attention_reference(q, k, v, mask), **TOL)


@pytest.mark.cuda
def test_flash_wrapper_refuses_bad_inputs(cuda):
    q, k, v, mask = _inputs(2, 8, 8, 2, 16, 0, cuda)
    fn = ops.flash_masked_attention
    with pytest.raises(TypeError, match="float32"):
        fn(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask)
    with pytest.raises(ValueError, match="contiguous"):
        fn(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, mask)
    with pytest.raises(ValueError, match="shape"):
        fn(q, k, v[:, :, :1], mask)
    with pytest.raises(ValueError, match="cpu"):
        fn(q, k.cpu(), v, mask)
    wide = torch.zeros(1, 4, 1, 256, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fn(wide, wide, wide)
    with pytest.raises(NotImplementedError, match="forward only"):
        fn(q.clone().requires_grad_(True), k, v)
    before = fn.launches
    for bad in (lambda: fn(q.bfloat16(), k, v), lambda: fn(wide, wide, wide)):
        with pytest.raises((TypeError, ValueError)):
            bad()
    assert fn.launches == before  # a refused call counts no launch


@pytest.mark.cuda
def test_dispatcher_reaches_the_flash_kernel_on_the_card(cuda):
    counts = lambda: (ops.flash_masked_attention.launches,
                      short_attention.packed_short_attention.launches)
    f0, p0 = counts()
    q, k, v, mask = _inputs(2, 300, 300, 2, 16, 0, cuda)
    out = attn.attention(q, k, v, mask, impl="flash")
    assert counts() == (f0 + 1, p0)
    torch.testing.assert_close(out, attn.attention(q, k, v, mask, impl="packed"), **TOL)  # einsum: L > 256
    assert counts() == (f0 + 1, p0)
    q, k, v, mask = _inputs(2, 1, 1024, 1, 128, 1, cuda)
    attn.attention(q, k, v, mask)  # auto: long set, head dim 128
    assert counts() == (f0 + 2, p0)
    attn.attention(q, k[:, :1000], v[:, :1000], mask[:, :1000])  # auto: short of 1024 keys, einsum
    attn.attention(q[..., :64], k[..., :64], v[..., :64], mask)  # auto: head dim 64, einsum
    assert counts() == (f0 + 2, p0)
    with pytest.raises(ValueError, match="attn_bias"):
        attn.attention(q, k, v, mask, torch.zeros(2, 1, 1, 1024, device=cuda), impl="flash")
