"""PyTorch port, the fused EPiC layer's CUDA kernel (csrc/epic_layer.cu) held
against its plain PyTorch version on the same inputs on the card:
atol 1e-4 / rtol 1e-4 (float32; the kernel sums in another order than the
library matmul, and its two local matmuls are three TF32 products per float32
product on the tensor cores, which drops terms of 2^-21). The shapes take in
the served flagship, the widths of every EPiC config in configs/ (H 128, 256
and 300, L 10, 16 and 256), cond on either MLP path alone, the edges of the
kernel's row tiles (N of 15, 16, 17) and its width cap. Every test needs an
NVIDIA GPU and skips without one.

This file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_kernel.py
"""

from __future__ import annotations

import pytest
import torch

from particle_fm_tpu_torch.ops import epic_layer as ops


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _random_layer_args(b, n, h, lat, tg, tl, cg, cl, seed, device, x_scale=1.0):
    """Inputs of one layer; cond is max(cg, cl) wide and feeds the global
    MLPs when cg > 0, the local biases when cl > 0. Weights of scale 1/sqrt(fan_in)."""
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen) * 0.3
    w = lambda *s: torch.randn(*s, generator=gen) / s[0] ** 0.5
    s = max(tg, tl) + max(cg, cl)
    counts = torch.randint(1, n + 1, (b, 1), generator=gen)
    mask = (torch.arange(n)[None, :] < counts).float()
    args = [r(b, n, h) * x_scale, r(b, lat), mask, r(b, s),
            w(tg + 2 * h + lat + cg, h), r(h), w(tg + h + cg, lat), r(lat),
            w(h, h), w(tl + lat + cl, h), r(h), w(h, h), w(tl + cl, h), r(h)]
    return [a.to(device).contiguous() for a in args], dict(sum_scale=1e-2, tg_dim=tg,
                                                           tl_dim=tl, cg_dim=cg, cl_dim=cl)


SHAPES = [
    # the served flagship (fm_tops150_cond), lhco/bigPC, jetclass/jetclass_cond
    (640, 150, 128, 10, 32, 32, 2, 2), (128, 558, 256, 256, 32, 32, 10, 10),
    (512, 128, 300, 16, 32, 32, 12, 0),
    # cond on one path alone; no cond; no t
    (7, 30, 48, 10, 32, 0, 2, 0), (5, 41, 128, 10, 32, 32, 0, 3), (3, 33, 128, 10, 0, 32, 0, 0),
    (5, 558, 256, 16, 0, 0, 0, 0),
    # the edges of the row tiles (16 rows an m16 tile, 32 a warp tile, 64 a tile)
    (2, 1, 32, 4, 6, 6, 1, 1), (3, 15, 128, 10, 32, 32, 2, 2), (3, 16, 128, 10, 32, 32, 2, 2),
    (3, 17, 128, 10, 32, 32, 2, 2), (3, 65, 64, 10, 32, 32, 2, 2),
    # widths: padded to 16, weights in shared memory or read through L2, the cap
    (4, 150, 136, 10, 32, 32, 2, 2), (3, 70, 140, 10, 32, 32, 2, 2), (6, 200, 50, 7, 5, 5, 3, 3),
    (2, 9, 3, 256, 0, 0, 0, 0), (3, 40, 300, 16, 32, 32, 12, 0), (3, 40, 320, 16, 32, 32, 4, 4),
    (2, 37, 512, 512, 32, 32, 2, 2), (2, 20, 511, 7, 3, 3, 1, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,h,lat,tg,tl,cg,cl", SHAPES)
def test_kernel_matches_plain_version(cuda, b, n, h, lat, tg, tl, cg, cl):
    args, dims = _random_layer_args(b, n, h, lat, tg, tl, cg, cl, seed=b + n + h, device=cuda)
    before = ops.epic_layer.launches
    xo, go = ops.epic_layer(*args, **dims)
    torch.cuda.synchronize()
    assert ops.epic_layer.launches == before + 1
    rx, rg = ops.epic_layer_reference(*args, **dims)
    assert torch.isfinite(xo).all()  # padded rows included
    torch.testing.assert_close(xo, rx, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(go, rg, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [48, 128, 256, 300])
def test_kernel_with_x_times_4(cuda, h):
    """x times 4: the error of split-precision TF32 grows with the operands,
    and unit-scale inputs do not show it."""
    args, dims = _random_layer_args(16, 150, h, 10, 32, 32, 2, 2, seed=h, device=cuda,
                                    x_scale=4.0)
    xo, go = ops.epic_layer(*args, **dims)
    rx, rg = ops.epic_layer_reference(*args, **dims)
    torch.testing.assert_close(xo, rx, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(go, rg, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,h,lat,tg,tl,cg,cl", SHAPES)
def test_launch_report_is_the_launch(cuda, b, n, h, lat, tg, tl, cg, cl):
    """What the library reports of its launcher: the instruction and three
    TF32 products per float32 product, the weights in shared memory up to
    H=128, at most one block per set and per SM, and a block that fits an SM."""
    s = max(tg, tl) + max(cg, cl)
    report = ops.launch_report(b, n, h, lat, s, tg, tl, cg, cl)
    assert "m16n8k8" in report["instruction"] and "tf32" in report["instruction"]
    assert report["tf32_products_per_float32_product"] == 3
    assert 0 < report["blocks"] <= min(b, torch.cuda.get_device_properties(0).multi_processor_count)
    assert 0 < report["warps"] <= 32 and report["tile_rows"] in (32, 64)
    assert 0 < report["smem_bytes"] <= 232448
    assert 0 < report["registers_per_thread"] * 32 * report["warps"] <= 65536
    if h <= 128:
        assert report["weights_in_shared_memory"] == 1
    if h >= 256:
        assert report["weights_in_shared_memory"] == 0


@pytest.mark.cuda
def test_kernel_wrapper_refuses_bad_inputs(cuda):
    args, dims = _random_layer_args(2, 8, 32, 4, 0, 0, 0, 0, seed=0, device=cuda)
    bad_dtype = [args[0].double()] + args[1:]
    with pytest.raises(TypeError):
        ops.epic_layer(*bad_dtype, **dims)
    bad_layout = [args[0].transpose(1, 2).contiguous().transpose(1, 2)] + args[1:]
    with pytest.raises(ValueError, match="contiguous"):
        ops.epic_layer(*bad_layout, **dims)
    bad_shape = args[:4] + [args[4][1:]] + args[5:]
    with pytest.raises(ValueError, match="shape"):
        ops.epic_layer(*bad_shape, **dims)
    wide, dims = _random_layer_args(1, 4, ops.MAX_WIDTH + 8, 4, 0, 0, 0, 0, seed=0, device=cuda)
    with pytest.raises(ValueError, match="hidden width"):
        ops.epic_layer(*wide, **dims)
    two_conds, dims = _random_layer_args(1, 4, 16, 4, 0, 0, 2, 3, seed=0, device=cuda)
    with pytest.raises(ValueError, match="cond widths"):
        ops.epic_layer(*two_conds, **dims)


@pytest.mark.cuda
def test_kernel_empty_set_gives_nan_as_plain_version(cuda):
    args, dims = _random_layer_args(3, 20, 128, 10, 32, 32, 2, 2, seed=1, device=cuda)
    args[2][1] = 0.0  # set 1 has no real particle: 0/0 in its mean
    xo, go = ops.epic_layer(*args, **dims)
    rx, rg = ops.epic_layer_reference(*args, **dims)
    torch.testing.assert_close(xo, rx, atol=1e-4, rtol=1e-4, equal_nan=True)
    torch.testing.assert_close(go, rg, atol=1e-4, rtol=1e-4, equal_nan=True)
    assert torch.isnan(xo[1]).all() and torch.isfinite(xo[[0, 2]]).all()
