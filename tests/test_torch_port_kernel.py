"""PyTorch port, the fused EPiC layer's CUDA kernel (csrc/epic_layer.cu) held
against its plain PyTorch version on the same inputs on the card:
atol 1e-4 / rtol 1e-4 (float32; the kernel sums in another order than the
library matmul). Every test needs an NVIDIA GPU and skips without one.

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


def _random_layer_args(b, n, h, lat, tg, tl, c, seed, device):
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen) * 0.3
    s = max(tg, tl) + c
    counts = torch.randint(1, n + 1, (b, 1), generator=gen)
    mask = (torch.arange(n)[None, :] < counts).float()
    args = [r(b, n, h), r(b, lat), mask, r(b, s),
            r(tg + 2 * h + lat + c, h), r(h), r(tg + h + c, lat), r(lat),
            r(h, h), r(tl + lat + c, h), r(h), r(h, h), r(tl + c, h), r(h)]
    return [a.to(device).contiguous() for a in args], dict(sum_scale=1e-2, tg_dim=tg,
                                                           tl_dim=tl, c_dim=c)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,n,h,lat,tg,tl,c",
    [(640, 150, 128, 10, 32, 32, 2), (5, 558, 256, 16, 0, 0, 0), (7, 30, 48, 10, 32, 0, 2),
     (3, 33, 128, 10, 0, 32, 0), (2, 1, 32, 4, 6, 6, 1), (4, 150, 136, 10, 32, 32, 2),
     (3, 70, 140, 10, 32, 32, 2), (6, 200, 50, 7, 5, 5, 3), (2, 9, 3, 256, 0, 0, 0)],
)
def test_kernel_matches_plain_version(cuda, b, n, h, lat, tg, tl, c):
    args, dims = _random_layer_args(b, n, h, lat, tg, tl, c, seed=b + n + h, device=cuda)
    before = ops.epic_layer.launches
    xo, go = ops.epic_layer(*args, **dims)
    torch.cuda.synchronize()
    assert ops.epic_layer.launches == before + 1
    rx, rg = ops.epic_layer_reference(*args, **dims)
    assert torch.isfinite(xo).all()  # padded rows included
    torch.testing.assert_close(xo, rx, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(go, rg, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_kernel_wrapper_refuses_bad_inputs(cuda):
    args, dims = _random_layer_args(2, 8, 32, 4, 0, 0, 0, seed=0, device=cuda)
    bad_dtype = [args[0].double()] + args[1:]
    with pytest.raises(TypeError):
        ops.epic_layer(*bad_dtype, **dims)
    bad_layout = [args[0].transpose(1, 2).contiguous().transpose(1, 2)] + args[1:]
    with pytest.raises(ValueError, match="contiguous"):
        ops.epic_layer(*bad_layout, **dims)
    bad_shape = args[:4] + [args[4][1:]] + args[5:]
    with pytest.raises(ValueError, match="shape"):
        ops.epic_layer(*bad_shape, **dims)
    wide, dims = _random_layer_args(1, 4, 264, 4, 0, 0, 0, seed=0, device=cuda)
    with pytest.raises(ValueError, match="hidden width"):
        ops.epic_layer(*wide, **dims)


@pytest.mark.cuda
def test_kernel_empty_set_gives_nan_as_plain_version(cuda):
    args, dims = _random_layer_args(3, 20, 128, 10, 32, 32, 2, seed=1, device=cuda)
    args[2][1] = 0.0  # set 1 has no real particle: 0/0 in its mean
    xo, go = ops.epic_layer(*args, **dims)
    rx, rg = ops.epic_layer_reference(*args, **dims)
    torch.testing.assert_close(xo, rx, atol=1e-4, rtol=1e-4, equal_nan=True)
    torch.testing.assert_close(go, rg, atol=1e-4, rtol=1e-4, equal_nan=True)
    assert torch.isnan(xo[1]).all() and torch.isfinite(xo[[0, 2]]).all()
