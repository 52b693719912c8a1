"""PyTorch port, the EPiC discriminator's predictions on the card: the fused
EPiC layer with a 0-wide per-set feature (no time, no cond: S = 0), float32
and bfloat16, against its plain version at the classifiers' shapes (the
LHCO classifier's 279 particles, JetClass's 128, EPiCDiscriminator3's jet
trunk of 2 sets without a mask), and exactly one launch per EPiC layer per
predicted batch, of `epic_layer` in float32 and of `epic_layer_bf16` (none
of `epic_layer`) in bfloat16, the predictions within 1e-4 of the module
path's (float32). Every test needs an NVIDIA GPU and skips without one.

This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_classifiers_cuda.py
"""

from __future__ import annotations

import copy

import pytest
import torch

from particle_fm_tpu_torch.models.classifiers import SetClassifierModel
from particle_fm_tpu_torch.nets.epic import EPiCDiscriminator3
from particle_fm_tpu_torch.ops import epic_layer as ops


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def no_set_feature_args(b, n, h, lat, seed, device, masked=True):
    """One layer's inputs with S = 0: set_feat (B, 0), w1s (L, H), w2s (0, H)."""
    gen = torch.Generator().manual_seed(seed)
    w = lambda *s: torch.randn(*s, generator=gen) / s[0] ** 0.5
    counts = torch.randint(1, n + 1, (b, 1), generator=gen) if masked else torch.full((b, 1), n)
    mask = (torch.arange(n)[None, :] < counts).float()
    args = [torch.randn(b, n, h, generator=gen) * mask[..., None],
            torch.randn(b, lat, generator=gen), mask, torch.zeros(b, 0),
            w(2 * h + lat, h), torch.randn(h, generator=gen) * 0.1,
            w(h, lat), torch.randn(lat, generator=gen) * 0.1,
            w(h, h), w(lat, h), torch.randn(h, generator=gen) * 0.1,
            w(h, h), torch.zeros(0, h), torch.randn(h, generator=gen) * 0.1]
    return [a.to(device).contiguous() for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,h,lat,masked", [(256, 279, 128, 10, True), (512, 128, 128, 10, True),
                                              (8, 2, 128, 10, False), (3, 17, 48, 4, True)])
def test_the_kernel_takes_a_zero_wide_set_feature(cuda, b, n, h, lat, masked):
    args = no_set_feature_args(b, n, h, lat, 0, cuda, masked)
    xo, go = ops.epic_layer(*args)
    rx, rg = ops.epic_layer_reference(*args)
    torch.testing.assert_close(xo, rx, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(go, rg, atol=1e-4, rtol=1e-4)
    bf = [a.to(torch.bfloat16) if i != 2 else a for i, a in enumerate(args)]
    xo, go = ops.epic_layer(*bf)
    rx, rg = ops.epic_layer_reference(*bf)
    for got, want in ((xo, rx), (go, rg)):
        ulp = 2.0 ** -7 * want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= 2 * ulp


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_predictions_launch_the_kernel_once_per_layer_and_batch(cuda, dtype):
    model = SetClassifierModel(arch="epic", n_classes=1, num_particles=279, features=3,
                               net_config=dict(hid_dim=128, latent_dim=10, equiv_layers=3),
                               dtype=dtype)
    net = model.init(seed=0, device=cuda)
    gen = torch.Generator().manual_seed(1)
    counts = torch.randint(5, 280, (64, 1), generator=gen)
    mask = (torch.arange(279)[None, :] < counts).float()[..., None].to(cuda)
    x = torch.randn(64, 279, 3, generator=gen).to(cuda) * mask
    ops.epic_layer.launches = ops.epic_layer_bf16.launches = 0
    probs = model.predict(model.inference_network(copy.deepcopy(net)), x, mask)
    counted = ops.epic_layer_bf16 if dtype else ops.epic_layer
    assert counted.launches == 3
    assert (ops.epic_layer.launches if dtype else ops.epic_layer_bf16.launches) == 0
    plain = model.predict(net, x, mask)
    tol = 1e-4 if dtype is None else 2e-2
    torch.testing.assert_close(probs.float(), plain.float(), atol=tol, rtol=0)


@pytest.mark.cuda
def test_the_two_level_discriminator_runs_its_jet_trunk_on_the_kernel(cuda):
    from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel

    net = EPiCDiscriminator3(3, hid_dim=128, latent_dim=10, equiv_layers=3, num_sup_sets=2,
                             generator=torch.Generator().manual_seed(0)).to(cuda).eval()
    x = torch.randn(32, 40, 3, device=cuda)
    with torch.no_grad():
        plain = net(x)
        FlowMatchingModel.fold_weight_norm(net)
        ops.epic_layer.launches = 0
        kernel = net(x)
    assert ops.epic_layer.launches == 6  # 3 in the particle trunk, 3 in the jet trunk (N = 2)
    torch.testing.assert_close(kernel, plain, atol=1e-4, rtol=1e-4)
