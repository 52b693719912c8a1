"""PyTorch port, the kernels on this slice's new paths, on the card:

- the packed self-attention kernel at the MoE transformer's shape
  (configs/experiment/jetnet/fm_moe_transformer.yaml: 30 particles, 2 heads
  of 64, one QKV projection), float32 within 1e-4 and bfloat16 within 2
  bfloat16 ulps of the largest |output| of its plain version, one launch of
  the type's kernel a call;
- the LHCO chain's stage 2 (lhco/x_jet at its shipped width: EPiC, 279
  particles, hidden 128, 6 layers, cond 4 on both paths; seeded weights) on
  the EPiC kernel against the plain layer within 1e-3, with exactly 6
  launches an evaluation.

Every test needs an NVIDIA GPU and skips without one. This file imports no
JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_moe_chain_cuda.py
"""

from __future__ import annotations

from unittest import mock

import numpy as np
import pytest
import torch

from particle_fm_tpu_torch.ops import epic_layer as ops
from particle_fm_tpu_torch.ops import short_attention as sa

BF16 = torch.bfloat16


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,masked", [(1024, False), (1024, True), (3, True)])
def test_packed_kernel_at_the_moe_transformer_shape(cuda, dtype, b, masked):
    l, h, d = 30, 2, 64
    gen = torch.Generator().manual_seed(b + masked)
    qkv = torch.randn(b, l, 3 * h * d, generator=gen).to(cuda, dtype)
    q, k, v = (x.view(b, l, h, d) for x in qkv.chunk(3, dim=-1))
    mask = None
    if masked:
        counts = torch.randint(1, l + 1, (b, 1), generator=gen)
        mask = (torch.arange(l)[None, :] < counts).float().to(cuda)
    counter = sa.packed_short_attention if dtype == torch.float32 else \
        sa.packed_short_attention_bf16
    before = counter.launches
    out = sa.packed_short_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert counter.launches == before + 1 and out.dtype == dtype and out.shape == q.shape
    want = sa.packed_short_attention_reference(q, k, v, mask)
    err = float((out.float() - want.float()).abs().max())
    if dtype == torch.float32:
        assert err <= 1e-4 + 1e-4 * float(want.abs().max()), err
    else:  # two bfloat16 ulps of the largest |output|
        assert err <= 2 * 2.0 ** (np.floor(np.log2(float(want.float().abs().max()))) - 7), err


@pytest.mark.cuda
def test_lhco_stage2_on_the_kernel_matches_the_plain_layer(cuda):
    from particle_fm_tpu_torch import lhco_chain
    from particle_fm_tpu_torch.config.core import compose, instantiate
    from particle_fm_tpu_torch.data.lhco import LHCOJetFeatureDataModule
    from particle_fm_tpu_torch.train import CONFIG_DIR

    cfg = compose(CONFIG_DIR, "train", ["experiment=lhco/x_jet", "data.synthetic=true"])
    model = instantiate({k: v for k, v in cfg["model"].items()
                         if k not in ("optimizer", "scheduler")})
    dm = instantiate(cfg["data"])
    dm.setup()
    assert (model.num_particles, model.hidden_dim, model.layers, model.global_cond_dim) == (
        279, 128, 6, 4)
    stage = lhco_chain.Stage(model, model.init(seed=0, device=cuda), dm)
    feats = LHCOJetFeatureDataModule(synthetic=True)
    feats.setup()
    sr = feats.tensor_test_sr  # the signal region's physical dijet features, tiled to 512
    jets2 = np.tile(sr, (-(-512 // len(sr)), 1))[:512].reshape(512, 2, 5)
    steps = 6

    def run():
        return lhco_chain.sample_constituents(stage, jets2, 0, batch_size=256, ode_steps=steps)

    before = ops.epic_layer.launches
    consts, mask, _ = run()
    assert ops.epic_layer.launches - before == 6 * 2 * (steps - 1) * 2
    with mock.patch.object(ops, "epic_layer", ops.epic_layer_reference):
        plain, plain_mask, _ = run()
    np.testing.assert_array_equal(mask, plain_mask)
    assert np.isfinite(consts).all() and (consts[mask[..., 0] == 0] == 0).all()
    assert np.abs(consts - plain).max() <= 1e-3, np.abs(consts - plain).max()
