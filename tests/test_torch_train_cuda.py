"""PyTorch port, training on the card (cuda-marked: skips without a GPU).
The file imports no JAX, so that the card's machine runs it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_train_cuda.py

- One EPiC training loss and its gradients on the card against the CPU, from
  the same weights and pinned draws of t and the noise: loss rtol 1e-5,
  gradients atol 1e-5 of the largest gradient (TF32 off).
- The transformer with attn_impl=packed: the loss and gradients with the
  packed kernel in the forward pass against the wrapper replaced by its
  plain version, within the same tolerances, and one packed launch per layer
  per step; then a train step on the card.
"""

from __future__ import annotations

from unittest import mock

import numpy as np
import pytest
import torch

from particle_fm_tpu_torch.losses import flow_matching as ploss
from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel
from particle_fm_tpu_torch.ops import short_attention as sa
from particle_fm_tpu_torch.training import step as pstep

SMALL = dict(features=3, num_particles=16, frequencies=16, t_emb="cosine", global_cond_dim=2)
EPIC = dict(SMALL, hidden_dim=32, latent=8, layers=2, t_global_cat=True, t_local_cat=True,
            add_time_to_input=False, local_cond_dim=2)
_EMBD = dict(act_h="lrlu", nrm="layer")
TRANSFORMER = dict(SMALL, model="droid_fulltransformer", add_time_to_input=True, net_config=dict(
    node_embd_config=_EMBD, ctxt_embd_config=dict(_EMBD, outp_dim=12),
    outp_embd_config=dict(_EMBD, output_init_zeros=True),
    te_config=dict(model_dim=64, num_layers=2, dense_config=dict(_EMBD, output_init_zeros=True),
                   mha_config=dict(num_heads=4, init_zeros=True, do_layer_norm=True,
                                   attn_impl="packed"))))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _batch(b=8, n=16, seed=0):
    rs = np.random.RandomState(seed)
    mask = (np.arange(n)[None, :] < rs.randint(3, n + 1, (b, 1))).astype(np.float32)[..., None]
    x = rs.randn(b, n, 3).astype(np.float32) * mask
    return [torch.from_numpy(a) for a in (x, mask, rs.randn(b, 2).astype(np.float32))]


def _loss_and_grads(model, net, batch, seed=1):
    rs = np.random.RandomState(seed)
    dev = batch[0].device
    tt = torch.from_numpy(rs.rand(batch[0].shape[0]).astype(np.float32)).to(dev)
    z = torch.from_numpy(rs.randn(*batch[0].shape).astype(np.float32)).to(dev)
    with mock.patch.multiple(ploss, _sample_t=lambda g, b, d: tt, _normal=lambda g, s, d: z):
        loss = model.loss(net, torch.Generator(dev), *batch, train=True)
        grads = torch.autograd.grad(loss, list(net.parameters()))
    return float(loss.detach()), [g.cpu() for g in grads]


def _assert_close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    scale = max(g.abs().max().item() for g in want[1])
    for a, b in zip(got[1], want[1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale)


def _redrawn(net, seed=3):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            draw = torch.randn(p.shape, generator=gen).to(p.device)
            p.copy_(draw / p.shape[-1] ** 0.5 if p.ndim >= 2 else p + 0.1 * draw)
    return net


@pytest.mark.cuda
def test_epic_loss_on_the_card_matches_the_cpu(cuda):
    model = FlowMatchingModel(**EPIC)
    net = model.init(seed=2, device=cuda)
    batch = _batch()
    card = _loss_and_grads(model, net, [a.to(cuda) for a in batch])
    _assert_close(card, _loss_and_grads(model, model.init(seed=2, device="cpu"), batch))


@pytest.mark.cuda
def test_packed_training_matches_the_plain_attention(cuda):
    model = FlowMatchingModel(**TRANSFORMER)
    net = _redrawn(model.init(seed=2, device=cuda))
    batch = [a.to(cuda) for a in _batch()]
    sa.packed_short_attention.launches = 0
    kernel = _loss_and_grads(model, net, batch)
    assert sa.packed_short_attention.launches == 2
    with mock.patch.object(sa, "packed_short_attention", sa.packed_short_attention_reference):
        _assert_close(kernel, _loss_and_grads(model, net, batch))
    state = pstep.create_train_state(model, pstep.make_optimizer(), seed=2, device=cuda)
    step = pstep.make_train_step(model, pstep.make_optimizer())
    loss = step(state, torch.Generator(cuda).manual_seed(0), *batch)
    assert torch.isfinite(loss) and state.step == 1
