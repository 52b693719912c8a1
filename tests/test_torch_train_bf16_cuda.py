"""PyTorch port, training in bfloat16 on the card (cuda-marked: skips
without a GPU). The file imports no JAX, so that the card's machine runs it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_train_bf16_cuda.py

- The bfloat16 packed kernel under autograd (`_PackedAttention`), with and
  without a bias: the forward within 2 bf16 ulps of its plain version, the
  float32 leaves' gradients equal bit for bit to those with the kernel
  replaced by its plain version (the backward recomputes `packed_ref_math`
  from the same inputs either way), one launch.
- A bfloat16 train step of a narrow path A (the full transformer,
  attn_impl=packed, 3 layers): exactly 3 `packed_short_attention_bf16`
  launches and no float32 `packed_short_attention` launch; the loss and
  every gradient float32 and finite; the loss and gradients with the kernel
  against the wrapper's kernel replaced by its plain version, closer than
  the plain bfloat16 step is to the plain float32 one (Frobenius norms).
"""

from __future__ import annotations

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel
from particle_fm_tpu_torch.ops import short_attention as sa
from particle_fm_tpu_torch.training import step as pstep
# sibling modules (pytest puts tests/ on the path; the card's run takes no conftest)
from test_torch_port_bf16_kernels import assert_within
from test_torch_train_cuda import TRANSFORMER, _batch, _loss_and_grads, _redrawn


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True])
def test_packed_bf16_kernel_under_autograd(cuda, bias):
    gen = torch.Generator().manual_seed(5)
    b, l, h, d = 8, 150, 16, 16
    leaves = [torch.randn(b, l, h, d, generator=gen).to(cuda).requires_grad_(True)
              for _ in range(3)]
    if bias:
        leaves.append(torch.randn(b, h, l, l, generator=gen).to(cuda).requires_grad_(True))
    mask = (torch.arange(l)[None, :] < torch.randint(30, l + 1, (b, 1), generator=gen)).float()
    mask = mask.to(cuda)
    c = torch.randn(b, l, h, d, generator=gen).to(cuda)

    def run():
        for leaf in leaves:
            leaf.grad = None
        out = sa.packed_short_attention(*(a.bfloat16() for a in leaves[:3]), mask,
                                        leaves[3] if bias else None)
        (out.float() * c).sum().backward()
        return out.detach(), [leaf.grad.clone() for leaf in leaves]

    sa.packed_short_attention_bf16.launches = 0
    out, grads = run()
    assert sa.packed_short_attention_bf16.launches == 1
    with mock.patch.object(sa, "packed_short_attention_bf16", sa.packed_short_attention_reference):
        plain, plain_grads = run()
    assert sa.packed_short_attention_bf16.launches == 1
    assert_within(out, plain)
    for g, p in zip(grads, plain_grads):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        assert torch.equal(g, p)


def _frob(a, b):
    return float(np.sqrt(sum(float(((x.double() - y.double()) ** 2).sum())
                             for x, y in zip(a, b))))


@pytest.mark.cuda
def test_path_a_bf16_step_launches_three_packed_kernels(cuda):
    cfg = dict(TRANSFORMER)
    cfg["net_config"] = dict(cfg["net_config"], te_config=dict(cfg["net_config"]["te_config"],
                                                               num_layers=3))
    model32 = FlowMatchingModel(**cfg)
    model = dataclasses.replace(model32, dtype="bfloat16")
    net = _redrawn(model.init(seed=2, device=cuda))
    batch = [a.to(cuda) for a in _batch()]
    for w in (sa.packed_short_attention, sa.packed_short_attention_bf16):
        w.launches = 0
    kernel = _loss_and_grads(model, net, batch)
    assert (sa.packed_short_attention_bf16.launches, sa.packed_short_attention.launches) == (3, 0)
    assert np.isfinite(kernel[0]) and all(g.dtype == torch.float32 for g in kernel[1])
    with mock.patch.object(sa, "packed_short_attention_bf16", sa.packed_short_attention_reference):
        plain = _loss_and_grads(model, net, batch)
    net32 = model32.init(seed=2, device=cuda)
    net32.load_state_dict(net.state_dict())
    with mock.patch.object(sa, "packed_short_attention", sa.packed_short_attention_reference):
        plain32 = _loss_and_grads(model32, net32, batch)
    assert abs(kernel[0] - plain[0]) < abs(plain[0] - plain32[0])
    assert _frob(kernel[1], plain[1]) < _frob(plain[1], plain32[1])

    state = pstep.create_train_state(model, pstep.make_optimizer(), seed=2, device=cuda)
    sa.packed_short_attention_bf16.launches = 0
    loss = pstep.make_train_step(model, pstep.make_optimizer())(
        state, torch.Generator(cuda).manual_seed(0), *batch)
    assert torch.isfinite(loss) and state.step == 1
    assert sa.packed_short_attention_bf16.launches == 3
    assert all(p.dtype == torch.float32 for p in state.params())
