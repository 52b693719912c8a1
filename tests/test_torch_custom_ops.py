"""PyTorch port, the kernels' custom ops (`torch.library`, namespace
`particle_fm`, ops/epic_layer.py, ops/short_attention.py,
ops/flash_attention.py) on the CPU:

- each op's CPU implementation is the plain version, bit for bit
  (`torch.equal`), at small shapes in float32 and bfloat16;
- each fake implementation gives the output's shape, dtype and device under
  `FakeTensorMode`, without reading data;
- `torch.library.opcheck` passes for each op's CPU implementation;
- the public wrappers call the ops on CPU tensors: a traced function holds
  the op nodes;
- the packed op's gradients (its autograd Function around the op) equal
  autograd through `packed_ref_math` bit for bit; the fused and flash
  wrappers still raise under grad.

The CUDA implementations are held in tests/test_torch_export_cuda.py and by
chip_smoke.py (`opcheck` on the card).
"""

from __future__ import annotations

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from particle_fm_tpu_torch.ops import epic_layer as el
from particle_fm_tpu_torch.ops import flash_attention as fa
from particle_fm_tpu_torch.ops import short_attention as sa

BF16 = torch.bfloat16
OPS = torch.ops.particle_fm


def _epic_args(dtype, seed=0, b=3, n=7, h=16, lat=4, t=4, c=2):
    gen = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dtype)

    mask = (torch.arange(n)[None, :] < torch.tensor([[n], [3], [5]])).float()
    args = [r(b, n, h), r(b, lat), mask, r(b, t + c), r(t + 2 * h + lat + c, h, scale=0.2), r(h),
            r(t + h + c, lat, scale=0.2), r(lat), r(h, h, scale=0.2), r(t + lat + c, h, scale=0.2),
            r(h), r(h, h, scale=0.2), r(t + c, h, scale=0.2), r(h)]
    return args, (0.01, t, t, c, c)


def _attention_args(dtype, seed=0, b=3, lq=6, lk=6, h=2, d=8):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, l_, h, d, generator=gen).to(dtype) for l_ in (lq, lk, lk))
    mask = (torch.arange(lk)[None, :] < torch.tensor([[lk], [2], [4]])).float()
    bias = torch.randn(b, h, lq, lk, generator=gen)
    return q, k, v, mask, bias


def _epic_case(dtype):
    args, dims = _epic_args(dtype)
    if dtype == BF16:
        image = el.bf16_weight_image(args[4], args[6], args[9], args[12], args[8], args[11])
        return OPS.epic_layer_bf16, (*args, *dims, image)
    return OPS.epic_layer, (*args, *dims)


def _cases():
    """(name, op, args, the plain version's result)."""
    out = []
    for dtype in (torch.float32, BF16):
        suffix = "_bf16" if dtype == BF16 else ""
        op, args = _epic_case(dtype)
        ref = el.epic_layer_reference(*args[:14], sum_scale=args[14], tg_dim=args[15],
                                      tl_dim=args[16], cg_dim=args[17], cl_dim=args[18])
        out.append(("epic_layer" + suffix, op, args, ref))
        q, k, v, mask, bias = _attention_args(dtype)
        b = bias if dtype == torch.float32 else None
        out.append(("packed_short_attention" + suffix,
                    getattr(OPS, "packed_short_attention" + suffix), (q, k, v, mask, b),
                    sa.packed_short_attention_reference(q, k, v, mask, b)))
        qf, kf, vf, maskf, biasf = _attention_args(dtype, lq=4, lk=9)
        bf = biasf if dtype == torch.float32 else None
        out.append(("fused_short_attention" + suffix,
                    getattr(OPS, "fused_short_attention" + suffix), (qf, kf, vf, maskf, bf),
                    sa.fused_short_attention_reference(qf, kf, vf, maskf, bf)))
        out.append(("flash_masked_attention" + suffix,
                    getattr(OPS, "flash_masked_attention" + suffix), (q, k, v, mask),
                    fa.flash_masked_attention_reference(q, k, v, mask)))
    return out


CASES = _cases()
IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("name,op,args,ref", CASES, ids=IDS)
def test_cpu_implementation_is_the_plain_version(name, op, args, ref):
    got = op(*args)
    for g, r in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple)
                    else (ref,)):
        assert g.dtype == r.dtype and torch.equal(g, r), name
        assert g.is_contiguous()


@pytest.mark.parametrize("name,op,args,ref", CASES, ids=IDS)
def test_fake_implementation_gives_shape_and_dtype(name, op, args, ref):
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        got = op(*fake)
    for g, r in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple)
                    else (ref,)):
        assert (tuple(g.shape), g.dtype, g.device.type) == (tuple(r.shape), r.dtype, "cpu"), name


@pytest.mark.parametrize("name,op,args,ref", CASES, ids=IDS)
def test_opcheck(name, op, args, ref):
    torch.library.opcheck(op, args)


def _traced_targets(fn, *args) -> set[str]:
    class Wrap(torch.nn.Module):
        def forward(self, *a):
            return fn(*a)

    with torch.no_grad():
        ep = torch.export.export(Wrap(), tuple(args))
    return {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_wrappers_call_the_ops_on_the_cpu(dtype):
    suffix = "_bf16" if dtype == BF16 else ""
    args, (scale, tg, tl, cg, cl) = _epic_args(dtype)
    assert f"particle_fm.epic_layer{suffix}.default" in _traced_targets(
        lambda *a: el.epic_layer(*a, sum_scale=scale, tg_dim=tg, tl_dim=tl, cg_dim=cg,
                                 cl_dim=cl), *args)
    q, k, v, mask, _ = _attention_args(dtype)
    for wrapper, op in ((sa.packed_short_attention, "packed_short_attention"),
                        (sa.fused_short_attention, "fused_short_attention"),
                        (fa.flash_masked_attention, "flash_masked_attention")):
        assert f"particle_fm.{op}{suffix}.default" in _traced_targets(wrapper, q, k, v, mask)


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("masked,biased", [(False, False), (True, True)])
def test_packed_gradients_are_packed_ref_math_bit_for_bit(dtype, masked, biased):
    q, k, v, mask, bias = _attention_args(dtype, seed=1)
    mask = mask if masked else None
    bias = bias if biased else None
    grad_out = torch.randn(q.shape, generator=torch.Generator().manual_seed(2)).to(dtype)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref_leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    if bias is not None:
        leaves.append(bias.clone().requires_grad_(True))
        ref_leaves.append(bias.clone().requires_grad_(True))
    out = sa.packed_short_attention(*leaves[:3], mask, leaves[3] if biased else None)
    ref = sa.packed_ref_math(*ref_leaves[:3], mask, ref_leaves[3] if biased else None)
    got = torch.autograd.grad(out, leaves, grad_out)
    want = torch.autograd.grad(ref, ref_leaves, grad_out)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("wrapper", [sa.fused_short_attention, fa.flash_masked_attention],
                         ids=["fused", "flash"])
def test_fused_and_flash_raise_under_grad(wrapper):
    q, k, v, mask, _ = _attention_args(torch.float32)
    with pytest.raises(NotImplementedError, match="forward only"):
        wrapper(q.requires_grad_(True), k, v, mask)
