"""PyTorch port, the packed attention kernel's autograd Function
(`ops/short_attention.py::_PackedAttention`) in bfloat16 against the JAX
package's `packed_short_attention(..., interpret=True)` under `jax.grad`:
the Pallas kernel in interpret mode forward, its custom VJP (`_ref_math`
recomputed in the input type) backward. On the CPU the port's forward is the
plain version of the bfloat16 kernel (`_packed_lowp`), its backward
`packed_ref_math`, the counterpart of `_ref_math`, in the input type.

With and without a bias, the gradients of q, k, v (and the bias) of
sum(out * c) are held by the bf16 gate |port_bf16 - jax_bf16| <
|jax_bf16 - jax_f32| (Frobenius norms), and so is the output. Run op by op
(`jax.disable_jit`). `packed_ref_math` itself equals JAX's `_ref_math` bit
for bit in bfloat16 and within 1e-6 in float32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.ops.pallas import short_attention as jshort
from particle_fm_tpu_torch.ops import short_attention as pshort
from tests.torch_port_helpers import bf16_gaps


def _inputs(b=3, l=12, h=4, d=8, seed=0, bias=False):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(b, l, h, d).astype(np.float32) for _ in range(3))
    n_valid = rs.randint(2, l + 1, b)
    n_valid[0] = l
    mask = (np.arange(l)[None, :] < n_valid[:, None]).astype(np.float32)
    ab = rs.randn(b, h, l, l).astype(np.float32) if bias else None
    c = rs.randn(b, l, h, d).astype(np.float32)
    return q, k, v, mask, ab, c


def _jax_grads(q, k, v, mask, ab, c, dtype):
    def f(*args):
        qq, kk, vv = (a.astype(dtype) for a in args[:3])
        out = jshort.packed_short_attention(qq, kk, vv, jnp.asarray(mask),
                                            None if ab is None else args[3], interpret=True)
        return jnp.sum(out.astype(jnp.float32) * c), out
    args = [jnp.asarray(a) for a in (q, k, v)] + ([] if ab is None else [jnp.asarray(ab)])
    with jax.disable_jit():
        (_, out), grads = jax.value_and_grad(f, argnums=tuple(range(len(args))),
                                             has_aux=True)(*args)
    return np.asarray(out.astype(jnp.float32)), [np.asarray(g, np.float32) for g in grads]


@pytest.mark.parametrize("bias", [False, True])
def test_packed_bf16_gradients_closer_to_jax_bf16_than_jax_is_to_f32(bias):
    q, k, v, mask, ab, c = _inputs(seed=3 if bias else 2, bias=bias)
    out32, g32 = _jax_grads(q, k, v, mask, ab, c, jnp.float32)
    out16, g16 = _jax_grads(q, k, v, mask, ab, c, jnp.bfloat16)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    if bias:
        leaves.append(torch.tensor(ab, requires_grad=True))
    out = pshort.packed_short_attention(*(a.bfloat16() for a in leaves[:3]), torch.tensor(mask),
                                        leaves[3] if bias else None)
    assert out.dtype == torch.bfloat16 and out.grad_fn.name().endswith("_PackedAttentionBackward")
    (out.float() * torch.tensor(c)).sum().backward()
    ours, theirs = bf16_gaps(out.float().detach().numpy(), out16, out32, "output")
    assert ours < theirs
    for name, leaf, a16, a32 in zip("qkvb", leaves, g16, g32):
        assert leaf.grad.dtype == torch.float32
        ours, theirs = bf16_gaps(leaf.grad.numpy(), a16, a32, f"d{name}")
        assert ours < theirs, name
    assert pshort.packed_short_attention_bf16.launches == 0  # no kernel on the CPU


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_packed_ref_math_is_jax_ref_math(dtype):
    q, k, v, mask, ab, _ = _inputs(seed=4, bias=True)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    madd = (jnp.asarray(mask) - 1.0) * (-jshort.NEG)
    ref = jshort._ref_math(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)), madd,
                           jnp.asarray(ab))
    out = pshort.packed_ref_math(*(torch.tensor(a).to(tdt) for a in (q, k, v)),
                                 torch.tensor(mask), torch.tensor(ab))
    assert out.dtype == tdt
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(out.float().numpy(), ref)
    else:
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


def test_fused_and_flash_stay_forward_only_in_bf16():
    q = torch.randn(2, 5, 2, 8, requires_grad=True)
    with pytest.raises(NotImplementedError, match="forward only"):
        pshort.fused_short_attention(q.bfloat16(), q.bfloat16(), q.bfloat16())
    from particle_fm_tpu_torch.ops import flash_attention as pflash
    with pytest.raises(NotImplementedError, match="forward only"):
        pflash.flash_masked_attention(q.bfloat16(), q.bfloat16(), q.bfloat16())
