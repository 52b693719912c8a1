"""PyTorch port, attention: `ops/attention.py` held against the JAX package's
`ops/attention.py`, and the plain versions of the two short-set attention
kernels (`ops/short_attention.py`) held against the JAX package's Pallas
kernels run in interpret mode, on the same seeded numpy inputs.

Tolerances: float32 attention against JAX atol 1e-5; the bf16-scores variant
atol 2e-2 (bf16 rounds at other places in the two frameworks); the plain
versions against the Pallas kernels atol 2e-5, the tolerance of the JAX
package's own kernel tests; the packed attention's gradients atol 1e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.ops import attention as jattn
from particle_fm_tpu.ops.pallas import short_attention as jshort
from particle_fm_tpu_torch.ops import attention as pattn
from particle_fm_tpu_torch.ops import flash_attention as pflash
from particle_fm_tpu_torch.ops import short_attention as pshort
from tests.torch_port_helpers import t


def _inputs(b=3, lq=10, lk=10, h=4, d=16, seed=0, masked=True, bias=False):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, lq, h, d).astype(np.float32)
    k = rs.randn(b, lk, h, d).astype(np.float32)
    v = rs.randn(b, lk, h, d).astype(np.float32)
    mask = None
    if masked:
        n_valid = rs.randint(2, lk + 1, b)
        mask = (np.arange(lk)[None, :] < n_valid[:, None]).astype(np.float32)
    ab = rs.randn(b, h, lq, lk).astype(np.float32) if bias else None
    return q, k, v, mask, ab


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _p(*arrays):
    return [None if a is None else t(a) for a in arrays]


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("lq,lk", [(10, 10), (5, 13)])
def test_masked_attention_matches_jax(masked, bias, lq, lk):
    args = _inputs(lq=lq, lk=lk, masked=masked, bias=bias, seed=lq + lk)
    ref = np.asarray(jattn.masked_attention(*_j(*args)))
    out = pattn.masked_attention(*_p(*args)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("bias", [True, False])
def test_masked_attention_bf16_scores_matches_jax(bias):
    args = _inputs(lq=12, lk=12, bias=bias, seed=3)
    ref = np.asarray(jattn.masked_attention(*_j(*args), scores_dtype=jnp.bfloat16))
    out = pattn.masked_attention(*_p(*args), scores_dtype=torch.bfloat16)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-2)
    # the variant is an approximation of the float32 path, not a copy of it
    exact = pattn.masked_attention(*_p(*args)).numpy()
    assert 0 < np.abs(out.numpy() - exact).max() < 2e-2


@pytest.mark.parametrize("masked", [True, False])
def test_class_token_attention_matches_jax(masked):
    q, k, v, mask, _ = _inputs(lq=1, lk=9, masked=masked, seed=4)
    ref = np.asarray(jattn.class_token_attention(*_j(q, k, v, mask)))
    out = pattn.class_token_attention(*_p(q, k, v, mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    via = pattn.attention(*_p(q, k, v, mask), impl="class_token").numpy()
    np.testing.assert_array_equal(via, out)


def test_dispatcher_rules(monkeypatch):
    q, k, v, mask, _ = _p(*_inputs(seed=5))
    einsum = pattn.masked_attention(q, k, v, mask)
    for impl in ("auto", "einsum", "packed", "anything else"):  # unknown names take the einsum path, as in JAX
        torch.testing.assert_close(pattn.attention(q, k, v, mask, impl=impl), einsum, rtol=0, atol=0)
    with pytest.raises(ValueError, match="scores_dtype"):
        pattn.attention(q[:, :1], k, v, mask, impl="class_token", scores_dtype=torch.bfloat16)
    # "flash" goes to its wrapper, which on CPU tensors is its plain version
    torch.testing.assert_close(pattn.attention(q, k, v, mask, impl="flash"),
                               pflash.flash_masked_attention_reference(q, k, v, mask), rtol=0, atol=0)
    torch.testing.assert_close(pattn.attention(q, k, v, mask, impl="flash"), einsum, rtol=0, atol=2e-5)
    # on the CPU "packed" takes the einsum path (scores_dtype and all), as the
    # JAX dispatcher does without an accelerator; "fused" goes to its wrapper
    calls = []
    monkeypatch.setattr(pshort, "packed_short_attention", lambda *a: calls.append("packed"))
    monkeypatch.setattr(pshort, "fused_short_attention", lambda *a: calls.append("fused"))
    bf16 = pattn.attention(q, k, v, mask, impl="packed", scores_dtype=torch.bfloat16)
    torch.testing.assert_close(bf16, pattn.masked_attention(q, k, v, mask, scores_dtype=torch.bfloat16))
    pattn.attention(q, k[:, :5], v[:, :5], mask[:, :5], impl="packed")
    assert calls == []
    pattn.attention(q, k[:, :5], v[:, :5], mask[:, :5], impl="fused")
    assert calls == ["fused"]


def test_dispatcher_on_the_card_picks_kernels_by_shape(monkeypatch):
    """What the dispatcher does with a CUDA tensor, shown on CPU tensors whose
    device type is faked: packed for self-attention shapes up to 256, einsum
    beyond, and the flash kernel, not a quiet einsum, for long sets at head
    dim 128."""
    calls = []
    monkeypatch.setattr(pshort, "packed_short_attention", lambda *a: calls.append("packed"))
    monkeypatch.setattr(pflash, "flash_masked_attention", lambda *a: calls.append("flash"))

    class OnCard(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    def card(a):
        return a.as_subclass(OnCard)

    q, k, v, mask, _ = _p(*_inputs(seed=6))
    pattn.attention(card(q), k, v, mask, impl="packed")
    assert calls == ["packed"]
    pattn.attention(card(q), k[:, :5], v[:, :5], mask[:, :5], impl="packed")
    long = torch.zeros(1, 300, 1, 8)
    pattn.attention(card(long), long, long, impl="packed")
    assert calls == ["packed"]
    big = torch.zeros(1, 1024, 1, 128)
    pattn.attention(card(big), big, big)
    assert calls == ["packed", "flash"]
    assert pattn.attention(big, big, big).shape == big.shape  # on the CPU, auto is einsum
    assert calls == ["packed", "flash"]


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("l,b,h", [(10, 3, 4), (16, 3, 4), (150, 2, 2)])
def test_packed_plain_version_matches_pallas_kernel(masked, l, b, h):
    q, k, v, mask, _ = _inputs(b=b, lq=l, lk=l, h=h, masked=masked, seed=7)
    ref = np.asarray(jshort.packed_short_attention(*_j(q, k, v, mask), interpret=True))
    out = pshort.packed_short_attention_reference(*_p(q, k, v, mask)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=2e-5)
    # on CPU tensors the wrapper is its plain version, and counts no launch
    before = pshort.packed_short_attention.launches
    np.testing.assert_array_equal(pshort.packed_short_attention(*_p(q, k, v, mask)).numpy(), out)
    assert pshort.packed_short_attention.launches == before


def test_packed_plain_version_with_bias_matches_pallas_kernel():
    args = _inputs(seed=8, bias=True)
    ref = np.asarray(jshort.packed_short_attention(*_j(*args), interpret=True))
    out = pshort.packed_short_attention(*_p(*args)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)


@pytest.mark.parametrize(
    "lq,lk,masked,bias",
    [(10, 10, True, False), (10, 10, False, False), (10, 10, True, True), (5, 13, True, False),
     (4, 30, True, False), (30, 4, False, False), (6, 11, True, True)],
)
def test_fused_plain_version_matches_pallas_kernel(lq, lk, masked, bias):
    args = _inputs(lq=lq, lk=lk, masked=masked, bias=bias, seed=lq + lk)
    ref = np.asarray(jshort.fused_short_attention(*_j(*args), interpret=True))
    out = pshort.fused_short_attention_reference(*_p(*args)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=2e-5)
    before = pshort.fused_short_attention.launches
    np.testing.assert_array_equal(pshort.fused_short_attention(*_p(*args)).numpy(), out)
    assert pshort.fused_short_attention.launches == before


@pytest.mark.parametrize("bias", [False, True])
def test_packed_gradients_match_jax(bias):
    q, k, v, mask, ab = _inputs(b=2, lq=12, lk=12, h=2, d=8, seed=11, bias=bias)
    mj = jnp.asarray(mask)

    def loss(q, k, v, ab):
        return jnp.sum(jshort.packed_short_attention(q, k, v, mj, ab, interpret=True) ** 2)

    argnums = (0, 1, 2, 3) if bias else (0, 1, 2)
    ref = jax.grad(loss, argnums=argnums)(*_j(q, k, v, ab))
    leaves = [a.requires_grad_(True) for a in _p(q, k, v, ab) if a is not None]
    out = pshort.packed_short_attention(*leaves[:3], t(mask), leaves[3] if bias else None)
    out.pow(2).sum().backward()
    for leaf, g in zip(leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), atol=1e-4)
    # only what asks for a gradient gets one
    qq = t(q).requires_grad_(True)
    pshort.packed_short_attention(qq, t(k), t(v), t(mask)).sum().backward()
    assert qq.grad is not None


@pytest.mark.parametrize("name", ["packed", "fused"])
def test_fully_masked_set_is_finite_and_uniform(name):
    """-1e9 is added to the scores, so in float32 it rounds them away: a set
    with no real key weighs all its keys alike."""
    q, k, v, mask, _ = _inputs(b=3, lq=8, lk=8, seed=12)
    mask[1] = 0.0
    out = getattr(pshort, f"{name}_short_attention")(*_p(q, k, v, mask)).numpy()
    assert np.isfinite(out).all()
    uniform = np.broadcast_to(v[1].mean(axis=0, keepdims=True), out[1].shape)
    np.testing.assert_allclose(out[1], uniform, atol=1e-6)
    kernel = getattr(jshort, f"{name}_short_attention")
    # the packed TPU kernel pads 8 keys to 16 and then spreads such a row over
    # its padded keys too; the port follows the einsum form. The fused TPU
    # kernel pads to 8, so at 8 keys it is comparable
    if name == "fused":
        ref = np.asarray(kernel(*_j(q, k, v, mask), interpret=True))
        np.testing.assert_allclose(out, ref, atol=2e-5)


def test_wrappers_check_their_arguments():
    q, k, v, mask, _ = _p(*_inputs(seed=13))
    with pytest.raises(ValueError, match="Lq == Lk"):
        pshort.packed_short_attention(q, k[:, :5], v[:, :5])
    with pytest.raises(NotImplementedError, match="forward only"):
        pshort.fused_short_attention(q.clone().requires_grad_(True), k, v, mask)
    with torch.no_grad():  # serving runs so
        assert pshort.fused_short_attention(q.clone().requires_grad_(True), k, v, mask).shape == q.shape
    meta = torch.zeros(2, 4, 2, 8, device="meta")
    for fn in (pshort.packed_short_attention, pshort.fused_short_attention):
        with pytest.raises(ValueError, match="cuda or cpu"):
            fn(meta, meta, meta)
    assert (pshort.MAX_PACKED_LEN, pshort.MAX_FUSED_LEN, pshort.NEG) == (
        jshort.MAX_PACKED_LEN, jshort.MAX_FUSED_LEN, jshort.NEG)
    assert pattn.NEG_INF == jattn.NEG_INF
