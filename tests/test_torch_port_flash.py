"""PyTorch port, the blockwise flash attention: the plain version of the CUDA
kernel (`ops/flash_attention.py::flash_masked_attention_reference`) held
against the JAX package's Pallas kernel run in interpret mode and against its
einsum attention, on the same seeded numpy inputs, and the dispatcher's rules
for `impl="flash"` and `impl="auto"`.

Tolerance: atol 2e-5, that of the JAX package's own test of the kernel
(tests/test_flash_attention.py); the streaming softmax sums in another order
than the one-pass softmax.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.ops import attention as jattn
from particle_fm_tpu.ops.pallas import flash_attention as jflash
from particle_fm_tpu_torch.ops import attention as pattn
from particle_fm_tpu_torch.ops import flash_attention as pflash
from tests.torch_port_helpers import t

ATOL = 2e-5


def _inputs(b=2, lq=16, lk=24, h=2, d=8, seed=0, masked=True):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, lq, h, d).astype(np.float32)
    k = rs.randn(b, lk, h, d).astype(np.float32)
    v = rs.randn(b, lk, h, d).astype(np.float32)
    mask = None
    if masked:  # at least one real key in every set
        mask = (np.arange(lk)[None, :] < rs.randint(1, lk + 1, (b, 1))).astype(np.float32)
    return q, k, v, mask


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _p(*arrays):
    return [None if a is None else t(a) for a in arrays]


@pytest.mark.parametrize(
    "lq,lk,d,block_k,masked",
    [(16, 24, 8, 8, True), (16, 24, 8, 8, False),   # the JAX package's own cases
     (16, 20, 8, 16, True),                         # Lk not a multiple of the chunk
     (1, 50, 16, 16, True), (1, 50, 16, 16, False),  # a class token
     (5, 37, 32, 8, True), (40, 7, 12, 8, True),    # Lq != Lk, odd head dim
     (3, 1024, 128, 128, True)],                    # the shape `auto` sends here
)
def test_plain_version_matches_pallas_kernel_and_einsum(lq, lk, d, block_k, masked):
    args = _inputs(lq=lq, lk=lk, d=d, seed=lq + lk + d, masked=masked)
    kernel = np.asarray(jflash.flash_masked_attention(*_j(*args), block_k=block_k, interpret=True))
    einsum = np.asarray(jattn.masked_attention(*_j(*args)))
    out = pflash.flash_masked_attention_reference(*_p(*args), block_k=block_k).numpy()
    assert out.shape == kernel.shape == (2, lq, 2, d)
    np.testing.assert_allclose(out, kernel, atol=ATOL)
    np.testing.assert_allclose(out, einsum, atol=ATOL)
    # the chunk size changes the order of the sums, not the function
    np.testing.assert_allclose(pflash.flash_masked_attention_reference(*_p(*args)).numpy(), out,
                               atol=ATOL)


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    args = _p(*_inputs(seed=1))
    before = pflash.flash_masked_attention.launches
    out = pflash.flash_masked_attention(*args)
    torch.testing.assert_close(out, pflash.flash_masked_attention_reference(*args), rtol=0, atol=0)
    assert pflash.flash_masked_attention.launches == before  # no kernel, no launch
    assert out.dtype == torch.float32 and out.shape == args[0].shape
    torch.testing.assert_close(out, pattn.masked_attention(*args), atol=ATOL, rtol=0)


@pytest.mark.parametrize("block_k,padded", [(16, 32), (20, 20)])
def test_fully_masked_set_known_difference(block_k, padded):
    """A set with no real key: -1e9 rounds every score away, so the weights
    are uniform. The port spreads them over the set's Lk keys, as the einsum
    attention does; the TPU kernel pads Lk to its chunk with masked keys and
    spreads them over the padded length too."""
    q, k, v, mask = _inputs(b=3, lq=6, lk=20, seed=2)
    mask[1] = 0.0
    out = pflash.flash_masked_attention(*_p(q, k, v, mask)).numpy()
    assert np.isfinite(out).all()
    uniform = np.broadcast_to(v[1].mean(axis=0, keepdims=True), out[1].shape)
    np.testing.assert_allclose(out[1], uniform, atol=1e-6)
    np.testing.assert_allclose(out, np.asarray(jattn.masked_attention(*_j(q, k, v, mask))), atol=ATOL)
    kernel = np.asarray(jflash.flash_masked_attention(*_j(q, k, v, mask), block_k=block_k,
                                                      interpret=True))
    np.testing.assert_allclose(kernel[1], uniform * (20 / padded), atol=1e-6)
    np.testing.assert_allclose(out[[0, 2]], kernel[[0, 2]], atol=ATOL)  # sets with a real key agree


def test_dispatcher_flash_and_auto_on_cpu(monkeypatch):
    q, k, v, mask = _p(*_inputs(seed=3))
    calls = []
    wrapper = pflash.flash_masked_attention
    monkeypatch.setattr(pflash, "flash_masked_attention", lambda *a: calls.append(1) or wrapper(*a))
    out = pattn.attention(q, k, v, mask, impl="flash")
    assert calls == [1]
    torch.testing.assert_close(out, pflash.flash_masked_attention_reference(q, k, v, mask),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="attn_bias"):
        pattn.attention(q, k, v, mask, torch.zeros(2, 2, 16, 24), impl="flash")
    # auto on CPU tensors is the einsum path, whatever the shape
    big = torch.zeros(1, 1024, 1, 128)
    torch.testing.assert_close(pattn.attention(q, k, v, mask), pattn.masked_attention(q, k, v, mask),
                               rtol=0, atol=0)
    assert pattn.attention(big[:, :1], big, big).shape == (1, 1, 1, 128)
    assert calls == [1]


@pytest.mark.parametrize("lk,d,bias", [(1024, 128, False), (1023, 128, False), (1024, 64, False),
                                       (6000, 128, False), (2048, 256, False), (1024, 128, True),
                                       (279, 16, False)])
def test_auto_rule_is_the_jax_dispatchers(lk, d, bias, monkeypatch):
    """`auto_picks_flash` against what the JAX dispatcher does on an
    accelerator backend with the same shapes."""
    went = []
    monkeypatch.setattr(jattn.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jflash, "flash_masked_attention", lambda *a, **kw: went.append("flash"))
    monkeypatch.setattr(jattn, "masked_attention", lambda *a, **kw: went.append("einsum"))
    q, kv = jnp.zeros((1, 1, 1, d)), jnp.zeros((1, lk, 1, d))
    jattn.attention(q, kv, kv, attn_bias=jnp.zeros((1, 1, 1, lk)) if bias else None)
    assert pattn.auto_picks_flash(True, lk, d, bias) == (went == ["flash"])
    assert not pattn.auto_picks_flash(False, lk, d, bias)  # never without the card


def test_auto_on_the_card_picks_flash_by_shape(monkeypatch):
    """CPU tensors whose device type is faked: auto hands long sets with head
    dim 128 to the flash wrapper, anything else to the einsum path."""
    calls = []
    monkeypatch.setattr(pflash, "flash_masked_attention", lambda *a: calls.append(a[1].shape[1]))

    class OnCard(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    q = torch.zeros(1, 1, 2, 128).as_subclass(OnCard)
    for lk in (6000, 1024, 1000):
        kv = torch.zeros(1, lk, 2, 128)
        pattn.attention(q, kv, kv)
    assert calls == [6000, 1024]
    q64, kv64 = torch.zeros(1, 1, 2, 64).as_subclass(OnCard), torch.zeros(1, 2000, 2, 64)
    pattn.attention(q64, kv64, kv64)
    pattn.attention(q, torch.zeros(1, 2000, 2, 128), torch.zeros(1, 2000, 2, 128),
                    attn_bias=torch.zeros(1, 2, 1, 2000))
    assert calls == [6000, 1024]


def test_wrapper_checks_its_arguments():
    q, k, v, mask = _p(*_inputs(seed=4))
    with pytest.raises(NotImplementedError, match="forward only"):
        pflash.flash_masked_attention(q.clone().requires_grad_(True), k, v, mask)
    with pytest.raises(NotImplementedError, match="forward only"):
        pattn.attention(q, k, v.clone().requires_grad_(True), mask, impl="flash")
    with torch.no_grad():  # serving runs so
        assert pflash.flash_masked_attention(q.clone().requires_grad_(True), k, v, mask).shape == q.shape
    meta = torch.zeros(2, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        pflash.flash_masked_attention(meta, meta, meta)
    assert pflash.NEG_INF == jflash.NEG_INF == pattn.NEG_INF
    assert pflash.flash_masked_attention.launches == 0  # nothing here ran on a card


@pytest.mark.parametrize("b,lq,lk,h,want", [(32, 1, 6000, 2, 23), (256, 279, 279, 16, 1),
                                            (1, 1, 6000, 2, 23), (4, 1500, 1500, 4, 5),
                                            (1, 1, 100, 1, 1), (640, 1, 150, 16, 1)])
def test_key_splits(b, lq, lk, h, want):
    """The number of blocks that share one head's keys: 1 when the sets, heads
    and query tiles fill the card, never more than one per 256 keys."""
    got = pflash.key_splits(b, lq, lk, h)
    assert got == want
    assert 1 <= got <= max(1, lk // 256)
