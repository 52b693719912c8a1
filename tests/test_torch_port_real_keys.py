"""PyTorch port, the real-keys extent that the bfloat16 packed, flash and
fused ("from") kernels stop at (`ops/short_attention.py::real_key_extents`):
the keys up to a set's last key with a nonzero mask when one of its keys has
a mask of exactly 1, else all Lk.

- The skip is exact: each kernel's plain version over a set's keys cut at its
  extent equals the plain version over all keys (float32: 1e-6, torch's
  reductions may sum a shorter row in another order; bfloat16: 1 ulp of the
  largest |out|; the flash recurrence with the cut on a chunk boundary: bit
  for bit, the chunks past the extent add exactly 0 and rescale by exactly 1).
- The masks of every kind (a prefix, holes, only the last key real, every key
  masked, fractional values only) through the JAX package's Pallas kernels in
  interpret mode against the port's plain versions, atol 2e-5 (as in
  tests/test_torch_port_flash.py and test_torch_port_attention.py), but for
  a set whose keys are all masked where Lk is no multiple of 8: the Pallas
  kernels spread its weight over Lk padded to 8 (fused) or to the chunk
  (flash), the port over its Lk keys (ROADMAP Queue 3, a known difference;
  test_torch_port_flash.py::test_fully_masked_set_known_difference). The
  packed Pallas kernel pads L to 16 and differs likewise where L is no
  multiple of 16.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.ops.pallas import flash_attention as jflash
from particle_fm_tpu.ops.pallas import short_attention as jshort
from particle_fm_tpu_torch.ops import flash_attention as pflash
from particle_fm_tpu_torch.ops import short_attention as pshort
from tests.torch_port_helpers import t

KINDS = ("prefix", "holes", "only the last key", "all masked", "fractional only")
PLAIN = {"flash": lambda q, k, v, m: pflash.flash_masked_attention_reference(q, k, v, m),
         "fused": lambda q, k, v, m: pshort.fused_short_attention_reference(q, k, v, m),
         "packed": lambda q, k, v, m: pshort.packed_short_attention_reference(q, k, v, m)}
QUERY_ROWS = {"flash": 6, "fused": 4, "packed": 150}  # packed: self-attention, Lq = Lk


def _mask(kind: str, b: int, lk: int, seed: int) -> np.ndarray:
    """A (B, Lk) mask of one kind; set 0 of a prefix keeps all its keys."""
    rs = np.random.RandomState(seed)
    keys = np.arange(lk)[None, :]
    counts = rs.randint(1, lk + 1, (b, 1))
    counts[0] = lk
    m = (keys < counts).astype(np.float32)
    if kind == "holes":
        m = m * (keys % 3 == 1)
    elif kind == "only the last key":
        m = np.broadcast_to((keys == lk - 1).astype(np.float32), (b, lk)).copy()
    elif kind == "all masked":
        m = np.zeros((b, lk), np.float32)
    elif kind == "fractional only":
        m = 0.5 * m
    return m.astype(np.float32)


def _qkv(b, lq, lk, h, d, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, n, h, d).astype(np.float32) for n in (lq, lk, lk)]


def _bf16_ulp(x: torch.Tensor) -> float:
    top = float(x.float().abs().max())
    return 2.0 ** (math.floor(math.log2(top)) - 7)


@pytest.mark.parametrize("kind,want", [
    ("prefix", [5, 3, 8]), ("holes", [5, 2, 8]), ("only the last key", [8, 8, 8]),
    ("all masked", [8, 8, 8]), ("fractional only", [8, 8, 8])])
def test_real_key_extents(kind, want):
    m = torch.tensor([[1, 1, 1, 1, 1, 0, 0, 0], [1, 1, 1, 0, 0, 0, 0, 0],
                      [1, 1, 1, 1, 1, 1, 1, 1]], dtype=torch.float32)
    if kind == "holes":
        m = m * (torch.arange(8) % 3 != 2).float()
    elif kind == "only the last key":
        m = (torch.arange(8) == 7).float().expand(3, 8)
    elif kind == "all masked":
        m = torch.zeros(3, 8)
    elif kind == "fractional only":
        m = 0.5 * m
    assert pshort.real_key_extents(m, 3, 8).tolist() == want
    assert pshort.real_key_extents(None, 3, 8).tolist() == [8, 8, 8]


def test_a_fractional_key_past_a_real_one_counts():
    """A mask of exactly 1 somewhere sets the rule; the extent then runs to the
    last nonzero key, whatever its value."""
    m = torch.tensor([[1.0, 0.0, 0.25, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 1.0]])
    assert pshort.real_key_extents(m, 2, 5).tolist() == [3, 5]


@pytest.mark.parametrize("kernel", sorted(PLAIN))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_versions_over_the_real_keys_equal_them_over_all_keys(kernel, dtype, kind):
    b, lq, lk, h, d = 4, QUERY_ROWS[kernel], 150, 2, 16
    q, k, v = (t(a).to(dtype) for a in _qkv(b, lq, lk, h, d, seed=len(kind)))
    mask = t(_mask(kind, b, lk, seed=len(kind) + 1))
    full = PLAIN[kernel](q, k, v, mask)
    ext = pshort.real_key_extents(mask, b, lk)
    for i, e in enumerate(ext.tolist()):
        cut = PLAIN[kernel](q[i:i + 1], k[i:i + 1, :e], v[i:i + 1, :e], mask[i:i + 1, :e])
        err = float((cut.float() - full[i:i + 1].float()).abs().max())
        tol = 1e-6 if dtype == torch.float32 else _bf16_ulp(full[i:i + 1])
        assert err <= tol, (i, e, err, tol)


@pytest.mark.parametrize("kind", ("prefix", "holes"))
def test_flash_recurrence_cut_on_a_chunk_boundary_is_bit_for_bit(kind):
    """Keys cut at a multiple of the chunk: the chunks past the extent add
    exactly 0 to the sum and the accumulator and rescale them by exactly 1."""
    b, lq, lk, h, d, chunk = 3, 5, 96, 2, 8, 16
    q, k, v = (t(a) for a in _qkv(b, lq, lk, h, d, seed=3))
    mask = t(_mask(kind, b, lk, seed=4))
    mask[:, 32:] = 0.0
    mask[:, 31] = 1.0  # every set's extent is 32
    assert pshort.real_key_extents(mask, b, lk).tolist() == [32] * b
    for dtype in (torch.float32, torch.bfloat16):
        qq, kk, vv = (x.to(dtype) for x in (q, k, v))
        full = pflash.flash_masked_attention_reference(qq, kk, vv, mask, block_k=chunk)
        cut = pflash.flash_masked_attention_reference(qq, kk[:, :32], vv[:, :32], mask[:, :32],
                                                      block_k=chunk)
        assert torch.equal(cut, full)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("lq,lk,d", [(6, 40, 16), (4, 37, 8), (21, 19, 12)])
def test_mask_kinds_through_the_pallas_kernels(kind, lq, lk, d):
    b, h = 3, 2
    q, k, v = _qkv(b, lq, lk, h, d, seed=lq + lk + d)
    mask = _mask(kind, b, lk, seed=lk)
    jq, jk, jv, jm = (jnp.asarray(a) for a in (q, k, v, mask))
    pq, pk, pv, pm = (t(a) for a in (q, k, v, mask))
    pallas = {"fused": np.asarray(jshort.fused_short_attention(jq, jk, jv, jm, interpret=True)),
              "flash": np.asarray(jflash.flash_masked_attention(jq, jk, jv, jm, block_k=8,
                                                                interpret=True))}
    ours = {"fused": pshort.fused_short_attention_reference(pq, pk, pv, pm).numpy(),
            "flash": pflash.flash_masked_attention_reference(pq, pk, pv, pm, block_k=8).numpy()}
    for name in pallas:
        if kind == "all masked" and lk % 8:  # the Pallas kernels' padded keys take weight too
            assert not np.allclose(ours[name], pallas[name], atol=2e-5)
        else:
            np.testing.assert_allclose(ours[name], pallas[name], atol=2e-5)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("l,d", [(40, 16), (37, 8), (19, 12), (32, 32)])
def test_mask_kinds_through_the_pallas_packed_kernel(kind, l, d):
    b, h = 3, 2
    q, k, v = _qkv(b, l, l, h, d, seed=l + d)
    mask = _mask(kind, b, l, seed=l)
    pallas = np.asarray(jshort.packed_short_attention(*(jnp.asarray(a) for a in (q, k, v, mask)),
                                                      interpret=True))
    ours = pshort.packed_short_attention_reference(*(t(a) for a in (q, k, v, mask))).numpy()
    if kind == "all masked" and l % 16:  # the Pallas kernel's padded keys take weight too
        assert not np.allclose(ours, pallas, atol=2e-5)
    else:
        np.testing.assert_allclose(ours, pallas, atol=2e-5)
