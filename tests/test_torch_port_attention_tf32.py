"""PyTorch port, the arithmetic of the tensor-core attention kernels
(`ops/attention_tf32.py`: split-precision TF32, the streaming tile step) held
against the JAX package's Pallas kernels run in interpret mode, on the same
seeded numpy inputs, and the kernels' tile geometry as the wrappers mirror it.

Tolerances:
- the three-product model against the Pallas kernels and against the port's
  plain versions: atol 2e-5, the tolerance the plain versions themselves are
  held to (tests/test_torch_port_attention.py, test_torch_port_flash.py). The
  split drops the remainder-times-remainder term and the last bits of each
  remainder, 2^-21 of a product, so the model is float32 arithmetic in
  another order with a few more roundings;
- the one-product model must MISS 1e-4 (the tolerance a kernel is held to on
  the card) once q and k are scaled by 4: TF32 keeps 10 mantissa bits, and a
  score of some tens then carries an error of some 1e-2. That is why the
  kernels pay for three products;
- two products in p . v (the remainder of p dropped) must miss 1e-4 as well:
  the weights lose their bits below 2^-11.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.ops.pallas import flash_attention as jflash
from particle_fm_tpu.ops.pallas import short_attention as jshort
from particle_fm_tpu_torch.ops import attention_tf32 as tf32
from particle_fm_tpu_torch.ops import flash_attention as pflash
from particle_fm_tpu_torch.ops import short_attention as pshort
from particle_fm_tpu_torch.ops import tf32 as split
from tests.torch_port_helpers import t

ATOL = 2e-5
KERNEL_TOL = 1e-4


def _inputs(l, d, seed, b=3, h=2, bias=False, qk_scale=1.0, lk=None):
    rs = np.random.RandomState(seed)
    lk = l if lk is None else lk
    q = rs.randn(b, l, h, d).astype(np.float32) * np.float32(qk_scale)
    k = rs.randn(b, lk, h, d).astype(np.float32) * np.float32(qk_scale)
    v = rs.randn(b, lk, h, d).astype(np.float32)
    n_valid = rs.randint(1, lk + 1, (b, 1))  # ragged, at least one real key
    n_valid[0] = lk
    mask = (np.arange(lk)[None, :] < n_valid).astype(np.float32)
    ab = rs.randn(b, h, l, lk).astype(np.float32) if bias else None
    return q, k, v, mask, ab


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _p(*arrays):
    return [None if a is None else t(a) for a in arrays]


def test_split_keeps_all_but_the_last_bits():
    x = t(np.random.RandomState(0).randn(4096) * 37.0)
    hi, lo = split.split_tf32(x)
    for part in (hi, lo):  # what the unit reads: the low 13 mantissa bits are clear
        assert (part.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((x - hi).abs() <= x.abs() * 2.0 ** -11).all()  # to nearest: half an ulp of 10 bits
    assert ((x - (hi + lo)).abs() < x.abs() * 2.0 ** -21).all()
    # the head: ties away from zero, as cvt.rna.tf32.f32; the unit itself cuts
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12])
    assert split.tf32_round(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]
    assert split.tf32_truncate(tie).tolist() == [1.0, -1.0, 1.0]
    exact = torch.tensor([0.0, 1.0, -2.5, 1024.0, 1.0 + 2.0 ** -10])
    assert torch.equal(split.tf32_round(exact), exact)
    assert torch.equal(split.split_tf32(exact)[1], torch.zeros(5))
    with pytest.raises(ValueError, match="products"):
        split.product_tf32("ij,jk->ik", torch.eye(2), torch.eye(2), 4)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("l", [5, 17, 40])
def test_three_product_packed_model_matches_pallas_kernel(l, d, bias):
    args = _inputs(l, d, seed=l + d, bias=bias)
    ref = np.asarray(jshort.packed_short_attention(*_j(*args), interpret=True))
    out = tf32.packed_attention_tf32(*_p(*args)).numpy()
    assert out.shape == ref.shape == (3, l, 2, d)
    np.testing.assert_allclose(out, ref, atol=ATOL)
    plain = pshort.packed_short_attention_reference(*_p(*args)).numpy()
    np.testing.assert_allclose(out, plain, atol=ATOL)


@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("l", [5, 17, 40])
def test_three_product_flash_model_matches_pallas_kernel(l, d):
    q, k, v, mask, _ = _inputs(l, d, seed=100 + l + d)
    ref = np.asarray(jflash.flash_masked_attention(*_j(q, k, v, mask), block_k=8, interpret=True))
    out = tf32.flash_attention_tf32(*_p(q, k, v, mask)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL)
    plain = pflash.flash_masked_attention_reference(*_p(q, k, v, mask)).numpy()
    np.testing.assert_allclose(out, plain, atol=ATOL)


@pytest.mark.parametrize("kernel", ["packed", "flash"])
@pytest.mark.parametrize("d", [8, 16])
def test_scaled_scores_need_three_products(kernel, d):
    """q and k times 4: scores of some tens, as a trained network's sharp
    heads give. Three products still agree with the Pallas kernel; one misses
    the tolerance a kernel is held to on the card."""
    q, k, v, mask, _ = _inputs(40, d, seed=200 + d, qk_scale=4.0)
    if kernel == "packed":
        ref = np.asarray(jshort.packed_short_attention(*_j(q, k, v, mask), interpret=True))
        model = tf32.packed_attention_tf32
    else:
        ref = np.asarray(jflash.flash_masked_attention(*_j(q, k, v, mask), block_k=8,
                                                       interpret=True))
        model = tf32.flash_attention_tf32
    assert np.abs(np.einsum("bqhd,bkhd->bhqk", q, k)).max() / np.sqrt(d) > 30.0
    three = model(*_p(q, k, v, mask), products=3).numpy()
    np.testing.assert_allclose(three, ref, atol=ATOL)
    one = model(*_p(q, k, v, mask), products=1).numpy()
    assert np.abs(one - ref).max() > KERNEL_TOL
    assert not np.allclose(one, ref, atol=KERNEL_TOL, rtol=KERNEL_TOL)


@pytest.mark.parametrize("qk_scale", [1.0, 4.0])
def test_pv_product_needs_three_products_too(qk_scale):
    """Three products in q . k and fewer in p . v: with the remainder of p
    dropped (two products) or both remainders dropped (one) the result misses
    1e-4, so the kernels split p and v as well."""
    q, k, v, mask, _ = _inputs(40, 16, seed=300, b=8, qk_scale=qk_scale)
    ref = pshort.packed_short_attention_reference(*_p(q, k, v, mask)).numpy()
    errs = {n: np.abs(tf32.packed_attention_tf32(*_p(q, k, v, mask), products=3,
                                                 pv_products=n).numpy() - ref).max()
            for n in (1, 2, 3)}
    assert errs[3] <= ATOL
    assert errs[2] > KERNEL_TOL and errs[1] > KERNEL_TOL


@pytest.mark.parametrize("kernel", ["packed", "flash"])
def test_model_keeps_a_fully_masked_set_uniform(kernel):
    """-1e9 is added in float32 to the accumulated score and rounds it away:
    the weights of a set without a real key are uniform over its keys."""
    q, k, v, mask, _ = _inputs(20, 16, seed=400)
    mask[1] = 0.0
    model = tf32.packed_attention_tf32 if kernel == "packed" else tf32.flash_attention_tf32
    out = model(*_p(q, k, v, mask)).numpy()
    assert np.isfinite(out).all()
    uniform = np.broadcast_to(v[1].mean(axis=0, keepdims=True), out[1].shape)
    np.testing.assert_allclose(out[1], uniform, atol=1e-6)


def test_step_size_changes_the_order_not_the_function():
    q, k, v, mask, ab = _inputs(40, 16, seed=500, bias=True)
    one_pass = tf32.packed_attention_tf32(*_p(q, k, v, mask, ab), step=40).numpy()
    for step in (8, 16):
        out = tf32.packed_attention_tf32(*_p(q, k, v, mask, ab), step=step).numpy()
        np.testing.assert_allclose(out, one_pass, atol=ATOL)
    cross = _inputs(5, 8, seed=501, lk=37)  # Lq != Lk: the flash kernel's shapes
    out = tf32.flash_attention_tf32(*_p(*cross[:4])).numpy()
    ref = pflash.flash_masked_attention_reference(*_p(*cross[:4])).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("dp", [8, 16, 32, 64])
def test_packed_geometry_fits_a_block_at_every_shape(dp):
    """Every (L <= 256, head dim) the wrapper admits: the staged keys cover
    the set in whole tiles, the warps cover the query rows (in turns where
    there are more tiles than warps), and the shared memory fits a block."""
    step, rows = pshort.MMA_KEYS, pshort.MMA_ROWS
    worst = 0
    for d in range(dp // 2 + 1, dp + 1):
        assert pshort.padded_head_dim(d) == dp
        for l in range(1, pshort.MAX_PACKED_LEN + 1):
            geo = pshort.packed_geometry(l, d)
            assert l <= geo["keys"] < l + step and geo["keys"] % step == 0
            assert 1 <= geo["warps"] <= -(-l // rows) and 32 * geo["warps"] <= 512
            # K and V rows of dp floats and the mask at the least; the rows' padding on top
            assert 4 * geo["keys"] * (2 * dp + 1) < geo["smem_bytes"] <= pshort.MAX_SMEM == 232448
            worst = max(worst, geo["smem_bytes"])
    # counted by hand at L=256: 512 rows of dp+4 floats and 256 of the mask
    assert worst == {8: 25600, 16: 41984, 32: 74752, 64: 140288}[dp]
    # the registers of q's fragments and the accumulator halve the warps at 64
    assert pshort.packed_geometry(256, dp)["warps"] == (8 if dp == 64 else 16)


def test_packed_geometry_at_the_served_shape():
    geo = pshort.packed_geometry(150, 16)  # PC-Droid transformer, JetNet-150
    assert geo == {"warps": 10, "keys": 152, "smem_bytes": 24928}
    assert 3 * geo["smem_bytes"] < pshort.MAX_SMEM  # three blocks to an SM, as the registers allow


@pytest.mark.parametrize("b,lq,lk,h,d,splits,blocks,warps",
                         [(32, 1, 6000, 2, 128, 23, None, None),   # path C: the class token
                          (256, 279, 279, 16, 16, 1, 3, 6),        # path D: 279 particles
                          (4, 1500, 1500, 4, 64, 5, 12, 8),
                          (640, 150, 150, 16, 16, 1, 2, 5),
                          (3, 5, 5, 3, 8, 1, 1, 1)])
def test_flash_geometry_and_key_splits(b, lq, lk, h, d, splits, blocks, warps):
    """`key_splits` counts the blocks of `ROWS_PER_BLOCK` query rows that the
    launcher makes; the tensor-core variant's blocks are equal in size."""
    assert pflash.ROWS_PER_BLOCK == 128
    assert pflash.key_splits(b, lq, lk, h) == splits
    if lq <= pflash.DIRECT_MAX_ROWS or d > pflash.MMA_MAX_HEAD_DIM:
        return  # the CUDA-core variants
    geo = pflash.mma_geometry(lq, d)
    assert geo["blocks"] == -(-lq // pflash.ROWS_PER_BLOCK)  # what key_splits counted
    assert (geo["blocks"], geo["warps"]) == (blocks, warps)
    assert geo["blocks"] * geo["warps"] * pshort.MMA_ROWS >= lq
    assert geo["warps"] * pshort.MMA_ROWS <= pflash.ROWS_PER_BLOCK
    assert geo["smem_bytes"] <= 48 * 1024
