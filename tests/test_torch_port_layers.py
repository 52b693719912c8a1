"""PyTorch port, shared layers: nets/common.py, ops/masked.py, nets/time_emb.py
and utils/from_jax.py held against the JAX package on seeded numpy inputs.

Tolerance: float32, atol 1e-6 (one matmul of width <= 40 or a reduction over
16 rows; the two sides differ only in summation order)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.nets import common as jcommon
from particle_fm_tpu.nets import time_emb as jtime
from particle_fm_tpu.ops import masked as jmasked
from particle_fm_tpu_torch.nets import common as pcommon
from particle_fm_tpu_torch.nets import time_emb as ptime
from particle_fm_tpu_torch.ops import masked as pmasked
from particle_fm_tpu_torch.utils.from_jax import load_flax_params, state_dict_from_flax
from tests.torch_port_helpers import cloud, jax_cos_table, t

ATOL = 1e-6


@pytest.mark.parametrize("name", ["leaky_relu", "lrlu", "relu", "gelu", "elu", "selu",
                                  "silu", "sigmoid", "tanh", "softmax", "identity", "nope"])
def test_get_act(name):
    x = np.random.RandomState(0).randn(4, 7).astype(np.float32) * 3
    ref = np.asarray(jcommon.get_act(name)(jnp.asarray(x)))
    out = pcommon.get_act(name)(t(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("use_weight_norm", [True, False])
def test_wndense_matches_jax(use_weight_norm):
    rs = np.random.RandomState(1)
    x = rs.randn(5, 9, 12).astype(np.float32)
    jd = jcommon.WNDense(7, use_weight_norm=use_weight_norm)
    params = jd.init(jax.random.PRNGKey(0), jnp.asarray(x))
    if use_weight_norm:  # move g away from ||v|| so the normalisation matters
        params = jax.tree_util.tree_map(lambda a: a, params)
        params["params"]["g"] = params["params"]["g"] * 1.7
    ref = np.asarray(jd.apply(params, jnp.asarray(x)))
    pd = pcommon.WNDense(12, 7, use_weight_norm=use_weight_norm)
    load_flax_params(pd, jax.device_get(params["params"]))
    np.testing.assert_allclose(pd(t(x)).detach().numpy(), ref, atol=ATOL)
    pd.fold()
    np.testing.assert_allclose(pd(t(x)).detach().numpy(), ref, atol=ATOL)


def test_wndense_split_matches_jax():
    rs = np.random.RandomState(2)
    b, n = 4, 6
    ts = rs.randn(b, 5).astype(np.float32)
    xp = rs.randn(b, n, 8).astype(np.float32)
    gs = rs.randn(b, 3).astype(np.float32)
    segs = lambda a, x, c: [(a, "set"), (x, "particle"), (None, "set"), (c, "set")]
    jd = jcommon.WNDenseSplit(11)
    jargs = segs(jnp.asarray(ts), jnp.asarray(xp), jnp.asarray(gs))
    params = jd.init(jax.random.PRNGKey(3), jargs)
    ref = np.asarray(jd.apply(params, jargs))
    pd = pcommon.WNDenseSplit([(5, "set"), (8, "particle"), (0, "set"), (3, "set")], 11)
    load_flax_params(pd, jax.device_get(params["params"]))
    out = pd(segs(t(ts), t(xp), t(gs))).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)
    with pytest.raises(ValueError, match="segment layout"):
        pd(segs(t(ts), t(xp), None))


def test_wndense_weight_norm_clamps_zero_rows():
    pd = pcommon.WNDense(3, 2, init_zeros=True)
    w = pd.effective_weight()
    assert torch.isfinite(w).all() and (w == 0).all()


def test_cat_skips_none_and_zero_width():
    a = torch.ones(2, 3)
    out = pcommon.cat(None, a, torch.zeros(2, 0), 2 * a)
    assert out.shape == (2, 6) and (out[:, 3:] == 2).all()
    assert pcommon.cat(a, None) is a
    assert pcommon.cat(None, torch.zeros(2, 0)) is None


def test_masked_ops_match_jax():
    x, mask, _, _ = cloud(b=5, n=16, feats=6, seed=3)
    x = x + 0.5  # make padded slots nonzero before masking
    jx, jm = jnp.asarray(x), jnp.asarray(mask)
    for pf, jf in ((pmasked.masked_sum, jmasked.masked_sum),
                   (pmasked.masked_mean, jmasked.masked_mean)):
        np.testing.assert_allclose(pf(t(x), t(mask)).numpy(), np.asarray(jf(jx, jm)), atol=ATOL)
        np.testing.assert_allclose(pf(t(x), None).numpy(), np.asarray(jf(jx, None)), atol=ATOL)
    np.testing.assert_array_equal(pmasked.apply_mask(t(x), t(mask)).numpy(),
                                  np.asarray(jmasked.apply_mask(jx, jm)))
    for m in (mask, None):
        pm, ps = pmasked.meansum_pool(t(x), None if m is None else t(m), 1e-2)
        jmn, js = jmasked.meansum_pool(jx, None if m is None else jnp.asarray(m), 1e-2)
        np.testing.assert_allclose(pm.numpy(), np.asarray(jmn), atol=ATOL)
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=ATOL)


def test_masked_mean_of_empty_set_is_nan_as_in_jax():
    x = torch.ones(1, 4, 2)
    m = torch.zeros(1, 4, 1)
    assert torch.isnan(pmasked.meansum_pool(x, m)[0]).all()
    assert np.isnan(np.asarray(jmasked.meansum_pool(jnp.ones((1, 4, 2)), jnp.zeros((1, 4, 1)))[0])).all()


def test_sincos_embedding_matches_jax():
    ts = np.random.RandomState(4).rand(7).astype(np.float32)
    ref = np.asarray(jtime.broadcast_time_embedding(jnp.asarray(ts), 5, "sincos", 6))
    out = ptime.broadcast_time_embedding(t(ts), 5, "sincos", 6).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("scalar", [True, False])
def test_cosine_embedding_matches_jax_with_shared_table(scalar):
    ts = np.random.RandomState(5).rand(7).astype(np.float32)
    if scalar:
        ts = ts[:1].reshape(())
    freqs = t(jax_cos_table(32))
    ref = np.asarray(jtime.broadcast_time_embedding(jnp.asarray(ts), 5, "cosine", 16))
    out = ptime.broadcast_time_embedding(t(ts), 5, "cosine", 16, freqs=freqs).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL)
    lin_ref = np.asarray(jtime.cosine_encoding(jnp.asarray(ts), 8, frequency_scaling="linear"))
    lin = ptime.cosine_encoding(t(ts), 8, frequency_scaling="linear").numpy()
    np.testing.assert_allclose(lin, lin_ref, atol=ATOL)


def test_cosine_table_known_difference():
    """torch.exp and the JAX package's exp may round exp(k) differently by
    one ulp (ROADMAP Queue 3). With frequencies up to e^31 such an ulp moves
    cos() completely, so the port takes the table as a buffer that the
    parity tests overwrite with JAX's. This test pins that the two tables
    are at most one ulp apart, entry by entry."""
    ours = ptime.cosine_frequencies(32).numpy()
    theirs = jax_cos_table(32)
    ulps = np.abs(ours.view(np.int32).astype(np.int64) - theirs.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1, ulps


def test_from_jax_checks_both_ways():
    jd = jcommon.WNDense(4)
    params = jax.device_get(jd.init(jax.random.PRNGKey(0), jnp.ones((1, 3)))["params"])
    sd = state_dict_from_flax(params)
    assert sd["weight_v"].shape == (4, 3) and sd["g"].shape == (4,)
    np.testing.assert_array_equal(sd["weight_v"].numpy(), np.asarray(params["kernel"]).T)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_flax_params(pcommon.WNDense(5, 4), params)
    with pytest.raises(ValueError, match="mismatch"):
        load_flax_params(pcommon.WNDense(3, 4), {k: v for k, v in params.items() if k != "g"})
    with pytest.raises(ValueError, match="mismatch"):
        load_flax_params(pcommon.WNDense(3, 4, use_bias=False), params)
