"""PyTorch port, the PC-Droid transformer family (`nets/transformer.py`) held
against the flax modules after the weight transplant (`utils/from_jax.py`).

Every flax parameter is replaced by a seeded numpy draw before it is carried
across, so the zero-initialised projections of the configurations cannot hide
the attention. The JAX side runs `attn_impl="auto"`, `scores_dtype=None` (the
float32 einsum path that both kernels are documented to match); the port
runs "auto", "packed" and "fused", which on CPU tensors are the einsum path,
the einsum path again and the fused kernel's plain version. Tolerance: atol
1e-5 (float32, sums in another order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.nets import transformer as jtr
from particle_fm_tpu_torch.nets import transformer as ptr
from particle_fm_tpu_torch.nets.common import dropout_generator
from particle_fm_tpu_torch.utils.from_jax import load_flax_params
from tests.torch_port_helpers import cloud, droid_net_config, filled, t

ATOL = 1e-5
MHA = dict(num_heads=4, init_zeros=True, do_layer_norm=True)
DENSE = dict(act_h="lrlu", nrm="layer", output_init_zeros=True)


def _transplant(jmod, pmod, *jargs, seed=0, **jkwargs):
    """Init the flax module, fill its tree from numpy, load it into the port
    module; returns the flax variables."""
    shapes = jax.eval_shape(lambda r: jmod.init(r, *jargs, **jkwargs), jax.random.PRNGKey(0))
    params = filled(shapes["params"], seed)
    load_flax_params(pmod, params)
    return {"params": params}


def _tokens(b=4, n=10, dim=32, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, n, dim).astype(np.float32)
    n_valid = rs.randint(2, n + 1, size=(b, 1))
    mask = (np.arange(n)[None, :] < n_valid).astype(np.float32)
    ctxt = rs.randn(b, 6).astype(np.float32)
    return x, mask, ctxt


@pytest.mark.parametrize(
    "kwargs,ctxt_rank",
    [(dict(n_layers=2, nrm="layer", do_res=True), 2), (dict(n_layers=1, init_zeros=True), 2),
     (dict(n_layers=2, init_zeros=True, act="none"), 2), (dict(n_layers=1, nrm="layer"), 3),
     (dict(ctxt_dim=0, n_layers=1), 0)],
)
def test_mlp_block_matches_jax(kwargs, ctxt_rank):
    kwargs = dict(dict(outp_dim=32, ctxt_dim=6), **kwargs)
    x, _, ctxt = _tokens(seed=1)
    if ctxt_rank == 3:  # a context of the tokens' rank is concatenated, not split
        ctxt = np.broadcast_to(ctxt[:, None, :], (4, 10, 6)).copy()
    c = ctxt if kwargs["ctxt_dim"] else None
    jmod, pmod = jtr.MLPBlock(**kwargs), ptr.MLPBlock(32, **kwargs)
    variables = _transplant(jmod, pmod, jnp.asarray(x), None if c is None else jnp.asarray(c))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x), None if c is None else jnp.asarray(c)))
    out = pmod(t(x), None if c is None else t(c)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)
    if kwargs["ctxt_dim"]:
        with pytest.raises(ValueError, match="contextual"):
            pmod(t(x))


@pytest.mark.parametrize(
    "kwargs",
    [dict(outp_dim=20, ctxt_dim=6, hddn_dim=24, **DENSE),
     dict(outp_dim=0, ctxt_dim=6, hddn_dim=[24, 24, 16], n_lyr_pbk=2, do_res=True, ctxt_in_hddn=True,
          nrm="layer", nrm_on_output=True, act_o="tanh"),
     dict(ctxt_dim=0, hddn_dim=16, num_blocks=2, do_out=False)],
)
def test_dense_network_matches_jax(kwargs):
    x, _, ctxt = _tokens(seed=2)
    c = ctxt if kwargs["ctxt_dim"] else None
    jmod, pmod = jtr.DenseNetwork(**kwargs), ptr.DenseNetwork(32, **kwargs)
    jc = None if c is None else jnp.asarray(c)
    variables = _transplant(jmod, pmod, jnp.asarray(x), jc)
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x), jc))
    out = pmod(t(x), None if c is None else t(c)).detach().numpy()
    assert out.shape[-1] == pmod.out_dim == jmod.out_dim(32)
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("impl", ["auto", "packed", "fused"])
@pytest.mark.parametrize("selfattn", [True, False])
def test_attention_block_matches_jax(impl, selfattn):
    x, mask, _ = _tokens(seed=3)
    kv, kv_mask, _ = _tokens(n=7, seed=4)
    jmod = jtr.MultiHeadedAttentionBlock(32, do_selfattn=selfattn, **MHA)
    pmod = ptr.MultiHeadedAttentionBlock(32, do_selfattn=selfattn, attn_impl=impl, **MHA)
    if selfattn:
        jargs, pargs, jm, pm = (jnp.asarray(x),), (t(x),), jnp.asarray(mask), t(mask)
    else:
        jargs, pargs = (jnp.asarray(x), jnp.asarray(kv)), (t(x), t(kv))
        jm, pm = jnp.asarray(kv_mask), t(kv_mask)
    variables = _transplant(jmod, pmod, *jargs, kv_mask=jm)
    ref = np.asarray(jmod.apply(variables, *jargs, kv_mask=jm))
    with torch.no_grad():
        out = pmod(*pargs, kv_mask=pm).numpy()
    assert np.abs(ref).max() > 0.1  # out_linear is no longer zero
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_attention_block_bias_and_bf16_scores_match_jax():
    x, mask, _ = _tokens(seed=5)
    bias = np.random.RandomState(6).randn(4, 4, 10, 10).astype(np.float32)
    jmod = jtr.MultiHeadedAttentionBlock(32, do_selfattn=True, scores_dtype="bfloat16", **MHA)
    pmod = ptr.MultiHeadedAttentionBlock(32, do_selfattn=True, scores_dtype="bfloat16", **MHA)
    variables = _transplant(jmod, pmod, jnp.asarray(x))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x), kv_mask=jnp.asarray(mask),
                                attn_bias=jnp.asarray(bias)))
    out = pmod(t(x), kv_mask=t(mask), attn_bias=t(bias)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=5e-2)  # bf16 scores, then LayerNorm and a projection
    with pytest.raises(ValueError, match="divisible"):
        ptr.MultiHeadedAttentionBlock(30, num_heads=4)
    with pytest.raises(ValueError, match="scores_dtype"):
        ptr.MultiHeadedAttentionBlock(32, scores_dtype="float8")


@pytest.mark.parametrize("impl", ["auto", "packed", "fused"])
def test_encoder_layer_matches_jax(impl):
    x, mask, ctxt = _tokens(seed=7)
    jmod = jtr.TransformerEncoderLayer(32, MHA, DENSE, ctxt_dim=6)
    pmod = ptr.TransformerEncoderLayer(32, dict(MHA, attn_impl=impl), DENSE, ctxt_dim=6)
    jargs = (jnp.asarray(x), jnp.asarray(mask), jnp.asarray(ctxt))
    variables = _transplant(jmod, pmod, *jargs)
    ref = np.asarray(jmod.apply(variables, *jargs))
    with torch.no_grad():
        out = pmod(t(x), t(mask), t(ctxt)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("impl", ["auto", "fused"])
@pytest.mark.parametrize("masked", [True, False])
def test_cross_attention_layer_matches_jax(impl, masked):
    q, _, ctxt = _tokens(n=3, seed=8)
    kv, kv_mask, _ = _tokens(n=10, seed=9)
    jmod = jtr.TransformerCrossAttentionLayer(32, MHA, DENSE, ctxt_dim=6)
    pmod = ptr.TransformerCrossAttentionLayer(32, dict(MHA, attn_impl=impl), DENSE, ctxt_dim=6)
    jm, pm = (jnp.asarray(kv_mask), t(kv_mask)) if masked else (None, None)
    jargs = (jnp.asarray(q), jnp.asarray(kv), jm, jnp.asarray(ctxt))
    variables = _transplant(jmod, pmod, *jargs)
    ref = np.asarray(jmod.apply(variables, *jargs))
    with torch.no_grad():
        out = pmod(t(q), t(kv), pm, t(ctxt)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_transformer_encoder_matches_jax():
    x, mask, ctxt = _tokens(seed=10)
    jmod = jtr.TransformerEncoder(32, 2, MHA, DENSE, ctxt_dim=6)
    pmod = ptr.TransformerEncoder(32, 2, dict(MHA, attn_impl="packed"), DENSE, ctxt_dim=6)
    jargs = (jnp.asarray(x), jnp.asarray(mask), jnp.asarray(ctxt))
    variables = _transplant(jmod, pmod, *jargs)
    ref = np.asarray(jmod.apply(variables, *jargs))
    with torch.no_grad():
        out = pmod(t(x), t(mask), t(ctxt)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


FULL = {
    "transformer": (jtr.FullTransformerEncoder, ptr.FullTransformerEncoder, "te_config", "packed", {}),
    "crossattention": (jtr.FullCrossAttentionEncoder, ptr.FullCrossAttentionEncoder, "cae_config",
                       "fused", {"num_tokens": 3}),
}


def _full_pair(name, ctxt_dim=34):
    jcls, pcls, core, impl, extra = FULL[name]
    jmod = jcls(outp_dim=3, ctxt_dim=ctxt_dim, **droid_net_config(core, **extra))
    pmod = pcls(35, outp_dim=3, ctxt_dim=ctxt_dim,
                **droid_net_config(core, dict(attn_impl=impl), **extra))
    return jmod, pmod


@pytest.mark.parametrize("name", list(FULL))
def test_full_encoder_matches_jax(name):
    jmod, pmod = _full_pair(name)
    _, mask, cond, _ = cloud(b=4, n=16, seed=11)
    rs = np.random.RandomState(12)
    x = rs.randn(4, 16, 35).astype(np.float32)
    t_set = rs.randn(4, 32).astype(np.float32)
    t_bcast = jnp.broadcast_to(jnp.asarray(t_set)[:, None, :], (4, 16, 32))  # the JAX calling form
    jargs = (t_bcast, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(mask))
    variables = _transplant(jmod, pmod, *jargs)
    ref = np.asarray(jmod.apply(variables, *jargs))
    with torch.no_grad():
        out = pmod(t(t_set), t(x), t(cond), t(mask)).numpy()
    assert out.shape == (4, 16, 3) and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_full_encoder_without_context_or_mask_matches_jax():
    jmod, pmod = _full_pair("transformer", ctxt_dim=0)
    x = np.random.RandomState(13).randn(2, 9, 35).astype(np.float32)
    variables = _transplant(jmod, pmod, None, jnp.asarray(x))
    ref = np.asarray(jmod.apply(variables, None, jnp.asarray(x)))
    with torch.no_grad():
        out = pmod(None, t(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_configured_init_is_zero_where_jax_has_zeros():
    """Un-transplanted, the port zero-initialises what the JAX modules do."""
    for name in FULL:
        jmod, pmod = _full_pair(name)
        x, mask, cond, _ = cloud(b=2, n=16, seed=14)
        jargs = (jnp.zeros((2, 16, 32)), jnp.zeros((2, 16, 35)), jnp.asarray(cond), jnp.asarray(mask))
        params = jax.device_get(jmod.init(jax.random.PRNGKey(0), *jargs)["params"])
        zeros = {"/".join(str(getattr(k, "key", k)) for k in path)
                 for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
                 if not np.any(leaf)}
        own = {k.replace(".", "/"): v for k, v in pmod.state_dict().items()}
        port_zeros = {k.replace("/weight", "/kernel") for k, v in own.items() if not v.any()}
        assert zeros == port_zeros and any("out_linear" in z for z in zeros)
        with torch.no_grad():
            assert not pmod(torch.zeros(2, 32), torch.randn(2, 16, 35), t(cond), t(mask)).any()


@pytest.mark.parametrize("name,dropped", [("transformer", ("te", "layer_0", "norm1")),
                                         ("transformer", ("node_embd", "input_block", "nrm_0")),
                                         ("crossattention", ("cae", "global_tokens"))])
def test_transplant_catches_a_missing_leaf(name, dropped):
    jmod, pmod = _full_pair(name)
    _, mask, cond, _ = cloud(b=2, n=16, seed=15)
    jargs = (jnp.zeros((2, 16, 32)), jnp.zeros((2, 16, 35)), jnp.asarray(cond), jnp.asarray(mask))
    params = filled(jax.eval_shape(lambda r: jmod.init(r, *jargs), jax.random.PRNGKey(0))["params"])
    node = params
    for key in dropped[:-1]:
        node = node[key]
    del node[dropped[-1]]
    with pytest.raises(ValueError, match="only-in-port=.*" + dropped[-1]):
        load_flax_params(pmod, params)
    node[dropped[-1]] = {"surplus": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="only-in-flax=.*surplus"):
        load_flax_params(pmod, params)


def test_unported_options_raise():
    # moe_config is ported (tests/test_torch_moe.py): the dense block becomes the MoE
    layer = ptr.TransformerEncoderLayer(32, MHA, DENSE, moe_config={"num_experts": 2})
    assert layer.moe.w1.shape == (2, 32, 64) and not hasattr(layer, "dense")
    full = ptr.FullTransformerEncoder(35, 3, te_config=dict(model_dim=32, moe_config={}))
    assert full.te.layer_0.moe.num_experts == 4
    # dropout is ported: the three blocks build with drp=0.1 and draw it only
    # inside `dropout_generator` (nets/common.py)
    x = torch.ones(2, 5, 8)
    for block, call in ((ptr.MLPBlock(8, 8, drp=0.1), lambda m: m(x)),
                        (ptr.DenseNetwork(8, drp=0.1, drp_on_output=True), lambda m: m(x)),
                        (ptr.MultiHeadedAttentionBlock(8, drp=0.1, do_selfattn=True),
                         lambda m: m(x))):
        quiet = call(block)
        with dropout_generator(block, torch.Generator().manual_seed(0)):
            dropped = call(block)
        assert torch.equal(call(block), quiet) and not torch.equal(dropped, quiet)
    with pytest.raises(ValueError, match="normalisation"):
        ptr.MLPBlock(8, 8, nrm="batch")
    with pytest.raises(ValueError, match="nowhere"):
        ptr.DenseNetwork(8, ctxt_dim=2, ctxt_in_inpt=False)


def test_resolve_fte_configs_matches_jax():
    cfg = droid_net_config("te_config")
    args = (cfg["te_config"], cfg["node_embd_config"], cfg["outp_embd_config"], cfg["ctxt_embd_config"])
    assert ptr.resolve_fte_configs(*args) == jtr.resolve_fte_configs(*args)
    assert ptr.resolve_fte_configs({}, {}, {}, {}) == jtr.resolve_fte_configs({}, {}, {}, {})
