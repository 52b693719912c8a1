"""PyTorch port, MDMA (`nets/mdma.py`) and the `model="mdma"` sampler, held
against the JAX package at narrow widths.

Every flax parameter is replaced by a seeded numpy draw and carried across
with utils/from_jax.py; inputs come from seeded numpy. The class token's
attention runs the einsum path on both sides here (`impl="auto"` off the
card). The vector field is held with the cosine embedding and JAX's frequency
table loaded; `sample` and serving with the sincos embedding against the
compiled JAX sampler (tests/test_torch_port_sampler.py says why).

Tolerances: `MDMABlock`, `MDMA` and the vector field atol 1e-5; `sample` and
serving atol 1e-4.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu import serving as jserving
from particle_fm_tpu.nets import mdma as jmdma
from particle_fm_tpu_torch import serving as pserving
from particle_fm_tpu_torch.models import flow_matching as pfm
from particle_fm_tpu_torch.nets import mdma as pmdma
from particle_fm_tpu_torch.ops import flash_attention as pflash
from particle_fm_tpu_torch.utils.from_jax import load_flax_params
from tests.torch_port_helpers import MDMA_SMALL, cloud, filled, jax_noise, model_pair, t

ROOT = Path(__file__).resolve().parent.parent
B, N, T, HID, LAT = 3, 10, 6, 16, 8
FILL = 0.15  # scale of the drawn parameters: keeps the 2-layer field of order 1


@pytest.fixture(scope="module")
def cosine_pair():
    return model_pair(MDMA_SMALL, fill=FILL)


@pytest.fixture(scope="module")
def sincos_pair():
    return model_pair(dict(MDMA_SMALL, t_emb="sincos", frequencies=6), fill=FILL)


def _set_inputs(cond_dim, seed):
    """x (B, N, F) masked, mask, cond (B, C) or None, per-set time embedding."""
    x, mask, cond, _ = cloud(b=B, n=N, feats=4, cond_dim=max(cond_dim, 1), seed=seed)
    t_set = np.random.RandomState(seed + 100).randn(B, T).astype(np.float32)
    return x, mask, (cond if cond_dim else None), t_set


def _broadcast(t_set):
    return jnp.broadcast_to(jnp.asarray(t_set)[:, None, :], (B, N, T))


FLAGS = [
    dict(t_local_cat=True, t_global_cat=True),                      # the shipped configuration
    dict(t_local_cat=False, t_global_cat=False),
    dict(t_local_cat=True, t_global_cat=False, local_cat_cond=True),
    dict(t_local_cat=False, t_global_cat=True, global_cat_cond=True),
    dict(t_local_cat=True, t_global_cat=True, local_cat_cond=True, global_cat_cond=True),
]


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "+".join(k for k, v in f.items() if v) or "none")
def test_block_matches_flax(flags):
    rs = np.random.RandomState(0)
    x = rs.randn(B, N, HID).astype(np.float32)
    x_cls = rs.randn(B, 1, LAT).astype(np.float32)
    cond_vec = rs.randn(B, 1, 3).astype(np.float32)  # multiplicity and a 2-wide cond
    _, mask, _, t_set = _set_inputs(0, seed=1)
    jblock = jmdma.MDMABlock(embed_dim=LAT, hidden=HID, num_heads=4, **flags)
    args = [jnp.asarray(a) for a in (x, x_cls, cond_vec, mask)]
    params = filled(jax.eval_shape(lambda r: jblock.init(r, *args, t_in=_broadcast(t_set)),
                                   jax.random.PRNGKey(0))["params"], 1)
    ref_x, ref_cls = jblock.apply({"params": params}, *args, t_in=_broadcast(t_set))
    block = load_flax_params(pmdma.MDMABlock(LAT, HID, T, 3, num_heads=4, **flags), params)
    with torch.no_grad():
        out_x, out_cls = block(t(x), t(x_cls), t(cond_vec), t(mask), t(t_set))
    np.testing.assert_allclose(out_x.numpy(), np.asarray(ref_x), atol=1e-5)
    np.testing.assert_allclose(out_cls.numpy(), np.asarray(ref_cls), atol=1e-5)


@pytest.mark.parametrize("cond_dim", [2, 0], ids=["cond", "nocond"])
@pytest.mark.parametrize("flags", FLAGS[:2] + FLAGS[4:], ids=["tcats", "plain", "allcats"])
def test_mdma_matches_flax(flags, cond_dim):
    if cond_dim == 0 and flags.get("local_cat_cond"):
        cond_dim, global_cond_dim = 1, 0  # cond only through the *_cat_cond options
    else:
        global_cond_dim = cond_dim
    x, mask, cond, t_set = _set_inputs(cond_dim, seed=2)
    cfg = dict(out_features=4, latent=LAT, hidden_dim=HID, layers=2, num_heads=2, avg_n=5,
               global_cond_dim=global_cond_dim, **flags)
    jnet = jmdma.MDMA(**cfg)
    jargs = (_broadcast(t_set), jnp.asarray(x), None if cond is None else jnp.asarray(cond),
             jnp.asarray(mask))
    params = filled(jax.eval_shape(lambda r: jnet.init(r, *jargs), jax.random.PRNGKey(0))["params"], 2)
    ref = np.asarray(jnet.apply({"params": params}, *jargs))
    net = load_flax_params(pmdma.MDMA(4, T, cond_dim=cond_dim, **cfg), params)
    with torch.no_grad():
        out = net(t(t_set), t(x), None if cond is None else t(cond), t(mask)).numpy()
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, atol=1e-5)
    assert (out[mask[..., 0] == 0] == 0).all()
    # no mask: every particle is real
    ref_full = np.asarray(jnet.apply({"params": params}, *jargs[:3], None))
    with torch.no_grad():
        out_full = net(t(t_set), t(x), None if cond is None else t(cond)).numpy()
    np.testing.assert_allclose(out_full, ref_full, atol=1e-5)


@pytest.mark.parametrize("num_heads", [2, 8])
def test_heads_share_one_parameter_tree(num_heads):
    """2 heads of 8 and 8 heads of 2 at hidden 16: the same parameters, as 2
    heads of 128 and 8 heads of 32 at the shipped hidden 256."""
    x, mask, cond, t_set = _set_inputs(1, seed=3)
    cfg = dict(out_features=4, latent=LAT, hidden_dim=HID, layers=2, global_cond_dim=1)
    jargs = (_broadcast(t_set), jnp.asarray(x), jnp.asarray(cond), jnp.asarray(mask))
    params = filled(jax.eval_shape(lambda r: jmdma.MDMA(num_heads=8, **cfg).init(r, *jargs),
                                   jax.random.PRNGKey(0))["params"], 3)
    ref = np.asarray(jmdma.MDMA(num_heads=num_heads, **cfg).apply({"params": params}, *jargs))
    net = load_flax_params(pmdma.MDMA(4, T, cond_dim=1, num_heads=num_heads, **cfg), params)
    with torch.no_grad():
        out = net(t(t_set), t(x), t(cond), t(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_vector_field_matches_jax(cosine_pair, monkeypatch):
    jm, variables, pm, net = cosine_pair
    x, mask, cond, ts = cloud(feats=4, cond_dim=1, seed=4)
    ref = np.asarray(jm.vector_field(variables, jnp.asarray(ts), jnp.asarray(x),
                                     cond=jnp.asarray(cond), mask=jnp.asarray(mask)))
    assert ref.shape == x.shape and np.abs(ref).max() > 0.1
    used = []
    monkeypatch.setattr(pflash, "flash_masked_attention", lambda *a: used.append(1))
    with torch.no_grad():
        out = pm.vector_field(net, t(ts), t(x), t(cond), t(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    assert used == []  # off the card `auto` is the einsum path
    ref0 = np.asarray(jm.vector_field(variables, jnp.float32(0.3), jnp.asarray(x),
                                      cond=jnp.asarray(cond), mask=jnp.asarray(mask)))
    with torch.no_grad():  # a scalar time, as the sampler passes it
        out0 = pm.vector_field(net, torch.tensor(0.3), t(x), t(cond), t(mask)).numpy()
    np.testing.assert_allclose(out0, ref0, atol=1e-5)


@pytest.mark.parametrize("guidance", [None, 1.5])
def test_sample_matches_compiled_jax(sincos_pair, guidance):
    jm, variables, pm, net = sincos_pair
    _, mask, cond, _ = cloud(b=3, feats=4, cond_dim=1, seed=5)
    seed = 9
    ref = np.asarray(jm.sample(variables, jax.random.PRNGKey(seed), cond=jnp.asarray(cond),
                               mask=jnp.asarray(mask), ode_solver="midpoint", ode_steps=5,
                               guidance_scale=guidance))
    z = jax_noise(seed, ref.shape, mask)
    out = pm.integrate(net, t(z), t(cond), t(mask), "midpoint", 5, guidance).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    assert np.abs(out - z).max() > 0.1  # the field moved the noise
    assert (out[mask[..., 0] == 0] == 0).all()


def test_serve_batches_matches_jax(sincos_pair, monkeypatch):
    jm, variables, pm, net = sincos_pair
    n_req, bs = 5, 2
    _, mask, cond, _ = cloud(b=n_req, feats=4, cond_dim=1, seed=6)
    proto = dict(batch_size=bs, ode_solver="midpoint", ode_steps=3, has_cond=True, has_mask=True,
                 means=np.array([0.1, -0.2, 0.3, 0.0], np.float32),
                 stds=np.array([1.5, 0.5, 2.0, 1.0], np.float32), normalize_sigma=5.0)
    jfn = jserving.make_serve_fn(jm, variables, **proto)
    meta = {"batch_size": bs, "cond_dim": 1, "use_mask": True, "seed_scheme": "hash_v1"}
    ref = jserving.serve_batches(lambda s, c, m: jfn(jnp.uint32(s), c, m), meta, n_req,
                                 cond=cond, mask=mask, seed=3)
    monkeypatch.setattr(pfm, "draw_noise", lambda gen, shape, device:
                        t(jax_noise(gen.initial_seed(), shape)).to(device))
    pfn = pserving.make_serve_fn(pm, net, **proto)
    assert pfn.meta["cond_dim"] == 1
    out = pserving.serve_batches(pfn, pfn.meta, n_req, cond=cond, mask=mask, seed=3)
    assert out.shape == ref.shape == (n_req, 16, 4)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    assert (out[mask[..., 0] == 0] == 0).all()


def test_out_features_follow_the_model_and_can_be_set():
    pm = pfm.FlowMatchingModel(**MDMA_SMALL)
    assert pm.init(device="cpu").flows[0].net.out.features == 4
    one = dict(MDMA_SMALL, net_config=dict(MDMA_SMALL["net_config"], out_features=1))
    assert pfm.FlowMatchingModel(**one).init(device="cpu").flows[0].net.out.features == 1


def test_unported_and_missing_inputs_raise():
    with pytest.raises(NotImplementedError, match="float32"):  # bfloat16 is ported
        pmdma.MDMA(4, T, dtype=torch.float16)
    with pytest.raises(ValueError, match="cond_dim"):
        pmdma.MDMA(4, T, cond_dim=0, global_cond_dim=1)
    net = pmdma.MDMA(4, T, cond_dim=1, global_cond_dim=1, hidden_dim=HID, layers=1, num_heads=2)
    with pytest.raises(ValueError, match="none given"):
        net(torch.zeros(B, T), torch.zeros(B, N, 4))
    with pytest.raises(ValueError, match="divisible"):
        pmdma.MDMABlock(LAT, HID, T, 1, num_heads=3)


def test_transplant_is_checked_both_ways(cosine_pair):
    jm, variables, pm, net = cosine_pair
    params = jax.device_get(variables["params"])
    block = dict(params["flows_0"]["net"]["block_0"])
    less = {"flows_0": {"net": dict(params["flows_0"]["net"], block_0={
        k: v for k, v in block.items() if k != "ln"})}}
    with pytest.raises(ValueError, match="only-in-port.*block_0.ln"):
        load_flax_params(net, less)
    wide = dict(MDMA_SMALL, net_config=dict(MDMA_SMALL["net_config"], hidden_dim=64))
    with pytest.raises(ValueError, match="shape mismatch"):
        load_flax_params(pfm.FlowMatchingModel(**wide).init(device="cpu"), params)


def test_mdma_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pm = pfm.FlowMatchingModel(**MDMA_SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pm.init()
    assert next(pm.init(device="cpu").parameters()).device.type == "cpu"


def test_new_modules_import_without_jax():
    code = (
        "import sys, particle_fm_tpu_torch.ops.flash_attention, particle_fm_tpu_torch.nets.mdma, "
        "particle_fm_tpu_torch.nets.norm_layer, particle_fm_tpu_torch.models.flow_matching\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax', 'optax'))"
        " or m == 'particle_fm_tpu' or m.startswith('particle_fm_tpu.') or m == 'triton']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
