"""PyTorch port, the two PC-Droid transformer samplers as a whole
(`droid_fulltransformer` with attn_impl=packed, `droid_fullcrossattention`
with attn_impl=fused), held against the JAX package at narrow widths.

Every JAX parameter is replaced by a seeded numpy draw and carried across
(the configurations zero-initialise their attention and output projections,
which would make the vector field exactly 0 and any comparison empty). The
JAX side runs `attn_impl="auto"`, `scores_dtype=None`: the float32 einsum
path both kernels are documented to match. The vector field is held with the
cosine embedding and JAX's frequency table loaded; `sample` and serving with
the sincos embedding against the compiled JAX sampler (the cosine ladder's
e^31 frequency turns the one-ulp time differences of a compiled sampler into
another embedding; tests/test_torch_port_sampler.py).

Tolerances: vector field atol 1e-5; `sample` and serving atol 1e-4.
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
from particle_fm_tpu_torch import serving as pserving
from particle_fm_tpu_torch.models import flow_matching as pfm
from particle_fm_tpu_torch.nets.common import WNDense
from particle_fm_tpu_torch.ops import short_attention as pshort
from tests.torch_port_helpers import cloud, droid_configs, jax_noise, model_pair, t

ROOT = Path(__file__).resolve().parent.parent
IMPL = {"transformer": "packed", "crossattention": "fused"}


def _pair(name, **overrides):
    jcfg, pcfg = droid_configs(port_mha=dict(attn_impl=IMPL[name]), **overrides)[name]
    return model_pair(jcfg, port_cfg=pcfg, fill=True)


@pytest.mark.parametrize("name", list(IMPL))
def test_vector_field_matches_jax(name, monkeypatch):
    jm, variables, pm, net = _pair(name)
    x, mask, cond, ts = cloud(seed=1)
    ref = np.asarray(jm.vector_field(variables, jnp.asarray(ts), jnp.asarray(x),
                                     cond=jnp.asarray(cond), mask=jnp.asarray(mask)))
    assert np.abs(ref).max() > 0.1  # not the zero field of the configured init
    used = []
    wrapper = pshort.fused_short_attention
    monkeypatch.setattr(pshort, "fused_short_attention", lambda *a: used.append(1) or wrapper(*a))
    with torch.no_grad():
        out = pm.vector_field(net, t(ts), t(x), t(cond), t(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    # 2 layers of from + to attention go through the fused wrapper (its plain
    # version here); the packed choice takes the einsum path off the card
    assert len(used) == (4 if name == "crossattention" else 0)
    # a scalar time, as the sampler passes it
    ref0 = np.asarray(jm.vector_field(variables, jnp.float32(0.3), jnp.asarray(x),
                                      cond=jnp.asarray(cond), mask=jnp.asarray(mask)))
    with torch.no_grad():
        out0 = pm.vector_field(net, torch.tensor(0.3), t(x), t(cond), t(mask)).numpy()
    np.testing.assert_allclose(out0, ref0, atol=1e-5)


@pytest.mark.parametrize("name", list(IMPL))
@pytest.mark.parametrize("guidance", [None, 1.5])
def test_sample_matches_compiled_jax(name, guidance):
    jm, variables, pm, net = _pair(name, t_emb="sincos", frequencies=6)
    _, mask, cond, _ = cloud(b=3, seed=2)
    seed = 7
    ref = np.asarray(jm.sample(variables, jax.random.PRNGKey(seed), cond=jnp.asarray(cond),
                               mask=jnp.asarray(mask), ode_solver="midpoint", ode_steps=5,
                               guidance_scale=guidance))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    z = jax_noise(seed, ref.shape, mask)
    out = pm.integrate(net, t(z), t(cond), t(mask), "midpoint", 5, guidance).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    assert np.abs(out - z).max() > 0.1  # the field moved the noise
    # these networks have no weight norm: folding is a no-op, as in JAX
    assert all(m._folded is None for m in net.modules() if isinstance(m, WNDense))
    pm.fold_weight_norm(net)
    assert all(m._folded is None for m in net.modules() if isinstance(m, WNDense))
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())


def test_serve_batches_matches_jax(monkeypatch):
    jm, variables, pm, net = _pair("crossattention", t_emb="sincos", frequencies=6)
    n_req, bs = 5, 2
    _, mask, cond, _ = cloud(b=n_req, seed=5)
    proto = dict(batch_size=bs, ode_solver="midpoint", ode_steps=3, has_cond=True, has_mask=True,
                 means=np.array([0.1, -0.2, 0.3], np.float32),
                 stds=np.array([1.5, 0.5, 2.0], np.float32), normalize_sigma=5.0)
    jfn = jserving.make_serve_fn(jm, variables, **proto)
    meta = {"batch_size": bs, "cond_dim": 2, "use_mask": True, "seed_scheme": "hash_v1"}
    ref = jserving.serve_batches(lambda s, c, m: jfn(jnp.uint32(s), c, m), meta, n_req,
                                 cond=cond, mask=mask, seed=3)
    monkeypatch.setattr(pfm, "draw_noise", lambda gen, shape, device:
                        t(jax_noise(gen.initial_seed(), shape)).to(device))
    pfn = pserving.make_serve_fn(pm, net, **proto)
    out = pserving.serve_batches(pfn, pfn.meta, n_req, cond=cond, mask=mask, seed=3)
    assert out.shape == ref.shape == (n_req, 16, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    assert (out[mask[..., 0] == 0] == 0).all()


def test_bf16_scores_configuration_matches_jax():
    """The yaml's own setting, scores_dtype=bfloat16 on the einsum path."""
    mha = dict(scores_dtype="bfloat16")
    jcfg, pcfg = droid_configs(jax_mha=mha, port_mha=mha)["transformer"]
    jm, variables, pm, net = model_pair(jcfg, port_cfg=pcfg, fill=True)
    x, mask, cond, ts = cloud(seed=6)
    ref = np.asarray(jm.vector_field(variables, jnp.asarray(ts), jnp.asarray(x),
                                     cond=jnp.asarray(cond), mask=jnp.asarray(mask)))
    with torch.no_grad():
        out = pm.vector_field(net, t(ts), t(x), t(cond), t(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-2)  # bf16 rounds at other places in the two


def test_unported_models_and_options_raise():
    for bad, what in ((dict(model="part"), "part"), (dict(model="epic", net_config={"x": 1}), "net_config")):
        with pytest.raises(NotImplementedError, match=what):
            pfm.FlowMatchingModel(hidden_dim=8, latent=4, layers=1, **bad).init(device="cpu")
    # the mixture of experts and the gaussian time embedding are ported: both build
    # (tests/test_torch_moe.py and test_torch_train_gaussian_normaliser.py hold them against JAX)
    moe = pfm.FlowMatchingModel(hidden_dim=8, model="droid_fulltransformer", net_config=dict(
        te_config=dict(model_dim=8, moe_config={}))).init(device="cpu")
    assert hasattr(moe.flows[0].net.te.layer_0, "moe")
    gauss = pfm.FlowMatchingModel(hidden_dim=8, model="droid_fullcrossattention",
                                  t_emb="gaussian").init(device="cpu")
    assert gauss.flows[0].gfp.W.shape == (4,)
    # dropout is ported: a droid model with drp builds (it draws only inside
    # nets/common.py::dropout_generator, which the flow-matching loss never opens)
    drp = dict(model="droid_fullcrossattention",
               net_config=dict(cae_config=dict(model_dim=8, mha_config=dict(drp=0.1))))
    net = pfm.FlowMatchingModel(hidden_dim=8, latent=4, layers=1, **drp).init(device="cpu")
    assert {m.rate for m in net.modules() if hasattr(m, "rate")} >= {0.1}


def test_droid_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in IMPL:
        pm = pfm.FlowMatchingModel(**droid_configs()[name][1])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pm.init()
        assert next(pm.init(device="cpu").parameters()).device.type == "cpu"


def test_new_modules_import_without_jax():
    code = (
        "import sys, particle_fm_tpu_torch.ops._build, particle_fm_tpu_torch.ops.attention, "
        "particle_fm_tpu_torch.ops.short_attention, particle_fm_tpu_torch.nets.transformer, "
        "particle_fm_tpu_torch.models.cnf\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax', 'optax'))"
        " or m == 'particle_fm_tpu' or m.startswith('particle_fm_tpu.') or m == 'triton']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_port_calls_no_library_attention():
    """Neither the kernels' module nor any module on the two paths reaches for
    a library's fused attention or for torch.compile."""
    for path in (ROOT / "particle_fm_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert "scaled_dot_product_attention" not in text and "torch.compile" not in text, path
