"""PyTorch port, the in-model normaliser: `nets/norm_layer.py`, the
`normalise_cond`/`reverse_norm` methods of `CNFStack` and `use_normaliser` in the
sampler, held against the JAX package with carried statistics.

The statistics are fitted the JAX package's way (one masked Welford update of
the flax "norm_stats" collection on seeded data) and carried into the port's
buffers with utils/from_jax.py; these tests hold how the port applies them
(tests/test_torch_train_gaussian_normaliser.py holds the port's own update).

Tolerances: `forward`/`reverse` atol 1e-6; `sample` and serving atol 1e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu import serving as jserving
from particle_fm_tpu.models.flow_matching import FlowMatchingModel as JaxModel
from particle_fm_tpu.nets.norm_layer import IterativeNormLayer as JaxNorm
from particle_fm_tpu_torch import serving as pserving
from particle_fm_tpu_torch.models import flow_matching as pfm
from particle_fm_tpu_torch.nets.norm_layer import IterativeNormLayer
from particle_fm_tpu_torch.utils.from_jax import load_flax_params
from tests.torch_port_helpers import MDMA_SMALL, YAML_FLAGSHIP, cloud, jax_noise, model_pair, t

EPIC = dict(YAML_FLAGSHIP, t_emb="sincos", frequencies=6, use_normaliser=True)
MDMA = dict(MDMA_SMALL, t_emb="sincos", frequencies=6, use_normaliser=True)


def _fitted_layer(dim, x, mask):
    """A flax layer's statistics after one update on x."""
    layer = JaxNorm(dim)
    args = (jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    stats = layer.init(jax.random.PRNGKey(0), *args)
    _, stats = layer.apply(stats, *args, update_stats=True, mutable=["norm_stats"])
    return layer, jax.device_get(stats)


def _fitted_stats(cfg, seed=0):
    """The "norm_stats" collection of a model after one training-style update
    of both normalisers on shifted, scaled data."""
    jm = JaxModel(**cfg)
    variables = jm.init(jax.random.PRNGKey(seed))
    x, mask, cond, _ = cloud(b=6, feats=cfg["features"], cond_dim=cfg["global_cond_dim"], seed=seed)
    x = (x * 3.0 + 1.5) * mask
    _, upd = jm.module.apply(variables, jnp.asarray(x), jnp.asarray(mask), update_stats=True,
                             method="normalise", mutable=["norm_stats"])
    variables = {**variables, **upd}
    _, upd = jm.module.apply(variables, jnp.asarray(cond * 2.0 - 0.7), update_stats=True,
                             method="normalise_cond", mutable=["norm_stats"])
    return jax.device_get(upd["norm_stats"])


@pytest.mark.parametrize("masked", [True, False], ids=["set", "flat"])
def test_forward_and_reverse_match_flax(masked):
    if masked:
        x, mask, _, _ = cloud(b=5, feats=4, seed=1)
        x = (x * 2.0 - 3.0) * mask
    else:
        x, mask = np.random.RandomState(1).randn(7, 5).astype(np.float32) * 4.0 + 2.0, None
    jlayer, stats = _fitted_layer(x.shape[-1], x, mask)
    layer = load_flax_params(IterativeNormLayer(x.shape[-1]), {}, stats["norm_stats"])
    assert float(layer.n) > 0 and not np.allclose(layer.means.numpy(), 0.0)
    jmask = None if mask is None else jnp.asarray(mask)
    ref = np.asarray(jlayer.apply(stats, jnp.asarray(x), jmask))
    out = layer(t(x), None if mask is None else t(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    y = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    ref_rev = np.asarray(jlayer.apply(stats, jnp.asarray(y), jmask, method="reverse"))
    np.testing.assert_allclose(layer.reverse(t(y), None if mask is None else t(mask)).numpy(),
                               ref_rev, atol=1e-6)
    # reverse undoes forward; padding passes through both untouched
    back = layer.reverse(layer(t(x), None if mask is None else t(mask)),
                         None if mask is None else t(mask)).numpy()
    np.testing.assert_allclose(back, x, atol=1e-5)
    if masked:
        pad = mask[..., 0] == 0
        marked = np.where(mask > 0, x, 7.0).astype(np.float32)
        assert (layer(t(marked), t(mask)).numpy()[pad] == 7.0).all()
        assert (layer.reverse(t(marked), t(mask)).numpy()[pad] == 7.0).all()


def test_fresh_layer_is_the_identity_and_update_raises():
    """A fresh layer is the identity. The update no longer raises: it is
    ported, and its first call fits the batch as the JAX layer does
    (tests/test_torch_train_gaussian_normaliser.py holds later updates)."""
    layer = IterativeNormLayer(3)
    x = torch.randn(4, 5, 3)
    torch.testing.assert_close(layer(x), x, atol=1e-6, rtol=0)  # mean 0, var 1, eps 1e-8
    assert set(layer.state_dict()) == {"means", "m2", "vars", "n"}
    assert layer.n.shape == () and layer.max_n == 500_000
    jlayer, stats = _fitted_layer(3, x.numpy(), None)
    layer(x, update_stats=True)
    for k, v in stats["norm_stats"].items():
        np.testing.assert_allclose(getattr(layer, k).numpy(), v, rtol=1e-6, atol=0, err_msg=k)
    net = pfm.FlowMatchingModel(**EPIC).init(device="cpu")
    net.normaliser(x, update_stats=True)
    assert float(net.normaliser.n) == 20.0


@pytest.mark.parametrize("cfg", [EPIC, MDMA], ids=["epic", "mdma"])
def test_stack_methods_match_jax(cfg):
    stats = _fitted_stats(cfg)
    assert set(stats) == {"normaliser", "ctxt_normaliser"}
    jm, variables, pm, net = model_pair(cfg, norm_stats=stats)
    x, mask, cond, _ = cloud(feats=cfg["features"], cond_dim=cfg["global_cond_dim"], seed=3)
    for method, call, args in (("normalise", net.normaliser, (x, mask)),
                               ("reverse_norm", net.reverse_norm, (x, mask)),
                               ("normalise_cond", net.normalise_cond, (cond,))):
        ref = np.asarray(jm.module.apply(variables, *map(jnp.asarray, args), method=method))
        out = call(*map(t, args)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-6)
        assert np.abs(out - args[0]).max() > 0.1  # the statistics are not the initial ones


@pytest.mark.parametrize("cfg,guidance", [(EPIC, None), (EPIC, 2.0), (MDMA, None)],
                         ids=["epic", "epic-cfg", "mdma"])
def test_sample_with_normaliser_matches_compiled_jax(cfg, guidance):
    stats = _fitted_stats(cfg)
    jm, variables, pm, net = model_pair(cfg, fill=0.15 if cfg is MDMA else False, norm_stats=stats)
    _, mask, cond, _ = cloud(b=3, feats=cfg["features"], cond_dim=cfg["global_cond_dim"], seed=4)
    seed = 13
    ref = np.asarray(jm.sample(variables, jax.random.PRNGKey(seed), cond=jnp.asarray(cond),
                               mask=jnp.asarray(mask), ode_solver="midpoint", ode_steps=5,
                               guidance_scale=guidance))
    z = jax_noise(seed, ref.shape, mask)
    out = pm.integrate(net, t(z), t(cond), t(mask), "midpoint", 5, guidance).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    assert (out[mask[..., 0] == 0] == 0).all()  # padding passes through the reverse
    # the normaliser is what makes the difference: without it the answer is another
    plain = pfm.FlowMatchingModel(**dict(cfg, use_normaliser=False))
    other = plain.integrate(net, t(z), t(cond), t(mask), "midpoint", 5, guidance).numpy()
    assert np.abs(other - ref).max() > 0.1


def test_unconditioned_model_has_no_cond_normaliser():
    cfg = dict(EPIC, global_cond_dim=0, local_cond_dim=0)
    jm = JaxModel(**cfg)
    variables = jm.init(jax.random.PRNGKey(0))
    x, mask, _, _ = cloud(b=6, seed=5)
    _, upd = jm.module.apply(variables, jnp.asarray(x * 2 + 1) * mask, jnp.asarray(mask),
                             update_stats=True, method="normalise", mutable=["norm_stats"])
    stats = jax.device_get(upd["norm_stats"])
    assert set(stats) == {"normaliser"}
    jm, variables, pm, net = model_pair(cfg, norm_stats=stats)
    assert not hasattr(net, "ctxt_normaliser")
    _, mask, _, _ = cloud(b=3, seed=6)
    ref = np.asarray(jm.sample(variables, jax.random.PRNGKey(2), mask=jnp.asarray(mask),
                               ode_solver="euler", ode_steps=4))
    out = pm.integrate(net, t(jax_noise(2, ref.shape, mask)), None, t(mask), "euler", 4).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_serving_with_normaliser_matches_jax(monkeypatch):
    stats = _fitted_stats(EPIC)
    jm, variables, pm, net = model_pair(EPIC, norm_stats=stats)
    n_req, bs = 3, 2
    _, mask, cond, _ = cloud(b=n_req, seed=7)
    proto = dict(batch_size=bs, ode_solver="midpoint", ode_steps=3, has_cond=True, has_mask=True)
    jfn = jserving.make_serve_fn(jm, variables, **proto)
    meta = {"batch_size": bs, "cond_dim": 2, "use_mask": True, "seed_scheme": "hash_v1"}
    ref = jserving.serve_batches(lambda s, c, m: jfn(jnp.uint32(s), c, m), meta, n_req,
                                 cond=cond, mask=mask, seed=5)
    monkeypatch.setattr(pfm, "draw_noise", lambda gen, shape, device:
                        t(jax_noise(gen.initial_seed(), shape)).to(device))
    pfn = pserving.make_serve_fn(pm, net, **proto)
    out = pserving.serve_batches(pfn, pfn.meta, n_req, cond=cond, mask=mask, seed=5)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_statistics_are_carried_and_checked_both_ways():
    stats = _fitted_stats(EPIC)
    jm, variables, pm, net = model_pair(EPIC, norm_stats=stats)
    for name, leaves in stats.items():
        for leaf, value in leaves.items():
            np.testing.assert_array_equal(net.state_dict()[f"{name}.{leaf}"].numpy(), value)
    params = jax.device_get(variables["params"])
    with pytest.raises(ValueError, match="only-in-port.*normaliser"):
        load_flax_params(net, params)  # the statistics are missing
    with pytest.raises(ValueError, match="only-in-flax.*normaliser"):
        load_flax_params(pfm.FlowMatchingModel(**dict(EPIC, use_normaliser=False)).init(device="cpu"),
                         params, stats)
    wrong = {**stats, "normaliser": {**stats["normaliser"], "means": np.zeros(5, np.float32)}}
    with pytest.raises(ValueError, match="shape mismatch at normaliser.means"):
        load_flax_params(net, params, wrong)


def test_self_cond_and_dtype_go_on_raising():
    """A dtype the port lacks (float16; bfloat16 samples) raises; self_cond
    raises where the JAX model raises: with a loss whose path is not linear
    and with more than one flow."""
    with pytest.raises(NotImplementedError):
        pfm.FlowMatchingModel(dtype="float16")
    for bad in (dict(self_cond=True, loss_type="diffusion"), dict(self_cond=True, n_transforms=2)):
        with pytest.raises(ValueError, match="self_cond"):
            pfm.FlowMatchingModel(**bad)
    assert pfm.FlowMatchingModel(use_normaliser=True, normaliser_config={"max_n": 10}).init(
        device="cpu").normaliser.max_n == 10
