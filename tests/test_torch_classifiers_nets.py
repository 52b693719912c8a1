"""PyTorch port, the classifiers' networks held against the flax modules
after the weight transplant (`utils/from_jax.py`): the three EPiC
discriminators (cond on both MLP paths, super-sets), the transformer
classifier, ParT (its pair features, each `pt_transform`, `kin_means`),
ParticleNet (`knn_indices` index for index with ties, the whole network
with JAX's neighbour indices handed to the port, fusion on and off) and
nets/mlp.py. Every flax parameter is a seeded numpy draw; inputs are ragged
numpy sets. Tolerances: the pair features 1e-6,
the networks and nets/mlp.py's stacks rtol 1e-5 (float32, sums in another
order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.models import classifiers as jcls
from particle_fm_tpu.nets import epic as jepic
from particle_fm_tpu.nets import mlp as jmlp
from particle_fm_tpu.nets import part as jpart
from particle_fm_tpu.nets import particlenet as jpn
from particle_fm_tpu_torch.models import classifiers as pcls
from particle_fm_tpu_torch.nets import epic as pepic
from particle_fm_tpu_torch.nets import mlp as pmlp
from particle_fm_tpu_torch.nets import part as ppart
from particle_fm_tpu_torch.nets import particlenet as ppn
from particle_fm_tpu_torch.utils.from_jax import load_flax_params
from tests.torch_port_helpers import filled, t

RTOL, ATOL = 1e-5, 1e-6


def _sets(b=6, n=12, feats=3, seed=0, lo=1):
    rs = np.random.RandomState(seed)
    counts = rs.randint(lo, n + 1, size=(b, 1))
    counts[0] = n
    mask = (np.arange(n)[None, :] < counts).astype(np.float32)[..., None]
    return (rs.randn(b, n, feats).astype(np.float32) * mask, mask,
            rs.randn(b, 3).astype(np.float32))


def _pair(jmod, pmod, *jargs, seed=0, scale=0.3, **jkw):
    shapes = jax.eval_shape(lambda r: jmod.init(r, *jargs, **jkw), jax.random.PRNGKey(0))
    params = filled(shapes["params"], seed, scale)
    load_flax_params(pmod, params)
    return {"params": params}


def _close(out, ref, rtol=RTOL, atol=ATOL):
    ref = np.asarray(ref)
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=rtol, atol=atol)


EPIC = dict(hid_dim=16, latent_dim=4, equiv_layers=2)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(global_cond_dim=3, local_cond_dim=3),
    dict(local_cond_dim=3),
    dict(num_sup_sets=2, out_dim=2),
    dict(activation="relu", sum_scale=0.05, use_weight_norm=False),
])
def test_epic_discriminator_matches_jax(kw):
    x, mask, cond = _sets(seed=1)
    c = cond if (kw.get("global_cond_dim") or kw.get("local_cond_dim")) else None
    jmod = jepic.EPiCDiscriminator(**EPIC, **kw)
    pmod = pepic.EPiCDiscriminator(3, cond_dim=3 if c is not None else 0, **EPIC, **kw)
    args = (jnp.asarray(x),)
    jkw = dict(cond=None if c is None else jnp.asarray(c), mask=jnp.asarray(mask))
    variables = _pair(jmod, pmod, *args, **jkw)
    ref = jmod.apply(variables, *args, **jkw)
    out = pmod(t(x), None if c is None else t(c), t(mask))
    assert out.shape == ref.shape == (6 // kw.get("num_sup_sets", 1), kw.get("out_dim", 1))
    _close(out, ref)


@pytest.mark.parametrize("masked,cond", [(True, False), (True, True), (False, False)])
def test_epic_discriminator2_matches_jax(masked, cond):
    x, mask, c = _sets(seed=2)
    jmod = jepic.EPiCDiscriminator2(**EPIC, global_cond_dim=3 if cond else 0)
    pmod = pepic.EPiCDiscriminator2(3, cond_dim=3 if cond else 0,
                                    global_cond_dim=3 if cond else 0, **EPIC)
    jkw = dict(cond=jnp.asarray(c) if cond else None,
               mask=jnp.asarray(mask) if masked else None)
    variables = _pair(jmod, pmod, jnp.asarray(x), **jkw)
    ref = jmod.apply(variables, jnp.asarray(x), **jkw)
    out = pmod(t(x), t(c) if cond else None, t(mask) if masked else None)
    assert out.shape == (6, 2 * 16 + 4)
    _close(out, ref)


def test_epic_discriminator3_matches_jax():
    x, mask, _ = _sets(b=8, seed=3)
    jmod = jepic.EPiCDiscriminator3(hid_dim=16, latent_dim=4, equiv_layers=2, num_sup_sets=2)
    pmod = pepic.EPiCDiscriminator3(3, hid_dim=16, latent_dim=4, equiv_layers=2, num_sup_sets=2)
    variables = _pair(jmod, pmod, jnp.asarray(x), mask=jnp.asarray(mask), scale=0.2)
    ref = jmod.apply(variables, jnp.asarray(x), mask=jnp.asarray(mask))
    out = pmod(t(x), mask=t(mask))
    assert out.shape == (4, 1)
    _close(out, ref)


def test_transformer_classifier_matches_jax():
    x, mask, _ = _sets(seed=4)
    te = {"model_dim": 16, "num_layers": 2, "mha_config": {"num_heads": 4}}
    jmod = jcls.TransformerClassifierNet(n_classes=3, te_config=te)
    pmod = pcls.TransformerClassifierNet(3, n_classes=3, te_config=te)
    variables = _pair(jmod, pmod, jnp.asarray(x), mask=jnp.asarray(mask))
    _close(pmod(t(x), t(mask)), jmod.apply(variables, jnp.asarray(x), mask=jnp.asarray(mask)))


def _kinematic_sets(b=5, n=10, seed=5):
    """etarel, dphi in (-0.8, 0.8), log_part_pt-scaled pt, then noise
    columns; ragged, with garbage in the padded slots (|eta| ~ 100)."""
    rs = np.random.RandomState(seed)
    counts = rs.randint(2, n + 1, size=(b, 1))
    mask = (np.arange(n)[None, :] < counts).astype(np.float32)[..., None]
    x = rs.randn(b, n, 5).astype(np.float32) * 0.4
    x[..., 2] = (np.log(rs.exponential(20.0, (b, n))) - 1.7) * 0.7
    x = np.where(mask > 0, x, 100.0).astype(np.float32)
    return x, mask


@pytest.mark.parametrize("transform", ["log_scaled", "log", "identity"])
def test_pairwise_features_match_jax(transform):
    x, mask = _kinematic_sets(seed=6)
    rs = np.random.RandomState(7)
    pt = rs.exponential(30.0, x.shape[:2]).astype(np.float32)
    pt[:, 0] = 0.0  # a real particle of pt 0 meets the clamps
    phi = (rs.rand(*x.shape[:2]) * 6.0 - 3.0).astype(np.float32) * 2.0  # wraps
    ref, ref_pm = jpart.pairwise_features(jnp.asarray(pt), jnp.asarray(x[..., 0]),
                                          jnp.asarray(phi), jnp.asarray(mask))
    out, pm = ppart.pairwise_features(t(pt), t(x[..., 0]), t(phi), t(mask))
    assert torch.isfinite(out).all()
    np.testing.assert_array_equal(pm.numpy(), np.asarray(ref_pm))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


PART = dict(embed_dims=(16, 32, 16), num_heads=2, num_layers=2, num_cls_layers=2,
            pair_embed_dims=(8, 8))


@pytest.mark.parametrize("transform,kin", [("log_scaled", False), ("log_scaled", True),
                                           ("log", False), ("identity", False)])
def test_part_matches_jax(transform, kin):
    x, mask = _kinematic_sets(seed=8)
    x = x * mask
    kw = dict(PART, pt_transform=transform)
    if transform == "identity":
        x[..., 2] = np.abs(x[..., 2]) * mask[..., 0]
    if kin:
        kw.update(kin_means=(0.1, -0.1, 0.5, 0.0, 0.2), kin_stds=(1.1, 0.9, 1.3, 1.0, 2.0))
    jmod = jpart.ParTClassifierNet(n_classes=2, **kw)
    pmod = ppart.ParTClassifierNet(5, n_classes=2, **kw)
    variables = _pair(jmod, pmod, jnp.asarray(x), mask=jnp.asarray(mask), scale=0.2)
    ref = jmod.apply(variables, jnp.asarray(x), mask=jnp.asarray(mask))
    _close(pmod(t(x), t(mask)), ref)


def test_part_refuses_an_unknown_pt_transform():
    with pytest.raises(ValueError, match="pt_transform"):
        ppart.ParTClassifierNet(5, pt_transform="bogus")


@pytest.mark.parametrize("counts", [(5, 10, 32, 17), (1, 2, 16, 18)])
def test_knn_indices_match_jax_index_for_index(counts):
    """Sets with fewer and more than k + 1 real particles: a query's own
    distance ties at 1e9 with every padded column, and both packages take
    the query first, then the padded columns in index order."""
    n, k = 32, 16
    rs = np.random.RandomState(sum(counts))
    points = rs.randn(len(counts), n, 2).astype(np.float32)
    mask = (np.arange(n)[None, :] < np.array(counts)[:, None]).astype(np.float32)[..., None]
    ref = np.asarray(jpn.knn_indices(jnp.asarray(points), jnp.asarray(mask), k))
    out = ppn.knn_indices(t(points), t(mask), k)
    np.testing.assert_array_equal(out.numpy(), ref)
    for i, c in enumerate(counts):
        if c < k:  # a real query's real neighbours, then itself, then the padded columns
            assert out[i, 0, c - 1] == 0 and out[i, 0, c] == c
    assert ppn.knn_indices(t(points[:, :4]), None, k).shape == (len(counts), 4, 3)


def _replayed_knn(monkeypatch, jax_call):
    """Run `jax_call` recording the JAX package's kNN indices, then hand the
    port the same indices in the same order."""
    seen = []
    orig = jpn.knn_indices
    monkeypatch.setattr(jpn, "knn_indices", lambda p, m, k: seen.append(orig(p, m, k)) or seen[-1])
    ref = jax_call()
    replay = iter(seen)
    monkeypatch.setattr(ppn, "knn_indices", lambda p, m, k: torch.from_numpy(
        np.asarray(next(replay)).astype(np.int64)))
    return ref, seen


PN = dict(conv_params=((4, (8, 8)), (4, (16, 16, 16))), fc_params=((16, 0.1), (8, 0.2)))


@pytest.mark.parametrize("kw", [dict(use_fusion=False), dict(use_fusion=True),
                                dict(use_fts_bn=False, use_counts=False)])
def test_particlenet_matches_jax_on_jax_neighbours(kw, monkeypatch):
    x, mask, _ = _sets(b=5, n=12, feats=4, seed=9, lo=3)
    cfg = dict(PN, **kw)
    jmod = jpn.ParticleNetClassifierNet(n_classes=3, point_indices=(0, 1), net_config=cfg)
    pmod = ppn.ParticleNetClassifierNet(4, n_classes=3, point_indices=(0, 1), net_config=cfg)
    variables = _pair(jmod, pmod, jnp.asarray(x), mask=jnp.asarray(mask))
    ref, seen = _replayed_knn(
        monkeypatch, lambda: jmod.apply(variables, jnp.asarray(x), mask=jnp.asarray(mask)))
    assert len(seen) == 2
    _close(pmod(t(x), t(mask)), ref)


def test_particlenet_names_its_modules_as_flax():
    x, mask, _ = _sets(b=2, n=8, feats=4, seed=10)
    jmod = jpn.ParticleNetClassifierNet(n_classes=2, net_config=dict(PN, use_fusion=True))
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), mask=jnp.asarray(mask))["params"]
    inner = params["particle_net"]
    assert {"fts_norm", "EdgeConvBlock_0", "EdgeConvBlock_1", "Dense_0", "LayerNorm_0",
            "Dense_1", "Dense_2", "head"} == set(inner)
    pmod = ppn.ParticleNetClassifierNet(4, n_classes=2, net_config=dict(PN, use_fusion=True))
    load_flax_params(pmod, jax.device_get(params))  # every leaf lands, shapes checked


def test_cathode_classifier_and_mlps_match_jax():
    rs = np.random.RandomState(11)
    x, tt, c = (rs.randn(7, w).astype(np.float32) for w in (5, 2, 3))
    cases = [
        (jmlp.CathodeClassifier(layers=(8, 16, 8)), pmlp.CathodeClassifier(5, (8, 16, 8)),
         (x,), (x,)),
        (jmlp.MLP(4, (8, 8)), pmlp.MLP(5, 4, (8, 8)), (x,), (x,)),
        (jmlp.ResNetBlock(8, 8), pmlp.ResNetBlock(5, 8, 8), (x,), (x,)),
        (jmlp.ResNetBlock(6, 8), pmlp.ResNetBlock(5, 6, 8), (x,), (x,)),
        (jmlp.SmallCondMLP(5), pmlp.SmallCondMLP(5, 5, t_dim=2, cond_dim=3), (tt, x, c),
         (tt, x, c)),
        (jmlp.VerySmallCondMLP(5), pmlp.VerySmallCondMLP(5, 5, t_dim=2), (tt, x), (tt, x)),
        (jmlp.SmallCondResNet(5), pmlp.SmallCondResNet(5, 5, t_dim=2, cond_dim=3), (tt, x, c),
         (tt, x, c)),
    ]
    for jmod, pmod, jargs, pargs in cases:
        jargs = tuple(jnp.asarray(a) for a in jargs)
        variables = _pair(jmod, pmod, *jargs, scale=0.1)
        ref = jmod.apply(variables, *jargs)
        _close(pmod(*(t(a) for a in pargs)), ref)
