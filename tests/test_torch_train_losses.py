"""PyTorch port, training primitives held against the JAX package on the CPU:
the masked losses (`ops/masked.py`), the FM-OT and CFM losses with the draws
of t and the noise pinned to the same numpy arrays on both sides, the EMA
update, the three learning-rate schedules and `build_lr`, and the global-norm
clipping rule against optax's.

Tolerances: losses rtol 1e-6; the schedules rtol 1e-4 (JAX computes them in
float32, the port in float64: up to 30 float32 ulp apart at small learning
rates); EMA atol 1e-7; clipping rtol 1e-6.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from particle_fm_tpu.losses import flow_matching as jloss
from particle_fm_tpu.ops import masked as jmasked
from particle_fm_tpu.train import build_lr as jax_build_lr
from particle_fm_tpu.training import ema as jema
from particle_fm_tpu.training import lr_schedules as jsched
from particle_fm_tpu_torch.losses import flow_matching as ploss
from particle_fm_tpu_torch.ops import masked as pmasked
from particle_fm_tpu_torch.training import lr_schedules as psched
from particle_fm_tpu_torch.training.ema import ema_update
from particle_fm_tpu_torch.training.step import clip_by_global_norm_
from tests.torch_port_helpers import cloud, pin_draws, t


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("name", ["masked_mse", "masked_huber"])
def test_masked_losses_match_jax(name, masked):
    rs = np.random.RandomState(0)
    v, u = (rs.randn(4, 16, 3).astype(np.float32) * 2 for _ in range(2))
    mask = (rs.rand(4, 16, 1) < 0.6).astype(np.float32) if masked else None
    ref = float(getattr(jmasked, name)(jnp.asarray(v), jnp.asarray(u),
                                       None if mask is None else jnp.asarray(mask)))
    out = float(getattr(pmasked, name)(t(v), t(u), None if mask is None else t(mask)))
    np.testing.assert_allclose(out, ref, rtol=1e-6)


def test_huber_matches_jax():
    err = np.linspace(-3, 3, 61).astype(np.float32)
    for delta in (1.0, 0.5):
        np.testing.assert_allclose(pmasked.huber(t(err), delta).numpy(),
                                   np.asarray(jmasked.huber(jnp.asarray(err), delta)), atol=1e-7)


def _linear_vf(w: np.ndarray, framework):
    """A parameter-free vector field of t, y and cond that both sides compute alike."""
    def vf(tt, y, cond, mask):
        out = y @ framework.asarray(w) + tt[:, None, None]
        if cond is not None:
            out = out + cond[:, None, :1]
        return out * mask
    return vf


class _TorchNS:
    asarray = staticmethod(t)


@pytest.mark.parametrize("criterion", ["mse", "huber"])
@pytest.mark.parametrize("loss_type", ["FM-OT", "CFM"])
@pytest.mark.parametrize("masked", [True, False])
def test_flow_matching_losses_match_jax(monkeypatch, loss_type, criterion, masked):
    x, mask, cond, _ = cloud(b=5, n=12, seed=3)
    mask = mask if masked else None
    x = x if masked else np.random.RandomState(4).randn(*x.shape).astype(np.float32)
    w = np.random.RandomState(1).randn(3, 3).astype(np.float32)
    n_normals = 1 if loss_type == "FM-OT" else 2
    pin_draws(monkeypatch, b=5, shape=x.shape, n_normals=n_normals, steps=1, seed=2)
    jfn = jloss.get_loss_fn(loss_type, sigma=1e-4, criterion=criterion)
    pfn = ploss.get_loss_fn(loss_type, sigma=1e-4, criterion=criterion)
    jm = None if mask is None else jnp.asarray(mask)
    ref = float(jfn(_linear_vf(w, jnp), jax.random.PRNGKey(0), jnp.asarray(x), jm,
                    jnp.asarray(cond)))
    out = float(pfn(_linear_vf(w, _TorchNS), torch.Generator(), t(x),
                    None if mask is None else t(mask), t(cond)))
    np.testing.assert_allclose(out, ref, rtol=1e-6)


def test_loss_draws_come_from_the_generator():
    x, mask, _, _ = cloud(b=3, n=8, seed=0)
    fn = ploss.get_loss_fn("FM-OT")
    vf = lambda tt, y, c, m: y
    run = lambda s: float(fn(vf, torch.Generator().manual_seed(s), t(x), t(mask)))
    assert run(0) == run(0) != run(1)


@pytest.mark.parametrize("loss_type", ["CFM-OT", "diffusion", "droid", "reflow"])
def test_unported_losses_raise(loss_type):
    with pytest.raises(NotImplementedError, match=loss_type):
        ploss.get_loss_fn(loss_type)


@pytest.mark.parametrize("step,start,every", [(0, 0, 1), (3, 5, 1), (5, 5, 1), (6, 0, 4),
                                              (8, 0, 4)])
def test_ema_update_matches_jax(step, start, every):
    rs = np.random.RandomState(step)
    ema = [rs.randn(3, 4).astype(np.float32), rs.randn(5).astype(np.float32)]
    params = [rs.randn(3, 4).astype(np.float32), rs.randn(5).astype(np.float32)]
    ref = jema.ema_update([jnp.asarray(e) for e in ema], [jnp.asarray(p) for p in params],
                          jnp.asarray(step), decay=0.9, every_n=every, start_step=start)
    out = [t(e) for e in ema]
    ema_update(out, [t(p) for p in params], step, decay=0.9, every_n=every, start_step=start)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-7)
    applied = step >= start and step % every == 0
    assert applied == (not np.array_equal(out[0].numpy(), ema[0]))


SCHEDULES = {
    "cosine_warmup": dict(warmup=3, max_iters=10),
    "warmup_to_constant": dict(num_steps=4),
    "onecycle_cooldown": dict(warmup=2, cooldown=3, cooldown_final=4, max_lr=3e-3, final_lr=1e-5),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_jax(name):
    spe = 7
    jfn = getattr(jsched, f"{name}_schedule")(1e-3, steps_per_epoch=spe, **SCHEDULES[name])
    pfn = getattr(psched, f"{name}_schedule")(1e-3, steps_per_epoch=spe, **SCHEDULES[name])
    steps = range(0, 14 * spe)
    ref = np.asarray([float(jfn(jnp.asarray(s))) for s in steps])
    out = np.asarray([pfn(s) for s in steps])
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-12)
    if name == "cosine_warmup":
        assert out[0] == 0.0  # the first update of a fresh run moves nothing


@pytest.mark.parametrize("scheduler", [None, {"name": "constant"}, {"name": "cosine_warmup",
                                                                    "warmup": 2, "max_iters": 5}])
def test_build_lr_matches_jax(scheduler):
    jlr = jax_build_lr({"lr": 2e-3}, scheduler, 3)
    plr = psched.build_lr({"lr": 2e-3}, scheduler, 3)
    if not callable(jlr):
        assert plr == jlr
        return
    for s in range(12):
        np.testing.assert_allclose(plr(s), float(jlr(jnp.asarray(s))), rtol=1e-4, atol=1e-12)


@pytest.mark.parametrize("scale", [0.1, 1.0, 7.0])
def test_clip_by_global_norm_matches_optax(scale):
    rs = np.random.RandomState(0)
    grads = [rs.randn(4, 3).astype(np.float32), rs.randn(5).astype(np.float32)]
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads))
    max_norm = float(np.float32(norm / scale))  # under, at and over the norm
    clip = optax.clip_by_global_norm(max_norm)
    ref, _ = clip.update([jnp.asarray(g) for g in grads], clip.init(None))
    out = [t(g) for g in grads]
    clip_by_global_norm_(out, max_norm)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)
    if scale < 1.0:
        assert all(np.array_equal(o.numpy(), g) for o, g in zip(out, grads))
