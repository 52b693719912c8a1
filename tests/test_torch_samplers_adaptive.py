"""PyTorch port, the self-conditioned fixed-step loop and the adaptive
DOPRI5 solvers (samplers/ode.py) held against the JAX package on the CPU:
alone on parameter-free fields, and through `FlowMatchingModel` at a small
width of the EPiC flagship (FM-OT) and of configs/model/diffusion.yaml
(probability-flow drift), for `dopri5` (one step size for the batch) and
`dopri5_per_sample` (the JAX package's vmap over the loop, here one batched
loop). DOPRI5's accept decisions are discontinuous in the error norm, so
the number of attempted steps is held equal as well as x. The models take the
sincos time embedding: with the cosine one (frequencies up to e^31) a field
is a chaotic function of t, and one float32 ulp of an adaptive step size,
where the two packages' `pow` round apart, changes every later error norm
(measured: 14 steps against JAX's 12 on the same weights). With sincos the
compiled JAX sampler is the reference.

Tolerances: samples atol 1e-4, times the largest |x| where that exceeds 1
(a random noise predictor takes the diffusion sampler's x to ~1/signal_rate(0)
~ 50 times the prior's scale, where float32 resolves 1e-5); DOPRI5 step
counts equal.
"""

from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.samplers import ode as jode
from particle_fm_tpu_torch.samplers import ode as pode
from tests.torch_port_helpers import YAML_FLAGSHIP, cloud, jax_noise, model_pair, t


def _sc_fields(w):
    return (lambda tt, x, sc: -x @ jnp.asarray(w) + 0.5 * jnp.tanh(sc) * tt,
            lambda tt, x, sc: -x @ t(w) + 0.5 * torch.tanh(sc) * tt)


@pytest.mark.parametrize("method", ["euler", "midpoint"])
@pytest.mark.parametrize("ode_steps", [2, 9, 60])
def test_odeint_fixed_sc_matches_jax(method, ode_steps):
    rs = np.random.RandomState(ode_steps)
    w = (np.eye(3) + 0.3 * rs.randn(3, 3)).astype(np.float32)
    x0 = rs.randn(4, 5, 3).astype(np.float32)
    jf, pf = _sc_fields(w)
    with jax.disable_jit():
        ref = np.asarray(jode.odeint_fixed_sc(jf, jnp.asarray(x0), 1.0, 0.0, ode_steps, method))
    out = pode.odeint_fixed_sc(pf, t(x0), 1.0, 0.0, ode_steps, method).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    with pytest.raises(ValueError, match="euler/midpoint"):
        pode.odeint_fixed_sc(pf, t(x0), 1.0, 0.0, ode_steps, "rk4")


# linear and nonlinear test problems dx/dt = f(t, x), integrated from 1 to 0
# (backwards, so a positive rate decays)
PROBLEMS = {
    "decay": (lambda np_: lambda tt, x: np_.asarray(np.float32([0.5, 2.0, 8.0])) * x, 1.0),
    "stiff": (lambda np_: lambda tt, x: np_.asarray(np.float32([1.0, 30.0, 90.0])) * x, 1.0),
    "rotate": (lambda np_: lambda tt, x: np_.stack([x[..., 1] * 4.0, -x[..., 0] * 4.0,
                                                    x[..., 2] * tt], axis=-1), 2.0),
}


@pytest.mark.parametrize("problem", list(PROBLEMS))
@pytest.mark.parametrize("rtol", [1e-4, 1e-6])
def test_dopri5_matches_jax_with_equal_steps(problem, rtol):
    make, scale = PROBLEMS[problem]
    x0 = (np.random.RandomState(0).randn(4, 3) * scale).astype(np.float32)
    ref, ref_st = jode.odeint_dopri5(make(jnp), jnp.asarray(x0), 1.0, 0.0, rtol=rtol,
                                     atol=rtol, return_stats=True)
    out, st = pode.odeint_dopri5(make(torch), t(x0), 1.0, 0.0, rtol=rtol, atol=rtol,
                                 return_stats=True)
    assert st == {"steps": int(ref_st["steps"]), "reached": bool(ref_st["reached"])}
    assert st["reached"] and st["steps"] > 3
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_dopri5_truncation_warns_and_reports():
    make, _ = PROBLEMS["stiff"]
    x0 = np.ones((2, 3), np.float32)
    ref, ref_st = jode.odeint_dopri5(make(jnp), jnp.asarray(x0), 1.0, 0.0, max_steps=4,
                                     warn_on_truncation=False, return_stats=True)
    with pytest.warns(RuntimeWarning, match="step budget"):
        out, st = pode.odeint_dopri5(make(torch), t(x0), 1.0, 0.0, max_steps=4,
                                     return_stats=True)
    assert st == {"steps": 4, "reached": False} and not bool(ref_st["reached"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pode.odeint_dopri5(make(torch), t(x0), 1.0, 0.0, max_steps=4, warn_on_truncation=False)


def test_dopri5_per_sample_is_the_vmapped_loop():
    """Each set's steps and result are those of the JAX loop run on that set
    alone (what vmap computes lane by lane)."""
    make, _ = PROBLEMS["stiff"]
    x0 = np.random.RandomState(3).randn(5, 2, 3).astype(np.float32)
    x0[1] *= 1e-3  # an easy set: fewer steps
    out, st = pode.odeint_dopri5_per_sample(make(torch), t(x0), 1.0, 0.0, return_stats=True)
    ref = jax.vmap(lambda x: jode.odeint_dopri5(make(jnp), x, 1.0, 0.0,
                                                warn_on_truncation=False))(jnp.asarray(x0))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    for i in range(5):
        _, ref_st = jode.odeint_dopri5(make(jnp), jnp.asarray(x0[i]), 1.0, 0.0,
                                       return_stats=True)
        assert int(st["steps"][i]) == int(ref_st["steps"])
    assert bool(st["reached"].all()) and st["loops"] == int(st["steps"].max())
    assert st["accepted"].shape == (st["loops"], 5)
    assert (st["accepted"].sum(dim=0) <= st["steps"]).all()
    assert len(set(st["steps"].tolist())) > 1


SINCOS = dict(YAML_FLAGSHIP, t_emb="sincos", frequencies=2)
MODELS = {
    "epic": SINCOS,
    "diffusion": dict(SINCOS, loss_type="diffusion", criterion="huber",
                      diff_config={"max_sr": 0.999, "min_sr": 0.02}),
}


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    return model_pair(MODELS[request.param], fill=0.1)


def _close(out, ref):
    np.testing.assert_allclose(out, ref, atol=1e-4 * max(1.0, float(np.abs(ref).max())))


def test_model_dopri5_matches_jax_with_equal_steps(pair):
    jm, variables, pm, net = pair
    _, mask, cond, _ = cloud(b=3, seed=4)
    z = jax_noise(2, (3, 16, 3), mask)
    module, folded = jm.fold_weight_norm(variables)
    drift = jm.make_drift(folded, cond=jnp.asarray(cond), mask=jnp.asarray(mask), flow_idx=0,
                          module=module)
    ref, ref_st = jode.odeint_dopri5(drift, jnp.asarray(z), 1.0, 0.0, rtol=1e-4, atol=1e-4,
                                     return_stats=True)
    ref_sample = np.asarray(jm.sample(variables, jax.random.PRNGKey(2), cond=jnp.asarray(cond),
                                      mask=jnp.asarray(mask), ode_solver="dopri5"))
    stats = []
    out = pm.integrate(net, t(z), t(cond), t(mask), "dopri5", stats=stats).numpy()
    assert stats == [{"steps": int(ref_st["steps"]), "reached": True}]
    _close(out, np.asarray(ref))
    _close(out, ref_sample)
    assert np.abs(out).max() > 0.1


def test_model_dopri5_per_sample_matches_jax(pair):
    jm, variables, pm, net = pair
    _, mask, cond, _ = cloud(b=3, seed=6)
    ref = np.asarray(jm.sample(variables, jax.random.PRNGKey(9), cond=jnp.asarray(cond),
                               mask=jnp.asarray(mask), ode_solver="dopri5_per_sample"))
    module, folded = jm.fold_weight_norm(variables)
    steps = []
    for i in range(3):  # the JAX loop on each set alone: what vmap computes lane by lane
        drift = jm.make_drift(folded, cond=jnp.asarray(cond[i:i + 1]),
                              mask=jnp.asarray(mask[i:i + 1]), flow_idx=0, module=module)
        _, st = jode.odeint_dopri5(drift, jnp.asarray(jax_noise(9, ref.shape, mask)[i:i + 1]),
                                   1.0, 0.0, rtol=1e-4, atol=1e-4, return_stats=True)
        steps.append(int(st["steps"]))
    stats = []
    out = pm.integrate(net, t(jax_noise(9, ref.shape, mask)), t(cond), t(mask),
                       "dopri5_per_sample", stats=stats).numpy()
    assert stats[0]["steps"].tolist() == steps
    _close(out, ref)
