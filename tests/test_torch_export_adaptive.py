"""PyTorch port, the served artifact (particle_fm_tpu_torch/serving.py) of
the DOPRI5 solvers: `dopri5` and `dopri5_zuko` (one step size for the
batch) and `dopri5_per_sample` (one a set), each one `while_loop` on the
device whose test is the JAX loop's (samplers/ode.py::exported_loops). The
narrow flagship of tests/test_torch_export.py (EPiC, 2 layers, B=3, N=16)
with the sincos time embedding: with the cosine one a field is a chaotic
function of t in float32 and one ulp moves every later step decision
(ROADMAP Queue 3 item 1). On the CPU:

- the loaded artifact gives what `make_serve_fn` gives for the same seeds,
  bit for bit (`torch.equal`), with cond and mask, and reports the live
  run's attempts (`fn.stats`);
- given the JAX package's prior, it holds against the JAX loop (jitted, as
  the JAX sampler runs it) within atol 1e-4 in physical units, with the same
  attempt count (per set for `dopri5_per_sample`);
- an artifact whose step budget runs out warns as the live solver warns.
"""

from __future__ import annotations

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.samplers import ode as jode
from particle_fm_tpu_torch import serving as pserving
from particle_fm_tpu_torch.models import flow_matching as pflow
from particle_fm_tpu_torch.samplers import ode as pode
from tests.torch_port_helpers import YAML_FLAGSHIP, cloud, jax_noise, model_pair, t

BS, N = 3, 16
MEANS = np.array([0.1, -0.2, 0.3], np.float32)
STDS = np.array([1.5, 0.5, 2.0], np.float32)
SINCOS = dict(YAML_FLAGSHIP, t_emb="sincos", frequencies=2)
SOLVERS = ["dopri5", "dopri5_zuko", "dopri5_per_sample"]


@pytest.fixture(scope="module")
def pair():
    return model_pair(SINCOS, fill=0.1)


def _export(pm, net, solver, out_dir):
    return pserving.export_sampler(
        pm, net, batch_size=BS, num_points=N, features=3, cond_dim=2, use_mask=True,
        ode_solver=solver, means=MEANS, stds=STDS, device="cpu", out_dir=str(out_dir))[1]


@pytest.fixture(scope="module")
def artifacts(pair, tmp_path_factory):
    """solver -> (meta, (fn, meta) of load_exported), each exported and
    loaded once."""
    cache = {}

    def get(solver):
        if solver not in cache:
            out = tmp_path_factory.mktemp(solver)
            meta = _export(*pair[2:], solver, out)
            cache[solver] = (meta, pserving.load_exported(str(out)))
        return cache[solver]

    return get


def _physical(x, mask):
    return (x * (STDS / 5.0) + MEANS) * mask


@pytest.mark.parametrize("solver", SOLVERS)
def test_artifact_is_make_serve_fn_bit_for_bit(pair, artifacts, solver):
    _, _, pm, net = pair
    meta, (fn, loaded) = artifacts(solver)
    assert loaded == meta and "step_noise" not in meta
    live = pserving.make_serve_fn(pm, net, batch_size=BS, ode_solver=solver, has_cond=True,
                                  has_mask=True, means=MEANS, stds=STDS)
    _, m, c, _ = cloud(b=BS, n=N, seed=1)
    for seed in (0, 7, 2**40 + 3):
        got, want = fn(seed, c, m), live(seed, c, m)
        assert got.shape == (BS, N, 3) and torch.equal(got, want), seed
        stats = []
        pm.sample(net, torch.Generator().manual_seed(seed), cond=t(c), mask=t(m),
                  ode_solver=solver, stats=stats)
        (st,), (st_live,) = fn.stats, stats
        assert torch.equal(torch.as_tensor(st["steps"]), torch.as_tensor(st_live["steps"]))
        assert bool(torch.as_tensor(st["reached"]).all())
        if solver == "dopri5_per_sample":
            assert int(st["loops"]) == st_live["loops"]


@pytest.mark.parametrize("solver", ["dopri5", "dopri5_per_sample"])
def test_artifact_matches_jax_with_the_same_steps(pair, artifacts, solver, monkeypatch):
    jm, variables, _, _ = pair
    _, mask, cond, _ = cloud(b=BS, n=N, seed=4)
    seed = 2
    z = jax_noise(seed, (BS, N, 3))
    module, folded = jm.fold_weight_norm(variables)
    kw = dict(rtol=1e-4, atol=1e-4, return_stats=True)
    if solver == "dopri5":
        drift = jm.make_drift(folded, cond=jnp.asarray(cond), mask=jnp.asarray(mask),
                              flow_idx=0, module=module)
        ref, st = jax.jit(lambda z0: jode.odeint_dopri5(drift, z0, 1.0, 0.0, **kw))(
            jnp.asarray(z * mask))
    else:  # the JAX sampler's vmap over the loop, with its statistics kept
        def one(x1, c1, m1):
            d = jm.make_drift(folded, cond=c1[None], mask=m1[None], flow_idx=0, module=module)
            return jode.odeint_dopri5(lambda tt, xs: d(tt, xs[None])[0], x1, 1.0, 0.0,
                                      warn_on_truncation=False, **kw)

        ref, st = jax.jit(jax.vmap(one))(jnp.asarray(z * mask), jnp.asarray(cond),
                                         jnp.asarray(mask))
    fn = artifacts(solver)[1][0]
    monkeypatch.setattr(pserving, "prior_noise", lambda s, shape, dev: t(jax_noise(s, shape)))
    out = fn(seed, cond, mask).numpy()
    np.testing.assert_allclose(out, _physical(np.asarray(ref), mask), atol=1e-4)
    assert np.abs(out).max() > 0.1
    assert np.asarray(fn.stats[0]["steps"]).tolist() == np.asarray(st["steps"]).tolist()


def test_artifact_whose_step_budget_runs_out_warns(pair, tmp_path, monkeypatch):
    _, _, pm, net = pair
    monkeypatch.setattr(pflow, "odeint_dopri5", functools.partial(pode.odeint_dopri5,
                                                                  max_steps=2))
    _export(pm, net, "dopri5", tmp_path)
    live = pserving.make_serve_fn(pm, net, batch_size=BS, ode_solver="dopri5", has_cond=True,
                                  has_mask=True, means=MEANS, stds=STDS)
    _, m, c, _ = cloud(b=BS, n=N, seed=3)
    with pytest.warns(RuntimeWarning, match=r"step budget \(2\) exhausted") as live_w:
        want = live(5, c, m)
    fn, _ = pserving.load_exported(str(tmp_path))
    with pytest.warns(RuntimeWarning, match=r"step budget \(2\) exhausted") as got_w:
        got = fn(5, c, m)
    assert torch.equal(got, want)
    assert [str(w.message) for w in got_w] == [str(w.message) for w in live_w]
    (st,) = fn.stats
    assert int(st["steps"]) == 2 and not bool(st["reached"])


def test_artifact_that_reaches_t0_is_silent(artifacts):
    fn = artifacts("dopri5")[1][0]
    _, m, c, _ = cloud(b=BS, n=N, seed=3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fn(5, c, m)
    assert bool(fn.stats[0]["reached"])
