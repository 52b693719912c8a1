"""PyTorch port, the PC-JeDi diffusion schedule (losses/diffusion.py) and
samplers (samplers/sde.py: Euler-Maruyama and DDIM) held against the JAX
package on the CPU, alone on a parameter-free noise model and through
`FlowMatchingModel` at a small width of configs/model/diffusion.yaml.
Euler-Maruyama's per-step noise is the JAX stream, replayed into the port.

Tolerances: schedule atol 1e-6 (relative for beta, which reaches ~150);
samples atol 1e-4; the time grids bit-identical.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.losses.diffusion import VPDiffusionSchedule as JSched
from particle_fm_tpu.samplers import sde as jsde
from particle_fm_tpu_torch.losses.diffusion import VPDiffusionSchedule as PSched
from particle_fm_tpu_torch.samplers import sde as psde
from tests.torch_port_helpers import (YAML_FLAGSHIP, cloud, jax_noise, jax_sde_noise, model_pair,
                                      pin_sde_noise, t)

DIFFUSION = dict(YAML_FLAGSHIP, loss_type="diffusion", criterion="huber",
                 diff_config={"max_sr": 0.999, "min_sr": 0.02})


@pytest.mark.parametrize("max_sr,min_sr", [(1.0, 1e-2), (0.999, 0.02), (1.0, 1e-8)])
def test_schedule_matches_jax(max_sr, min_sr):
    ts = np.linspace(0.0, 1.0, 257).astype(np.float32)
    js, ps = JSched(max_sr, min_sr), PSched(max_sr, min_sr)
    for ref, out in zip(js(jnp.asarray(ts)), ps(t(ts))):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    ref = np.asarray(js.get_betas(jnp.asarray(ts[:-1])))
    out = ps.get_betas(t(ts[:-1])).numpy()
    np.testing.assert_allclose(out / np.abs(ref).max(), ref / np.abs(ref).max(), atol=1e-6)


@pytest.mark.parametrize("n_steps", [1, 7, 200])
def test_sde_time_grids_bit_identical(n_steps):
    """t_k = 1 - f32(k) * (1/n) and DDIM's t_k - 1/n, as the JAX scans round them."""
    step = np.float32(1.0 / n_steps)
    want = np.float32(1.0) - np.arange(n_steps, dtype=np.float32) * step
    seen = []
    sched = PSched(0.999, 0.02)
    psde.ddim_sampler(lambda tt, x: seen.append(tt.clone()) or x, sched, torch.ones(2), n_steps)
    np.testing.assert_array_equal(torch.stack(seen).numpy(), want)
    ts, ts_next, _ = psde._times(n_steps, torch.device("cpu"))
    np.testing.assert_array_equal(ts_next.numpy(), want - step)
    seen.clear()
    psde.euler_maruyama_sampler(lambda tt, x: seen.append(tt.clone()) or x, sched, torch.ones(2),
                                torch.Generator(), n_steps)
    np.testing.assert_array_equal(torch.stack(seen).numpy(), want)


def _noise_models(w):
    """A parameter-free noise prediction of t and x, the same on both sides:
    near the exact one, x / noise_rate, for data at 0, so samples stay at
    unit scale."""
    js, ps = JSched(0.999, 0.02), PSched(0.999, 0.02)
    return (lambda tt, x: 0.9 * x / js(tt)[1] + 0.1 * jnp.tanh(x @ jnp.asarray(w)),
            lambda tt, x: 0.9 * x / ps(tt)[1] + 0.1 * torch.tanh(x @ t(w)))


@pytest.mark.parametrize("solver", ["em", "ddim"])
@pytest.mark.parametrize("n_steps", [5, 40])
def test_samplers_match_jax(monkeypatch, solver, n_steps):
    rs = np.random.RandomState(n_steps)
    w = rs.randn(3, 3).astype(np.float32) * 0.5
    x0 = rs.randn(4, 8, 3).astype(np.float32)
    jmodel, pmodel = _noise_models(w)
    js, ps = JSched(0.999, 0.02), PSched(0.999, 0.02)
    if solver == "em":
        key = jax.random.PRNGKey(n_steps)
        ref = jsde.euler_maruyama_sampler(jmodel, js, jnp.asarray(x0), key, n_steps=n_steps)
        eps = []
        for _ in range(n_steps):
            key, sub = jax.random.split(key)
            eps.append(np.asarray(jax.random.normal(sub, x0.shape)))
        pin_sde_noise(monkeypatch, eps)
        out = psde.euler_maruyama_sampler(pmodel, ps, t(x0), torch.Generator(), n_steps=n_steps)
    else:
        ref = jsde.ddim_sampler(jmodel, js, jnp.asarray(x0), n_steps=n_steps)
        out = psde.ddim_sampler(pmodel, ps, t(x0), n_steps=n_steps)
    ref = np.asarray(ref)
    assert np.isfinite(ref).all() and np.abs(ref).max() > 0.02
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


def test_em_noise_comes_from_the_generator():
    _, pmodel = _noise_models(np.eye(3, dtype=np.float32))
    run = lambda s: psde.euler_maruyama_sampler(
        pmodel, PSched(0.999, 0.02), torch.ones(2, 4, 3), torch.Generator().manual_seed(s), 4)
    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))


@pytest.fixture(scope="module")
def diffusion_pair():
    return model_pair(DIFFUSION, fill=True)


@pytest.mark.parametrize("solver,guidance", [("em", None), ("ddim", None), ("em", 1.5),
                                             ("midpoint", None)])
def test_diffusion_model_samples_as_jax(monkeypatch, diffusion_pair, solver, guidance):
    """sample with em and ddim, and the probability-flow drift under
    midpoint, against the JAX model with its noise replayed."""
    jm, variables, pm, net = diffusion_pair
    _, mask, cond, _ = cloud(b=3, seed=7)
    seed, steps = 5, 6
    with jax.disable_jit():
        ref = np.asarray(jm.sample(variables, jax.random.PRNGKey(seed), cond=jnp.asarray(cond),
                                   mask=jnp.asarray(mask), ode_solver=solver, ode_steps=steps,
                                   guidance_scale=guidance))
    pin_sde_noise(monkeypatch, jax_sde_noise(seed, ref.shape, steps))
    out = pm.integrate(net, t(jax_noise(seed, ref.shape, mask)), t(cond), t(mask), solver,
                       steps, guidance_scale=guidance, generator=torch.Generator()).numpy()
    assert np.isfinite(ref).all() and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_sde_solvers_need_diffusion_and_em_a_generator():
    from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel

    fm = FlowMatchingModel(hidden_dim=8, latent=4, layers=1, num_particles=4)
    net = fm.init(device="cpu")
    for solver in ("em", "ddim"):
        with pytest.raises(ValueError, match="requires diffusion"):
            fm.integrate(net, torch.zeros(1, 4, 3), ode_solver=solver)
    dm = FlowMatchingModel(hidden_dim=8, latent=4, layers=1, num_particles=4,
                           loss_type="diffusion", diff_config=DIFFUSION["diff_config"])
    with pytest.raises(ValueError, match="generator"):
        dm.integrate(dm.init(device="cpu"), torch.zeros(1, 4, 3), ode_solver="em")
    out = dm.sample(dm.init(device="cpu"), torch.Generator(), n_samples=2, ode_solver="em",
                    ode_steps=3)
    assert out.shape == (2, 4, 3) and torch.isfinite(out).all()


@pytest.fixture(scope="module")
def diffusion_run(tmp_path_factory):
    """train.py on experiment=jetnet/diffusion_tops150_cond, narrowed, with
    the shipped jetnet callback (em): (metrics, the em calls' step counts,
    the run directory)."""
    from particle_fm_tpu_torch import train as ptrain
    from particle_fm_tpu_torch.models import flow_matching as pflow

    calls = []
    em = pflow.euler_maruyama_sampler
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pflow, "euler_maruyama_sampler",
                   lambda *a, **k: calls.append(k["n_steps"]) or em(*a, **k))
        metrics, objects = ptrain.main([
            "experiment=jetnet/diffusion_tops150_cond", "data.synthetic=true",
            "data.synthetic_num_jets=256", "trainer=smoke", "trainer.max_epochs=1",
            "model.scheduler.name=constant", "device=cpu", "model.hidden_dim=16",
            "model.layers=2", "model.latent=4", "data.batch_size=64", "model.num_particles=16",
            "callbacks.jetnet_eval.num_jet_samples=100", "callbacks.jetnet_eval.ode_steps=3",
            f"output_dir={tmp_path_factory.mktemp('diffusion_run')}"])
    return metrics, calls, objects["out_dir"]


def test_diffusion_cli_trains_and_evaluates_with_em(diffusion_run):
    """The run's test pass generates with em, the shipped callback's solver."""
    metrics, calls, _ = diffusion_run
    assert calls and set(calls) == {3}
    assert np.isfinite(metrics["w1m_mean"]) and np.isfinite(metrics["val_loss"])


def test_export_cli_exports_the_diffusion_runs_em_bit_for_bit(diffusion_run, tmp_path):
    """scripts/torch_export_model.py on the run exports its evaluation
    solver (em, 3 steps) by default, and --verify holds the artifact bit for
    bit against the live model."""
    import importlib.util
    import os

    import yaml

    from particle_fm_tpu_torch import serving as pserving

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_export_model", os.path.join(root, "scripts", "torch_export_model.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    report = script.main(["--run_dir", diffusion_run[2], "--ckpt", "last", "--batch_size", "8",
                          "--out", str(tmp_path), "--device", "cpu", "--verify"])
    assert report["bytes"] > 0 and report["sets_per_s"] > 0
    with open(tmp_path / pserving.META_NAME) as f:
        meta = yaml.safe_load(f)
    assert (meta["ode_solver"], meta["ode_steps"], meta["platforms"]) == ("em", 3, ["cpu"])
    assert meta["step_noise"]["shape"] == [3, 8, 16, 3]
