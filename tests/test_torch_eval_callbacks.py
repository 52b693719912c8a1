"""PyTorch port, the JetNet eval callbacks (particle_fm_tpu_torch/eval/
callbacks.py) held against the JAX package's end to end: a narrow flagship
with carried JAX weights, the synthetic JetNet datamodule, the noise of
every generation batch replayed from the JAX key stream (as in
tests/test_torch_eval_generation.py) and both bootstrap generators pinned to
one seed. `JetNetEvalCallback` (W1M/W1P/W1EFP over a ragged last batch) and
`FinalEvalCallback` with its plots off (W1s, substructure W1s, FPD/KPD on
the EFPs, the saved samples and metrics): every metric within 1e-4
relative. Also the epoch gates, `_tile_to`, the cond_path conditioning, that
the callback samples a copy (the trainer's network stays unfolded and
untouched), and that `FinalEvalCallback` with its plots on writes the JAX
callback's figures.
"""

from __future__ import annotations

import os

import types

import jax
import numpy as np
import pytest
import torch
import yaml

from particle_fm_tpu.eval import callbacks as jcb
from particle_fm_tpu.eval import generation as jgen
from particle_fm_tpu.eval import metrics as jmetrics
from particle_fm_tpu_torch.data.jetnet import JetNetDataModule
from particle_fm_tpu_torch.eval import callbacks as pcb
from particle_fm_tpu_torch.eval import metrics as pmetrics
from particle_fm_tpu_torch.models import flow_matching as pfm
from particle_fm_tpu_torch.serving import chunk_seed
from particle_fm_tpu_torch.training.step import TrainState
from tests.torch_port_helpers import (
    YAML_FLAGSHIP,
    WritableNumpy,
    jax_noise_of_batch,
    model_pair,
    t,
)

RTOL = 1e-4
KW = dict(num_jet_samples=40, generation_batch_size=16, ode_steps=3, calculate_efps=True,
          w1_kwargs=dict(num_batches=4, num_eval_samples=30))


@pytest.fixture(scope="module")
def setup():
    jm, variables, pm, net = model_pair(YAML_FLAGSHIP)
    dm = JetNetDataModule(jet_type=("t",), num_particles=16, conditioning_type=False,
                          conditioning_eta=False, conditioning_num_particles=False,
                          centering=False, synthetic=True, synthetic_num_jets=300)
    dm.setup()
    return jm, variables, pm, net, dm


def trainers(setup, tmp_path, epoch=0, testing=False):
    jm, variables, pm, net, dm = setup
    jstate = types.SimpleNamespace(variables=lambda ema: variables)
    jtrainer = types.SimpleNamespace(model=jm, datamodule=dm, state=jstate, epoch=epoch,
                                     testing=testing, log_dir=None,
                                     artifacts_dir=str(tmp_path / "jax"))
    pstate = TrainState(net=net, ema_params=[p.detach().clone() for p in net.parameters()],
                        opt_state=None)
    ptrainer = types.SimpleNamespace(model=pm, datamodule=dm, state=pstate, epoch=epoch,
                                     testing=testing, log_dir=None, device=torch.device("cpu"),
                                     artifacts_dir=str(tmp_path / "port"))
    return jtrainer, ptrainer


def replay_noise(monkeypatch, seed):
    batches = {chunk_seed(seed, i): i for i in range(64)}
    monkeypatch.setattr(pfm, "draw_noise", lambda g, shape, device: t(
        jax_noise_of_batch(seed, batches[g.initial_seed()], shape)).to(device))
    monkeypatch.setattr(jgen, "np", WritableNumpy())


def pin_bootstrap(monkeypatch):
    monkeypatch.setattr(jmetrics, "_rng", np.random.default_rng(5))
    monkeypatch.setattr(pmetrics, "_rng", np.random.default_rng(5))


def assert_metrics_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if k == "generation_time":
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=0, err_msg=k)


def test_jetnet_callback_matches_jax(setup, tmp_path, monkeypatch):
    jt, pt = trainers(setup, tmp_path, testing=True)
    replay_noise(monkeypatch, 9999)
    pin_bootstrap(monkeypatch)
    with jax.disable_jit():
        want = jcb.JetNetEvalCallback(**KW)(jt)
    net = pt.state.net
    before = [p.detach().clone() for p in net.parameters()]
    got = pcb.JetNetEvalCallback(**KW)(pt)
    assert_metrics_close(got, want)
    assert got["w1efp_mean"] > 0 and got["generation_time"] > 0
    assert not pfm.is_folded(net)
    for p, q in zip(net.parameters(), before):
        assert torch.equal(p, q)


def test_final_callback_matches_jax(setup, tmp_path, monkeypatch):
    jt, pt = trainers(setup, tmp_path, testing=True)
    replay_noise(monkeypatch, 9999)
    pin_bootstrap(monkeypatch)
    kw = dict(KW, make_plots=False)
    with jax.disable_jit():
        want = jcb.FinalEvalCallback(**kw)(jt)
    got = pcb.FinalEvalCallback(**kw)(pt)
    assert {"w1_tau21_mean", "w1_d2_mean", "fpd", "kpd_median"} <= got.keys()
    assert_metrics_close(got, want)
    out = tmp_path / "port"
    np.testing.assert_allclose(np.load(out / "final_generated_data.npy"),
                               np.load(tmp_path / "jax" / "final_generated_data.npy"), atol=1e-4)
    saved = yaml.safe_load((out / "final_eval_metrics.yml").read_text())
    assert saved == pytest.approx({k: float(v) for k, v in got.items()})


def test_final_callback_plots_raise(setup, tmp_path, monkeypatch):
    """The plots are ported and raise no more: with make_plots (the
    default) the callback gives the JAX callback's metrics and writes the
    same figures beside the same arrays."""
    jt, pt = trainers(setup, tmp_path, testing=True)
    replay_noise(monkeypatch, 9999)
    pin_bootstrap(monkeypatch)
    kw = dict(KW, calculate_efps=False, compute_fpd_kpd=False)
    assert pcb.FinalEvalCallback().make_plots
    with jax.disable_jit():
        want = jcb.FinalEvalCallback(**kw)(jt)
    got = pcb.FinalEvalCallback(**kw)(pt)
    assert_metrics_close(got, want)
    files = [sorted(os.listdir(tmp_path / side)) for side in ("port", "jax")]
    assert files[0] == files[1] == sorted([
        "final_comparison.png", "final_eval_metrics.yml", "final_generated_data.npy",
        "single_jets_gen.png", "single_jets_real.png", "substructure.png"])


@pytest.mark.parametrize("every,zero", [(3, False), (3, True), ("custom1", False)])
def test_epoch_gates_match_jax(setup, tmp_path, every, zero):
    for epoch in range(12):
        for testing in (False, True):
            jt, pt = trainers(setup, tmp_path, epoch=epoch, testing=testing)
            assert pcb.JetNetEvalCallback(every_n_epochs=every, log_epoch_zero=zero)._should_run(
                pt) == jcb.JetNetEvalCallback(every_n_epochs=every,
                                              log_epoch_zero=zero)._should_run(jt)


def test_tile_and_cond_path_match_jax(setup, tmp_path):
    h5py = pytest.importorskip("h5py")
    dm = setup[4]
    a = np.arange(12.0).reshape(6, 2)
    for n in (4, 6, 13):
        np.testing.assert_array_equal(pcb._tile_to(a, n), jcb._tile_to(a, n))
    assert pcb._tile_to(None, 3) is None
    rs = np.random.RandomState(3)
    path = tmp_path / "cond.h5"
    with h5py.File(path, "w") as f:
        f["pt"] = rs.uniform(800, 1600, 9)
        f["mass"] = rs.uniform(50, 200, 9)
        f["num_particles"] = rs.randint(1, 30, (9, 1))
    real, mask, cond = dm.tensor_test, dm.mask_test, dm.tensor_conditioning_test
    got = pcb.JetNetEvalCallback(cond_path=str(path))._gen_conditioning(dm, cond, mask, 20)
    want = jcb.JetNetEvalCallback(cond_path=str(path))._gen_conditioning(dm, cond, mask, 20)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
