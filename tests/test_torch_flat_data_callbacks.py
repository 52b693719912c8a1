"""PyTorch port, the flat models' data and callbacks held against the JAX
package: `GenChallengeDataModule` (particle_fm_tpu_torch/data/
gen_challenge.py) split for split and twin for twin, bit for bit, with the
logit transform on and off; `FlatEvalCallback` and `GenChallengeEvalCallback`
(eval/callbacks.py) on the same generated vectors: the JAX parameters
carried, the noise of every generation batch replayed from the JAX key
stream and both bootstrap generators pinned, every metric within 1e-5
relative and the written figures' file names the same. Then the flat
experiments through the training entry point on the CPU.
"""

from __future__ import annotations

import os
import types

import jax
import numpy as np
import pytest
import torch

from particle_fm_tpu.data.gen_challenge import GenChallengeDataModule as JaxGC
from particle_fm_tpu.data.lhco import LHCOJetFeatureDataModule as JaxJF
from particle_fm_tpu.eval import callbacks as jcb
from particle_fm_tpu.eval import metrics as jmetrics
from particle_fm_tpu.models.flow_matching_flat import FlatFlowMatchingModel as JaxFlat
from particle_fm_tpu_torch import train as ptrain
from particle_fm_tpu_torch.data.gen_challenge import GenChallengeDataModule
from particle_fm_tpu_torch.data.lhco import LHCOJetFeatureDataModule
from particle_fm_tpu_torch.eval import callbacks as pcb
from particle_fm_tpu_torch.eval import metrics as pmetrics
from particle_fm_tpu_torch.models import flow_matching_flat as pflat
from particle_fm_tpu_torch.serving import chunk_seed
from particle_fm_tpu_torch.training.step import TrainState
from particle_fm_tpu_torch.utils.from_jax import load_flax_params
from tests.torch_port_helpers import t

RTOL = 1e-5
ARRAYS = ("means", "stds", "cond_means", "cond_stds")


def split_arrays(dm) -> dict:
    out = {k: getattr(dm, k) for k in ARRAYS}
    for name in ("train", "val", "test"):
        out[f"{name}.x"], out[f"{name}.cond"] = getattr(dm, name).x, getattr(dm, name).cond
        assert getattr(dm, name).mask is None
        for pre in ("tensor_", "tensor_conditioning_"):
            for sr in ("", "_sr"):
                out[f"{pre}{name}{sr}"] = getattr(dm, f"{pre}{name}{sr}")
    return out


@pytest.mark.parametrize("logit", [True, False], ids=["logit", "no-logit"])
def test_gen_challenge_splits_equal_jax_bit_for_bit(logit):
    kw = dict(synthetic=True, synthetic_num_events=1000, logit_transform=logit, seed=3,
              val_sets=(1,), test_sets=(4,))
    jdm, pdm = JaxGC(**kw), GenChallengeDataModule(**kw)
    jdm.setup()
    pdm.setup()
    want, got = split_arrays(jdm), split_arrays(pdm)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(pdm.train) == 600 and pdm.steps_per_epoch == 600 // pdm.batch_size
    # the test features stay in the transformed (unnormalised) units, its mjj is normalised
    np.testing.assert_array_equal(pdm.test.x, pdm.tensor_test)
    assert abs(float(pdm.tensor_conditioning_test.mean())) < 10
    if logit:  # the transformed features lie within logit(0.01), logit(0.99)
        assert np.abs(pdm.tensor_train).max() <= np.log(0.99 / 0.01) + 1e-5
    batches = list(pdm.train_batches(seed=1))
    assert all(m is None and c.shape == (pdm.batch_size, 1) for _, m, c in batches)


def flat_setup(dm_cls, jdm_cls, features, dm_kw):
    jdm, pdm = jdm_cls(**dm_kw), dm_cls(**dm_kw)
    jdm.setup()
    pdm.setup()
    jm = JaxFlat(features=features, cond_dim=1)
    variables = jm.init(jax.random.PRNGKey(0))
    pm = pflat.FlatFlowMatchingModel(features=features, cond_dim=1)
    net = load_flax_params(pm.init(device="cpu"), jax.device_get(variables["params"]))
    return jm, variables, jdm, pm, net, pdm


def trainers(setup, tmp_path, testing=True):
    jm, variables, jdm, pm, net, pdm = setup
    jstate = types.SimpleNamespace(variables=lambda ema: variables)
    jt = types.SimpleNamespace(model=jm, datamodule=jdm, state=jstate, epoch=0, testing=testing,
                               log_dir=None, artifacts_dir=str(tmp_path / "jax"))
    pstate = TrainState(net=net, ema_params=[p.detach().clone() for p in net.parameters()],
                        opt_state=None)
    pt = types.SimpleNamespace(model=pm, datamodule=pdm, state=pstate, epoch=0, testing=testing,
                               log_dir=None, device=torch.device("cpu"),
                               artifacts_dir=str(tmp_path / "port"))
    return jt, pt


def replay_flat_noise(monkeypatch, seed):
    """The port's generation batch i draws the noise that the JAX callback's
    i-th key (split in turn from PRNGKey(seed)) draws."""
    keys, rng = {}, jax.random.PRNGKey(seed)
    for i in range(32):
        rng, sub = jax.random.split(rng)
        keys[chunk_seed(seed, i)] = sub
    monkeypatch.setattr(pflat, "draw_noise", lambda g, shape, device: t(
        np.asarray(jax.random.normal(keys[g.initial_seed()], shape))).to(device))


def pin_bootstrap(monkeypatch):
    monkeypatch.setattr(jmetrics, "_rng", np.random.default_rng(5))
    monkeypatch.setattr(pmetrics, "_rng", np.random.default_rng(5))


def held(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if not k.endswith("generation_time"):
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=0, err_msg=k)


def pngs(path):
    return sorted(os.listdir(path)) if os.path.isdir(path) else []


@pytest.fixture(scope="module")
def gc_setup():
    return flat_setup(GenChallengeDataModule, JaxGC, 4,
                      dict(synthetic=True, synthetic_num_events=600, logit_transform=True))


@pytest.mark.parametrize("split,prefix", [("val", ""), ("val_sr", "sr_")])
def test_gen_challenge_callback_matches_jax(gc_setup, tmp_path, monkeypatch, split, prefix):
    jt, pt = trainers(gc_setup, tmp_path)
    replay_flat_noise(monkeypatch, 9999)
    kw = dict(num_samples=50, generation_batch_size=16, ode_steps=4, w1_num_batches=4,
              split=split, metric_prefix=prefix)
    pin_bootstrap(monkeypatch)
    want = jcb.GenChallengeEvalCallback(**kw)(jt)
    pin_bootstrap(monkeypatch)
    got = pcb.GenChallengeEvalCallback(**kw)(pt)
    held(got, want)
    assert f"{prefix}w1_delta_mj_mean" in got and got[f"{prefix}generation_time"] > 0
    assert pngs(tmp_path / "port" / "callback_images") == pngs(
        tmp_path / "jax" / "callback_images") == [f"{prefix}features_epoch0.png"]


@pytest.mark.parametrize("make_plots", [False, True])
def test_flat_callback_matches_jax(tmp_path, monkeypatch, make_plots):
    setup = flat_setup(LHCOJetFeatureDataModule, JaxJF, 10,
                       dict(synthetic=True, synthetic_num_events=800, synthetic_num_particles=30))
    jt, pt = trainers(setup, tmp_path)
    replay_flat_noise(monkeypatch, 9999)
    kw = dict(num_samples=40, generation_batch_size=32, ode_steps=3, w1_num_batches=4,
              make_plots=make_plots, plot_cond=True)
    pin_bootstrap(monkeypatch)
    want = jcb.FlatEvalCallback(**kw)(jt)
    pin_bootstrap(monkeypatch)
    got = pcb.FlatEvalCallback(**kw)(pt)
    held(got, want)
    assert len(got) == 2 * 10 + 2 and np.isfinite(got["w1_features_mean"])
    assert pngs(tmp_path / "port" / "callback_images") == pngs(
        tmp_path / "jax" / "callback_images") == (["features_epoch0.png"] if make_plots else [])


def test_epoch_gates_match_jax(gc_setup, tmp_path):
    jt, pt = trainers(gc_setup, tmp_path, testing=False)
    ran = {"jax": [], "port": []}
    for epoch in range(12):
        for tr, side, mod in ((jt, "jax", jcb), (pt, "port", pcb)):
            tr.epoch = epoch
            cb = mod.FlatEvalCallback(every_n_epochs=5, num_samples=4, generation_batch_size=4,
                                      ode_steps=2, w1_num_batches=2, split="val")
            if cb(tr) is not None:
                ran[side].append(epoch)
    assert ran["port"] == ran["jax"] == [5, 10]


@pytest.mark.parametrize("experiment,cb_key", [("lhco/jet_features", "flat_eval"),
                                               ("gen_challenge/gen_challenge",
                                                "gen_challenge_eval")])
def test_flat_experiments_train_through_the_cli(tmp_path, experiment, cb_key):
    over = [f"experiment={experiment}", "data.synthetic=true", "trainer=smoke",
            "trainer.max_epochs=2", "device=cpu", f"callbacks.{cb_key}.num_samples=64",
            f"callbacks.{cb_key}.ode_steps=3", f"callbacks.{cb_key}.every_n_epochs=1",
            f"output_dir={tmp_path}"]
    if experiment.startswith("lhco"):
        over += ["data.synthetic_num_events=1500", "data.batch_size=128"]
    else:
        over += ["callbacks.gen_challenge_eval_sr.num_samples=64",
                 "callbacks.gen_challenge_eval_sr.ode_steps=3"]
    metrics, objs = ptrain.main(over)
    trainer = objs["trainer"]
    assert isinstance(trainer.model, pflat.FlatFlowMatchingModel)
    assert len(trainer.metrics_history) == 2 and np.isfinite(metrics["w1_features_mean"])
    assert all(np.isfinite(m["val_loss"]) for m in trainer.metrics_history)
    ckpts = os.listdir(os.path.join(objs["out_dir"], "checkpoints"))
    assert "last.pt" in ckpts
    if experiment.startswith("gen"):
        assert np.isfinite(metrics["sr_w1_features_mean"])
        assert "sr_features_epoch0.png" in os.listdir(
            os.path.join(objs["out_dir"], "callback_images"))
