"""PyTorch port, the LHCO two-stage generation chain
(particle_fm_tpu_torch/lhco_chain.py) held against the JAX package's
scripts/generate_data_lhco.py run end to end at a tiny size: the script's
`load_run` hands it narrow JAX models (the flat stage-1 model and EPiC
constituent models for the x and the y jet) on the synthetic LHCO
datamodules, and the port runs the same weights, carried across, on the
port's datamodules. The noise of every stage-1 batch and every stage-2
batch is replayed from the JAX key streams, the bootstrap generators are
pinned. The h5 files hold the same keys; the stage-1 features, the
constituents of both jets, the masks and the reclustered jets agree within
1e-4 of each array's largest magnitude, the metrics within 1e-4 relative.
Then the port's CLI from run directories, and that it asks for h5py first.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import h5py
import jax
import numpy as np
import pytest
import yaml

from particle_fm_tpu.data.lhco import LHCODataModule as JaxLHCO
from particle_fm_tpu.data.lhco import LHCOJetFeatureDataModule as JaxJF
from particle_fm_tpu.eval import generation as jgen
from particle_fm_tpu.eval import metrics as jmetrics
from particle_fm_tpu.models.flow_matching import FlowMatchingModel as JaxModel
from particle_fm_tpu.models.flow_matching_flat import FlatFlowMatchingModel as JaxFlat
from particle_fm_tpu_torch import lhco_chain
from particle_fm_tpu_torch.data.lhco import LHCODataModule, LHCOJetFeatureDataModule
from particle_fm_tpu_torch.eval import metrics as pmetrics
from particle_fm_tpu_torch.models import flow_matching as pfm
from particle_fm_tpu_torch.models import flow_matching_flat as pflat
from particle_fm_tpu_torch.serving import chunk_seed
from particle_fm_tpu_torch.utils.from_jax import load_flax_params
from tests.torch_port_helpers import WritableNumpy, jax_noise_of_batch, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, EVENTS, BATCH, STEPS = 16, 40, 16, 4
EPIC = dict(model="epic", features=3, num_particles=N, hidden_dim=16, latent=4, layers=2,
            frequencies=4, t_emb="sincos", global_cond_dim=4, local_cond_dim=4,
            t_global_cat=True, t_local_cat=True, add_time_to_input=False)


def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_generate_data_lhco", os.path.join(ROOT, "scripts", "generate_data_lhco.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def runs():
    """{run name: (JAX (cfg, dm, model, variables), port Stage)} with the same weights."""
    out = {}
    jf_kw = dict(synthetic=True, synthetic_num_events=3000, synthetic_num_particles=N)
    jdm, pdm = JaxJF(**jf_kw), LHCOJetFeatureDataModule(**jf_kw)
    jm = JaxFlat(features=10, cond_dim=1)
    variables = jm.init(jax.random.PRNGKey(0))
    pm = pflat.FlatFlowMatchingModel(features=10, cond_dim=1)
    net = load_flax_params(pm.init(device="cpu"), jax.device_get(variables["params"]))
    out["stage1"] = (jdm, jm, variables), (pdm, pm, net)
    for seed, jet in ((1, "x"), (2, "y")):
        kw = dict(jet_type=jet, num_particles=N, synthetic=True, synthetic_num_events=3000)
        jdm, pdm = JaxLHCO(**kw), LHCODataModule(**kw)
        jm = JaxModel(**EPIC)
        variables = jm.init(jax.random.PRNGKey(seed))
        pm = pfm.FlowMatchingModel(**EPIC)
        net = load_flax_params(pm.init(device="cpu"), jax.device_get(variables["params"]))
        out[jet] = (jdm, jm, variables), (pdm, pm, net)
    for (jdm, *_), (pdm, *_) in out.values():
        jdm.setup()
        pdm.setup()
    return out


def pin_noise(monkeypatch):
    """Stage 1: batch i draws what the JAX script's i-th split key draws;
    stage 2: what the JAX generate_data's batch i draws from PRNGKey(0)."""
    keys, rng = {}, jax.random.PRNGKey(0)
    for i in range(8):
        rng, sub = jax.random.split(rng)
        keys[chunk_seed(0, i)] = sub
    monkeypatch.setattr(pflat, "draw_noise", lambda g, shape, device: t(
        np.asarray(jax.random.normal(keys[g.initial_seed()], shape))).to(device))
    batches = {chunk_seed(0, i): i for i in range(8)}
    monkeypatch.setattr(pfm, "draw_noise", lambda g, shape, device: t(
        jax_noise_of_batch(0, batches[g.initial_seed()], shape)).to(device))
    monkeypatch.setattr(jgen, "np", WritableNumpy())


def close_of_largest(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0 and np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


@pytest.fixture(scope="module")
def both():
    return runs()


def test_chain_matches_the_jax_script(both, tmp_path, monkeypatch):
    script = jax_script()
    jax_runs = {"s1": both["stage1"][0], "s2": both["x"][0], "s2y": both["y"][0]}
    monkeypatch.setattr(script, "load_run", lambda run_dir, ckpt="best": (
        {}, *jax_runs[os.path.basename(run_dir)]))
    pin_noise(monkeypatch)
    args = ["--n_samples", str(EVENTS), "--ode_steps", str(STEPS), "--batch_size", str(BATCH),
            "--recluster", "--metrics"]
    out = str(tmp_path / "jax.h5")
    monkeypatch.setattr(sys, "argv", ["generate_data_lhco.py", "--stage1_run", "s1",
                                      "--stage2_run", "s2", "--stage2_run_y", "s2y",
                                      "--out", out] + args)
    monkeypatch.setattr(jmetrics, "_rng", np.random.default_rng(3))
    script.main()
    with h5py.File(out, "r") as f:
        want = {k: np.asarray(f[k]) for k in f.keys()}

    stages = {k: lhco_chain.Stage(*both[k][1][1:], both[k][1][0]) for k in ("stage1", "x", "y")}
    payload, timings = lhco_chain.generate_lhco_events(
        stages["stage1"], stages["x"], stages["y"], n_samples=EVENTS, ode_steps=STEPS,
        batch_size=BATCH, recluster=True)
    assert sorted(payload) == sorted(want) == sorted([
        "jet_features", "constituents", "mask", "mjj_cond", "constituents_y", "mask_y",
        "clustered_jets", "clustered_constituents", "clustered_mask"])
    np.testing.assert_array_equal(payload["mjj_cond"], want["mjj_cond"])
    np.testing.assert_array_equal(payload["mask"], want["mask"])
    np.testing.assert_array_equal(payload["mask_y"], want["mask_y"])
    np.testing.assert_array_equal(payload["clustered_mask"], want["clustered_mask"])
    for k in ("jet_features", "constituents", "constituents_y", "clustered_jets",
              "clustered_constituents"):
        close_of_largest(payload[k], want[k])
    assert payload["mask"].sum() > EVENTS and timings["stage1_s"] > 0
    # the padded particles of the generated jets are zero
    assert (payload["constituents"][payload["mask"][..., 0] == 0] == 0).all()

    monkeypatch.setattr(pmetrics, "_rng", np.random.default_rng(3))
    metrics = lhco_chain.chain_metrics(payload, stages["stage1"], stages["x"])
    with open(str(tmp_path / "jax_metrics.yaml")) as f:
        want_metrics = yaml.safe_load(f)
    assert metrics.keys() == want_metrics.keys()
    for k, v in want_metrics.items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-4, err_msg=k)

    path = str(tmp_path / "port.h5")
    lhco_chain.write_h5(payload, path)
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == sorted(want)
        np.testing.assert_array_equal(np.asarray(f["constituents"]), payload["constituents"])


def test_one_model_for_both_jets_and_no_recluster(both, monkeypatch):
    pin_noise(monkeypatch)
    stages = {k: lhco_chain.Stage(*both[k][1][1:], both[k][1][0]) for k in ("stage1", "x")}
    payload, _ = lhco_chain.generate_lhco_events(stages["stage1"], stages["x"],
                                                 n_samples=EVENTS, ode_steps=STEPS,
                                                 batch_size=BATCH)
    assert sorted(payload) == ["constituents", "jet_features", "mask", "mjj_cond"]
    jets2 = payload["jet_features"].reshape(EVENTS, 2, 5)
    counts = np.clip(np.round(jets2[:, 0, 4]).astype(int), 1, N)
    np.testing.assert_array_equal(payload["mask"][..., 0].sum(-1), counts)


def test_cli_from_run_directories(tmp_path, monkeypatch):
    """Train the three runs through train.py (2 steps each), then the CLI."""
    from particle_fm_tpu_torch import train as ptrain

    dirs = {}
    for name, exp, extra in (
            ("stage1", "lhco/jet_features", ["callbacks=none", "data.batch_size=256",
                                             f"data.synthetic_num_particles={N}"]),
            ("x", "lhco/x_jet", ["callbacks=none", f"model.num_particles={N}",
                                 "model.hidden_dim=8", "model.latent=2", "model.layers=1",
                                 "data.batch_size=256"])):
        _, objs = ptrain.main([f"experiment={exp}", "data.synthetic=true", "trainer=smoke",
                               "trainer.max_epochs=1", "device=cpu", "test=false",
                               "data.synthetic_num_events=1500", f"output_dir={tmp_path / name}",
                               *extra])
        dirs[name] = objs["out_dir"]
    out = str(tmp_path / "gen.h5")
    payload = lhco_chain.main(["--stage1_run", dirs["stage1"], "--stage2_run", dirs["x"],
                               "--n_samples", "10", "--ode_steps", "3", "--batch_size", "8",
                               "--out", out, "--device", "cpu"])
    with h5py.File(out, "r") as f:
        assert sorted(f.keys()) == sorted(payload)
    assert payload["constituents"].shape == (10, N, 3)
    assert np.isfinite(payload["constituents"]).all()
    with pytest.raises(SystemExit, match="--metrics requires --recluster"):
        lhco_chain.main(["--stage1_run", "a", "--stage2_run", "b", "--metrics"])
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        lhco_chain.main(["--stage1_run", dirs["stage1"], "--stage2_run", dirs["x"],
                         "--device", "cpu"])
