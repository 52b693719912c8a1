"""PyTorch port, the training entry point on the LHCO, JetClass and
CaloChallenge experiments, on the CPU at narrow widths with synthetic data:
`lhco/bigPC`, `lhco/whole_event`, `lhco/jet_features_set`,
`jetclass/jetclass_cond` (in-memory synthetic splits, no h5 file) and
`calo/mdma_calo` (bucketed host batches on the Trainer's streaming path).

Each trains 2 epochs with the experiment's callbacks run every epoch (tiny
sample counts) and `test: true`, and writes metrics.jsonl and
final_metrics.yaml with the keys its callbacks and trainer options give;
`evaluate` runs the callbacks again on the best checkpoint into
final_eval_metrics.yaml (the same keys) and `eval_ckpt` samples the test
split's masks and conditioning into eval_metrics.yaml.
Resumed from its `last` checkpoint for a third epoch (callbacks off), it
ends exactly where one uninterrupted 3-epoch run ends. The CaloChallenge
runs take `data.rotate_alpha=false`: with the rotation, each epoch's
dequantisation noise comes from the scaler's one stream, which a new
process starts afresh, so a resumed run draws other noise than an
uninterrupted one, in the JAX package as in the port.
"""

from __future__ import annotations

import json
import os

import pytest
import torch
import yaml

from particle_fm_tpu_torch import eval_ckpt as peval_ckpt
from particle_fm_tpu_torch import evaluate as pevaluate
from particle_fm_tpu_torch import train as ptrain

EPIC = ["model.hidden_dim=16", "model.latent=4", "model.layers=2"]
W1 = ["w1_kwargs.num_eval_samples=32", "w1_kwargs.num_batches=2"]


def callback(name: str, *settings: str) -> list[str]:
    return [f"callbacks.{name}.{s}"
            for s in ("every_n_epochs=1", "log_epoch_zero=true", "ode_steps=2", *settings)]


EXPERIMENTS = {
    "lhco/bigPC": (
        ["data.synthetic_num_events=300", "model.num_particles=40", "data.num_particles=20",
         "data.batch_size=32", *EPIC,
         *callback("lhco_eval", "num_jet_samples=32", "generation_batch_size=32", *W1),
         *callback("lhco_eval_sr", "num_jet_samples=32", "generation_batch_size=32", *W1)],
        {"w1m_mean", "w1p_mean"}),
    "lhco/whole_event": (
        ["data.synthetic_num_events=300", "model.num_particles=48", "data.batch_size=32", *EPIC,
         *callback("lhco_whole_event_eval", "generation_batch_size=32", "cluster_num_particles=24",
                   *W1)],
        {"w1m_mean_x", "w1p_mean_y", "w1mass_jet_mean_x", "w1_mjj_mean"}),
    "lhco/jet_features_set": (
        ["data.synthetic_num_events=300", "data.batch_size=32", *EPIC], set()),
    "jetclass/jetclass_cond": (
        ["data.synthetic_num_jets=256", "data.synthetic_num_particles=16",
         "model.num_particles=16", "data.batch_size=32", "trainer.loss_per_jettype_every_n=1",
         *EPIC, *callback("jetnet_eval", "num_jet_samples=32", "generation_batch_size=32", *W1)],
        {"w1m_mean", "val_loss_QCD", "val_loss_Tbl"}),
    "calo/mdma_calo": (
        ["data.synthetic_num_showers=60", "data.max_hits=32", "data.bucket_multiple=16",
         "data.batch_size=16", "data.rotate_alpha=false", "model.net_config.hidden_dim=16",
         "model.net_config.latent=4", "model.net_config.layers=2", "model.net_config.num_heads=2",
         *callback("calo_eval", "num_showers=16", "generation_batch_size=8")],
        {"features_E", "features_z_weighted", "w1p_mean"}),
}


def run(tmp_path, experiment, name, *extra):
    overrides, _ = EXPERIMENTS[experiment]
    args = [f"experiment={experiment}", "data.synthetic=true", "device=cpu",
            "trainer.max_epochs=2", *overrides, f"output_dir={tmp_path / name}", *extra]
    metrics, objects = ptrain.main(args)
    return metrics, objects["trainer"], objects["out_dir"]


@pytest.mark.parametrize("experiment", list(EXPERIMENTS))
def test_experiment_trains_evaluates_and_resumes(tmp_path, experiment):
    keys = EXPERIMENTS[experiment][1]
    metrics, trainer, out = run(tmp_path, experiment, "first")
    history = trainer.metrics_history
    assert [m["epoch"] for m in history] == [0, 1]
    for m in history:
        assert {"train_loss", "val_loss"} <= set(m) and keys <= set(m), (set(m), keys)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        assert keys <= set(json.loads(f.readlines()[-1]))
    with open(os.path.join(out, "final_metrics.yaml")) as f:
        final = yaml.safe_load(f)
    assert keys <= set(final)
    if not keys:  # no callback: the test pass adds nothing
        assert metrics == history[-1]
    callback_keys = {k for k in keys if not k.startswith("val_loss_")}
    assert callback_keys <= set(pevaluate.evaluate(out, overrides={"device": "cpu"}))
    assert os.path.exists(os.path.join(out, "final_eval_metrics.yaml"))
    sampled = peval_ckpt.main(["--run_dir", out, "--device", "cpu", "--n_samples", "32",
                               "--ode_steps", "2", "--batch_size", "32"])
    assert {"w1m_mean", "generation_time"} <= set(sampled)

    last = os.path.join(out, "checkpoints", "last.pt")
    off = ["callbacks=none", "test=false", "trainer.max_epochs=3"]
    _, resumed, _ = run(tmp_path, experiment, "resumed", *off, f"ckpt_path={last}")
    _, straight, _ = run(tmp_path, experiment, "straight", *off)
    assert [m["epoch"] for m in resumed.metrics_history] == [2]
    assert resumed.state.step == straight.state.step == 3 * trainer.datamodule.steps_per_epoch
    for a, b in zip(resumed.state.net.parameters(), straight.state.net.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(resumed.state.ema_params, straight.state.ema_params):
        assert torch.equal(a, b)
