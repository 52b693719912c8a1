"""PyTorch port, the training entry point `particle_fm_tpu_torch/train.py` on
the CPU at a narrow width: experiment=jetnet/fm_tops30_cond on synthetic
jets, trainer=smoke, a constant learning rate. It trains, validates, writes
the run directory (config.yaml, metrics.jsonl, metrics.csv,
final_metrics.yaml) and the checkpoints (`last` and the best val_loss), and
the loss falls. Resumed from `last` it continues at the saved step, and ends
where one uninterrupted run of as many epochs ends, exactly (each step's
generator is seeded from the step). Without `device=cpu` on a machine
without CUDA it raises; a callback the port lacks, mesh strategies, fused
and scanned epochs raise; importing the entry point loads no JAX.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys

import pytest
import torch

from particle_fm_tpu_torch import train as ptrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["experiment=jetnet/fm_tops30_cond", "data.synthetic=true", "data.synthetic_num_jets=512",
        "trainer=smoke", "model.scheduler.name=constant", "device=cpu", "callbacks=none",
        "model.hidden_dim=16", "model.latent=4", "model.layers=2", "data.batch_size=64",
        "model.optimizer.lr=0.003"]


def run(tmp_path, name, *extra):
    metrics, objects = ptrain.main(ARGS + [f"output_dir={tmp_path / name}", *extra])
    return metrics, objects["trainer"], objects["out_dir"]


def _params(trainer):
    return [p.detach().clone() for p in trainer.state.net.parameters()]


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    metrics, trainer, out = run(tmp_path, "first", "trainer.max_epochs=4")
    history = trainer.metrics_history
    assert [m["epoch"] for m in history] == [0, 1, 2, 3]
    assert history[-1]["train_loss"] < history[0]["train_loss"]
    assert history[-1]["val_loss"] < history[0]["val_loss"]
    steps_per_epoch = trainer.datamodule.steps_per_epoch
    assert trainer.state.step == 4 * steps_per_epoch == 4 * 5
    for name in ("config.yaml", "final_metrics.yaml", "metrics.jsonl", "metrics.csv"):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "metrics.jsonl")) as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1, 2, 3]
    last = os.path.join(out, "checkpoints", "last.pt")
    best = glob.glob(os.path.join(out, "checkpoints", "val_loss", "step_*_metric_*.pt"))
    assert os.path.exists(last) and len(best) == 1  # ckpt_top_k=1
    assert f"step_{trainer.state.step}_" in os.path.basename(best[0])  # the loss fell each epoch
    assert metrics["val_loss"] == history[-1]["val_loss"]

    _, resumed, _ = run(tmp_path, "resumed", "trainer.max_epochs=6", f"ckpt_path={last}")
    assert [m["epoch"] for m in resumed.metrics_history] == [4, 5]
    assert resumed.state.step == 6 * steps_per_epoch
    _, straight, _ = run(tmp_path, "straight", "trainer.max_epochs=6")
    for a, b in zip(_params(resumed), _params(straight)):
        assert torch.equal(a, b)
    for a, b in zip(resumed.state.ema_params, straight.state.ema_params):
        assert torch.equal(a, b)


def test_cli_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in ARGS if a != "device=cpu"] + [f"output_dir={tmp_path}"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ptrain.main(args)
    assert not os.listdir(tmp_path)  # nothing ran


@pytest.mark.parametrize("override,match", [
    ("callbacks=device_stats", "DeviceStatsCallback is not ported"),
    ("trainer.strategy=fsdp", "strategy"),
    ("+trainer.fuse_epochs=2", "fused epochs"),
    ("+trainer.scan_epochs=true", "scan_epochs"),
    ("+trainer.cache_data_on_device=false", "cache_data_on_device"),
])
def test_cli_raises_for_what_is_not_ported(tmp_path, override, match):
    args = [a for a in ARGS if a != "callbacks=none"] if override.startswith("callbacks") else ARGS
    with pytest.raises(NotImplementedError, match=match):
        ptrain.main(args + [override.lstrip("+"), f"output_dir={tmp_path}"])


def test_importing_the_entry_point_loads_no_jax():
    code = ("import sys, particle_fm_tpu_torch.train; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'particle_fm_tpu' or m.startswith('particle_fm_tpu.')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
