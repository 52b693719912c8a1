"""PyTorch port, evaluation through the entry points on the CPU at a narrow
width: the training CLI on experiment=jetnet/fm_tops30_cond with the shipped
`callbacks: jetnet` and `test: true` (fewer jets and ODE steps, every
epoch) logs w1m_mean/w1p_mean each epoch, feeds a `w1m_mean` checkpoint
monitor, and writes the test metrics; `evaluate` and `eval_ckpt` run on its
run directory (with `--write_classifier_h5` writing the classifier test's
input in the JAX package's schema, and naming h5py where it is missing); a callback leaves the training run as it was (parameters and
EMA equal with and without it); a callback the port lacks raises; and
importing the entry points loads no JAX.
"""

from __future__ import annotations

import glob
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch
import yaml

from particle_fm_tpu_torch import eval_ckpt, evaluate
from particle_fm_tpu_torch import train as ptrain
from particle_fm_tpu_torch.config.core import compose, instantiate
from particle_fm_tpu_torch.eval.callbacks import FlatEvalCallback, JetNetEvalCallback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["experiment=jetnet/fm_tops30_cond", "data.synthetic=true", "data.synthetic_num_jets=512",
        "trainer=smoke", "trainer.max_epochs=2", "model.scheduler.name=constant", "device=cpu",
        "model.hidden_dim=16", "model.latent=4", "model.layers=2", "data.batch_size=64"]
EVAL = ["callbacks.jetnet_eval.every_n_epochs=1", "callbacks.jetnet_eval.log_epoch_zero=true",
        "callbacks.jetnet_eval.num_jet_samples=60", "callbacks.jetnet_eval.ode_steps=3",
        "callbacks.jetnet_eval.generation_batch_size=32",
        "callbacks.jetnet_eval.w1_kwargs.num_batches=3"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("eval_cli")
    metrics, objs = ptrain.main(ARGS + EVAL + ["trainer.ckpt_monitors.w1m_mean=min",
                                               f"output_dir={out}"])
    return metrics, objs


def test_cli_logs_w1_and_tests_the_best_w1m_checkpoint(run):
    metrics, objs = run
    trainer, out = objs["trainer"], objs["out_dir"]
    assert [type(cb) for cb in trainer.callbacks] == [JetNetEvalCallback]
    history = trainer.metrics_history
    assert [m["epoch"] for m in history] == [0, 1]
    for m in history:
        assert np.isfinite(m["w1m_mean"]) and np.isfinite(m["w1p_mean"])
    best = glob.glob(os.path.join(out, "checkpoints", "w1m_mean", "step_*_metric_*.pt"))
    assert len(best) == 1  # ckpt_top_k=1 of the smoke trainer
    # test(): the w1m_mean-best checkpoint restored, the callback run with `testing`
    assert f"step_{trainer.state.step}_" in os.path.basename(best[0])
    assert not trainer.testing
    final = yaml.safe_load(open(os.path.join(out, "final_metrics.yaml")))
    for key in ("w1m_mean", "w1p_mean", "w1efp_mean", "generation_time", "val_loss"):
        assert np.isfinite(final[key]), key
    assert final["w1m_mean"] == metrics["w1m_mean"]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        assert all("w1m_mean" in line for line in f)


def test_evaluate_and_eval_ckpt_on_the_run(run):
    _, objs = run
    out = objs["out_dir"]
    results = evaluate.main([f"ckpt_path={out}", "ckpt=last", "device=cpu",
                             "callbacks.jetnet_eval.num_jet_samples=40"])
    saved = yaml.safe_load(open(os.path.join(out, "final_eval_metrics.yaml")))
    assert saved == pytest.approx(results) and np.isfinite(results["w1m_mean"])

    argv = ["--run_dir", out, "--device", "cpu", "--ode_steps", "3", "--n_samples", "50",
            "--batch_size", "32"]
    first = eval_ckpt.main(argv)
    for key in ("w1m_mean", "w1p_mean", "w1efp_mean", "w1_tau21_mean", "w1_tau32_mean",
                "w1_d2_mean", "rkld_feature_0", "rkld_feature_2"):
        assert np.isfinite(first[key]), key
    assert yaml.safe_load(open(os.path.join(out, "eval_metrics.yaml"))) == pytest.approx(first)
    cache = glob.glob(os.path.join(out, "generated_best_*.npz"))
    assert len(cache) == 1
    again = eval_ckpt.main(argv)  # the cached samples: the same generation time
    assert again["generation_time"] == first["generation_time"]
    # the classifier test's input, in the schema the JAX datamodule reads
    import h5py

    eval_ckpt.main(argv + ["--write_classifier_h5"])
    with h5py.File(os.path.join(out, "classifier_data.h5"), "r") as f:
        assert sorted(f) == sorted(f"{k}_{tag}" for k in ("part_data", "part_mask", "cond_data")
                                   for tag in ("gen", "sim"))
        for tag in ("gen", "sim"):
            part, mask, cond = (f[f"{k}_{tag}"] for k in ("part_data", "part_mask", "cond_data"))
            assert part.dtype == np.float32 and part.shape[:2] == mask.shape[:2]
            # JetNet's datamodule names no cond columns: the JAX package writes []
            assert len(cond) == len(part) and "names" in cond.attrs
            assert len(part.attrs["names"]) == part.shape[-1]
    with h5py.File(os.path.join(out, "classifier_data_substructure.h5"), "r") as f:
        assert sorted(f) == sorted(f"{k}_{tag}" for k in ("tau1", "tau2", "tau3", "tau21",
                                                           "tau32", "d2") for tag in ("gen", "sim"))
    with mock.patch.dict(sys.modules, {"h5py": None}):
        with pytest.raises(ImportError, match="h5py"):
            eval_ckpt.main(argv + ["--write_classifier_h5"])


def test_evaluate_takes_its_device_from_the_call(run, monkeypatch):
    # the run was trained with device=cpu; evaluate goes to the card all the same
    _, objs = run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate.main([f"ckpt_path={objs['out_dir']}", "ckpt=last"])


def test_a_callback_moves_nothing(tmp_path):
    base = ARGS + ["trainer.max_epochs=3", "model.optimizer.lr=0.003"]
    _, with_cb = ptrain.main(base + EVAL + ["test=false", f"output_dir={tmp_path / 'a'}"])
    _, without = ptrain.main(base + ["callbacks=none", "test=false", f"output_dir={tmp_path / 'b'}"])
    a, b = with_cb["trainer"], without["trainer"]
    assert len(a.callbacks) == 1 and not b.callbacks
    assert all("w1m_mean" in m for m in a.metrics_history)
    assert a.state.step == b.state.step
    for p, q in zip(a.state.net.parameters(), b.state.net.parameters()):
        assert torch.equal(p, q)
    for p, q in zip(a.state.ema_params, b.state.ema_params):
        assert torch.equal(p, q)
    assert [m["val_loss"] for m in a.metrics_history] == [m["val_loss"] for m in b.metrics_history]


def test_shipped_callbacks_build_as_the_port():
    cfg = compose(os.path.join(ROOT, "configs"), "train", ["experiment=jetnet/fm_tops150_cond"])
    (cb,) = ptrain.build_callbacks(cfg["callbacks"])
    assert isinstance(cb, JetNetEvalCallback)
    assert (cb.every_n_epochs, cb.num_jet_samples, cb.generation_batch_size, cb.ode_steps,
            cb.on_test, cb.w1_kwargs) == ("epochs10000", 10000, 1000, 200, True,
                                          {"num_eval_samples": 10000, "num_batches": 40})
    assert ptrain.build_callbacks({"jetnet_eval": {"every_n_epochs": 3}}) == []
    flat = compose(os.path.join(ROOT, "configs"), "train", ["callbacks=flat_eval"])
    cb = instantiate(flat["callbacks"]["flat_eval"])
    assert isinstance(cb, FlatEvalCallback)
    assert (cb.every_n_epochs, cb.num_samples, cb.generation_batch_size, cb.ode_steps, cb.split,
            cb.on_test) == (100, 10000, 1024, 100, "test", True)
    stats = compose(os.path.join(ROOT, "configs"), "train", ["callbacks=device_stats"])
    with pytest.raises(NotImplementedError, match="DeviceStatsCallback is not ported"):
        instantiate(stats["callbacks"]["device_stats"])


def test_importing_the_eval_entry_points_loads_no_jax():
    code = ("import sys, particle_fm_tpu_torch.eval.callbacks, particle_fm_tpu_torch.evaluate, "
            "particle_fm_tpu_torch.eval_ckpt, particle_fm_tpu_torch.eval.substructure, "
            "particle_fm_tpu_torch.utils.run_io; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax', 'optax'))"
            " or m == 'particle_fm_tpu' or m.startswith('particle_fm_tpu.')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_chip_smoke_names_no_jax():
    import re

    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert not re.search(r"^\s*(import|from)\s+(jax|flax|optax|particle_fm_tpu)(\.|\s|$)", src,
                         re.M)
