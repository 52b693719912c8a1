"""PyTorch port, the scripts of the served artifact and of distillation, run
on the CPU at tiny sizes on one small trained run (the training CLI's
narrow JetNet-30 run, as tests/test_torch_train_cli.py trains it):
scripts/torch_export_model.py (with --verify: the artifact equals the live
model bit for bit), scripts/torch_serve_model.py (a real server process,
answering /healthz and /sample), scripts/torch_reflow.py and
scripts/torch_consistency.py (their metrics files written, finite).
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import yaml

from particle_fm_tpu_torch import train as ptrain

ROOT = Path(__file__).resolve().parent.parent
RUN_ARGS = ["experiment=jetnet/fm_tops30_cond", "data.synthetic=true",
            "data.synthetic_num_jets=256", "trainer=smoke", "trainer.max_epochs=1",
            "model.scheduler.name=constant", "device=cpu", "callbacks=none", "test=false",
            "model.hidden_dim=16", "model.latent=4", "model.layers=2", "data.batch_size=64"]


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("run")
    _, objects = ptrain.main(RUN_ARGS + [f"output_dir={out}"])
    return objects["out_dir"]


@pytest.fixture(scope="module")
def artifact(run_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("exported"))
    report = _script("torch_export_model").main(
        ["--run_dir", run_dir, "--ckpt", "last", "--batch_size", "8", "--ode_steps", "3",
         "--out", out, "--device", "cpu", "--verify"])
    assert report["out"] == out and report["bytes"] > 0 and report["sets_per_s"] > 0
    return out


def test_export_script_writes_a_verified_artifact(artifact, run_dir):
    with open(os.path.join(artifact, "meta.yaml")) as f:
        meta = yaml.safe_load(f)
    assert meta["platforms"] == ["cpu"] and meta["batch_size"] == 8
    assert meta["ode_solver"] == "midpoint" and meta["ode_steps"] == 3
    assert meta["provenance"]["run_dir"] == os.path.abspath(run_dir)


def test_serve_script_answers_over_http(artifact):
    proc = subprocess.Popen([sys.executable, str(ROOT / "scripts" / "torch_serve_model.py"),
                             "--artifact", artifact, "--port", "0"], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving "), proc.stderr.read() if not line else line
        url = line.split(" on ")[1].split()[0]
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
            assert json.loads(resp.read())["status"] == "ok"
        body = json.dumps({"n_samples": 3, "seed": 1, "cond": [[0.1, 0.2]] * 3,
                           "num_points": [30, 5, 12]}).encode()
        req = urllib.request.Request(f"{url}/sample", data=body, method="POST",
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            out = json.loads(resp.read())
        x = np.asarray(out["samples"])
        assert out["shape"] == [3, 30, 3] and np.isfinite(x).all() and (x[1, 5:] == 0).all()
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_reflow_script(run_dir, tmp_path):
    results = _script("torch_reflow").main(
        ["--run_dir", run_dir, "--ckpt", "last", "--n_pairs", "64", "--teacher_steps", "3",
         "--epochs", "1", "--batch_size", "32", "--eval_nfes", "1", "--n_eval", "32",
         "--out_dir", str(tmp_path), "--device", "cpu"])
    assert np.isfinite(results["straightness_teacher"])
    assert np.isfinite(results["straightness_student"])
    assert {"teacher_nfe1", "student_nfe1"} <= set(results)
    with open(tmp_path / "config.yaml") as f:
        assert yaml.safe_load(f)["model"]["loss_type"] == "reflow"
    assert (tmp_path / "reflow_metrics.yaml").exists() and (tmp_path / "pairs.npz").exists()


@pytest.mark.parametrize("mode", ["direct", "cd"])
def test_consistency_script(run_dir, tmp_path, mode):
    results = _script("torch_consistency").main(
        ["--run_dir", run_dir, "--ckpt", "last", "--mode", mode, "--steps", "2",
         "--batch_size", "8", "--warmup", "1", "--solver_steps", "2", "--n_grid", "4",
         "--eval_steps", "1", "--teacher_nfes", "", "--n_eval", "32", "--eval_batch", "16",
         "--out_dir", str(tmp_path), "--device", "cpu"])
    assert np.isfinite(results["final_loss"]) and np.isfinite(results["student_nfe1"]["w1m"])
    assert (tmp_path / "consistency_metrics.yaml").exists() and (tmp_path / "student.pt").exists()
