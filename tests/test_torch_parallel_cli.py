"""PyTorch port, the entry points under torchrun on the CPU (gloo, two
ranks): the training CLI (`torchrun --nproc_per_node 2 -m
particle_fm_tpu_torch.train ... trainer.strategy=dp device=cpu`), with the
JetNet callback generating rank-split every epoch and in the test pass,
writes one run directory (rank 0's: one config, one log, checkpoints,
stdout once) whose final losses are one process's; `eval_ckpt` and the
served sampler (serving.py) load its checkpoint in one process; and
`eval_ckpt` under torchrun generates what one process generates, rank 0
writing and printing.
"""

from __future__ import annotations

import glob
import os
import socket
import subprocess
import sys

import numpy as np
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# 161 synthetic jets: a train split of 112 and a validation split of 24, which
# two ranks share evenly (the JAX rule trims an odd split, and then one process
# shuffles other indices)
CLI = ["experiment=jetnet/fm_tops150_cond", "trainer=smoke", "device=cpu",
       "data.synthetic=true", "data.synthetic_num_jets=161", "data.batch_size=16",
       "model.hidden_dim=16", "model.layers=2", "model.scheduler.name=constant",
       "model.latent=4", "callbacks=none", "trainer.max_epochs=2"]


# the shipped JetNet callback at a tiny size: rank-split generation every epoch
CALLBACK = ["callbacks.jetnet_eval.every_n_epochs=1", "callbacks.jetnet_eval.num_jet_samples=32",
            "callbacks.jetnet_eval.generation_batch_size=16", "callbacks.jetnet_eval.ode_steps=3",
            "callbacks.jetnet_eval.w1_kwargs.num_eval_samples=32",
            "callbacks.jetnet_eval.w1_kwargs.num_batches=2"]


def _torchrun(module: str, args: list, timeout: int = 300) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
         "--master_port", str(_free_port()), "-m", module, *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc


def test_torchrun_cli_two_ranks_writes_one_run_with_one_process_metrics(tmp_path):
    two = str(tmp_path / "two")
    args = [a for a in CLI if a != "callbacks=none"] + CALLBACK
    proc = _torchrun("particle_fm_tpu_torch.train", args + ["trainer.strategy=dp",
                                                            f"output_dir={two}"])
    runs = glob.glob(os.path.join(two, "*"))
    assert len(runs) == 1, runs  # one run directory, rank 0's
    assert proc.stdout.count("[train] run dir:") == 1
    assert proc.stdout.count("[trainer] epoch=1") == 1  # stdout on rank 0 only
    from particle_fm_tpu_torch import train as ptrain

    metrics, _ = ptrain.main(CLI + [f"output_dir={tmp_path / 'one'}"])
    with open(os.path.join(runs[0], "final_metrics.yaml")) as f:
        final = yaml.safe_load(f)
    for key in ("train_loss", "val_loss"):  # the callback samples copies: training is the same
        np.testing.assert_allclose(final[key], metrics[key], rtol=1e-5, err_msg=key)
    assert np.isfinite(final["w1m_mean"])  # the callback's test pass, rank-split
    with open(os.path.join(runs[0], "metrics.jsonl")) as f:
        assert len(f.readlines()) == 2
    assert os.path.exists(os.path.join(runs[0], "checkpoints", "last.pt"))
    # the 2-rank checkpoint in one process: eval_ckpt and the served sampler
    from particle_fm_tpu_torch import eval_ckpt, serving
    from particle_fm_tpu_torch.utils.run_io import load_run

    ev = ["--run_dir", runs[0], "--device", "cpu", "--n_samples", "32", "--ode_steps", "3",
          "--batch_size", "16", "--no-cache"]
    out = eval_ckpt.main(ev)
    assert np.isfinite(out["w1m_mean"])
    cache = glob.glob(os.path.join(runs[0], "generated_*.npz"))
    assert len(cache) == 1, cache
    one_gen = np.load(cache[0])["gen"]
    _, _, model, net = load_run(runs[0], "last", ema=True, device="cpu")
    fn = serving.make_serve_fn(model, net, batch_size=4, ode_steps=3, has_cond=True,
                               has_mask=True)
    rs = np.random.RandomState(0)
    mask = (np.arange(150)[None, :] < rs.randint(30, 151, (4, 1))).astype(np.float32)[..., None]
    x = serving.serve_batches(fn, fn.meta, 4, cond=rs.randn(4, 2).astype(np.float32),
                              mask=mask, seed=1)
    assert x.shape == (4, 150, 3) and np.isfinite(x).all() and np.abs(x).max() > 0
    # eval_ckpt under torchrun: generation rank-split, rank 0 writes and prints
    proc = _torchrun("particle_fm_tpu_torch.eval_ckpt", ev)
    assert proc.stdout.count("[eval_ckpt] wrote") == 1
    np.testing.assert_allclose(np.load(cache[0])["gen"], one_gen, atol=1e-5)
