"""PyTorch port, the training entry point in bfloat16 on the CPU at a narrow
width: `train.py experiment=jetnet/fm_tops30_cond ... model.dtype=bfloat16`
(synthetic jets, trainer=smoke, a constant learning rate) trains, the loss
falls, and the run directory keeps the type in config.yaml. Its checkpoints
(`last` and the best val_loss) hold float32 parameters, EMA weights and
AdamW moments. Resumed from `last`, it continues at the saved step and ends
where one uninterrupted run of as many epochs ends, exactly. The run is then
evaluated from its EMA weights by `evaluate.py` and `eval_ckpt.py`: in
bfloat16, the run's type, by default, and in float32 on request.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import pytest
import torch

from particle_fm_tpu_torch import eval_ckpt, evaluate
from particle_fm_tpu_torch import train as ptrain
from particle_fm_tpu_torch.config.core import load_config
from particle_fm_tpu_torch.models import flow_matching as pfm
from tests.test_torch_train_cli import ARGS

BF16 = ARGS + ["model.dtype=bfloat16"]


def run(tmp_path, name, *extra):
    metrics, objects = ptrain.main(BF16 + [f"output_dir={tmp_path / name}", *extra])
    return metrics, objects["trainer"], objects["out_dir"]


def _float32_checkpoint(path: str) -> None:
    sd = torch.load(path, map_location="cpu", weights_only=False)
    tensors = list(sd["params"].values()) + list(sd["ema_params"])
    tensors += [v for s in sd["opt_state"]["state"].values() for v in s.values() if v.ndim]
    assert tensors and all(a.dtype == torch.float32 for a in tensors), path


def test_cli_trains_checkpoints_and_resumes_in_bf16(tmp_path):
    metrics, trainer, out = run(tmp_path, "first", "trainer.max_epochs=2")
    assert trainer.model.compute_dtype == torch.bfloat16
    assert load_config(os.path.join(out, "config.yaml"))["model"]["dtype"] == "bfloat16"
    history = trainer.metrics_history
    assert history[-1]["train_loss"] < history[0]["train_loss"]
    assert np.isfinite(metrics["val_loss"])
    last = os.path.join(out, "checkpoints", "last.pt")
    best = glob.glob(os.path.join(out, "checkpoints", "val_loss", "step_*_metric_*.pt"))
    assert len(best) == 1
    for path in (last, best[0]):
        _float32_checkpoint(path)

    _, resumed, _ = run(tmp_path, "resumed", "trainer.max_epochs=3", f"ckpt_path={last}")
    assert [m["epoch"] for m in resumed.metrics_history] == [2]
    assert resumed.state.step == 3 * trainer.datamodule.steps_per_epoch
    _, straight, _ = run(tmp_path, "straight", "trainer.max_epochs=3")
    for a, b in zip(resumed.state.params(), straight.state.params()):
        assert torch.equal(a, b)
    for a, b in zip(resumed.state.ema_params, straight.state.ema_params):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,want", [(None, torch.bfloat16), ("float32", None)])
def test_a_bf16_run_is_evaluated_in_its_type_or_in_float32(tmp_path, monkeypatch, dtype, want):
    from tests.test_torch_eval_cli import ARGS as EVAL_ARGS
    from tests.test_torch_eval_cli import EVAL

    _, objs = ptrain.main(EVAL_ARGS + EVAL + ["model.dtype=bfloat16", "trainer.max_epochs=1",
                                              "callbacks.jetnet_eval.num_jet_samples=40",
                                              f"output_dir={tmp_path}"])
    out = objs["out_dir"]
    seen = []
    integrate = pfm.FlowMatchingModel.integrate

    def spy(self, net, *args, **kwargs):
        seen.append((self.compute_dtype, next(net.parameters()).dtype))
        return integrate(self, net, *args, **kwargs)

    monkeypatch.setattr(pfm.FlowMatchingModel, "integrate", spy)
    extra = [] if dtype is None else [f"model.dtype={dtype}"]
    results = evaluate.main([f"ckpt_path={out}", "ckpt=last", "device=cpu", *extra])
    assert np.isfinite(results["w1m_mean"])
    assert seen and set(seen) == {(want, torch.float32)}
    seen.clear()
    extra = [] if dtype is None else ["--dtype", dtype]
    metrics = eval_ckpt.main(["--run_dir", out, "--device", "cpu", "--ode_steps", "3",
                              "--n_samples", "50", "--batch_size", "32", *extra])
    assert np.isfinite(metrics["w1m_mean"])
    assert seen and set(seen) == {(want, torch.float32)}
