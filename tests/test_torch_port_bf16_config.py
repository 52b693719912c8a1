"""PyTorch port, `model.dtype`: bfloat16 composed from each shipped model
config (configs/model/flow_matching.yaml, fm_droid_transformer.yaml,
fm_droid_crossattention.yaml, flow_matching_mdma.yaml, narrowed as
tests/test_torch_train_configs.py narrows them) builds, samples on the CPU
and trains (a finite loss, float32 gradients for the float32 parameters),
also through train.py; float16 refuses at the model; float32 and null
compute in float32; the names and types a model takes; and a run trained in
float32 is evaluated in bfloat16 by `evaluate.py` (model.dtype=bfloat16) and
`eval_ckpt.py` (--dtype bfloat16). (Two test names keep the words of the
time before bfloat16 trained: what they check is said in their docstrings.)
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import tests.test_torch_train_configs as train_configs
from particle_fm_tpu_torch import eval_ckpt, evaluate
from particle_fm_tpu_torch import train as ptrain
from particle_fm_tpu_torch.models import flow_matching as pfm
from tests.torch_port_helpers import cloud, t


@pytest.mark.parametrize("config", list(train_configs.NARROW))
def test_model_dtype_bfloat16_composes_samples_and_refuses_to_train(config):
    """bfloat16 composes, samples and trains (a finite loss, float32
    gradients); the model refuses float16."""
    block = train_configs.model_block(config, "model.dtype=bfloat16")
    assert block["dtype"] == "bfloat16"  # the composed config keeps the name
    pm = pfm.FlowMatchingModel(**block)
    net = pm.init(device="cpu")
    assert pm.compute_dtype == torch.bfloat16
    x, mask, cond, _ = cloud(b=2, n=pm.num_particles, feats=pm.features,
                             cond_dim=pm.global_cond_dim, seed=0)
    out = pm.sample(net, torch.Generator().manual_seed(0), cond=t(cond), mask=t(mask),
                    ode_steps=3)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    loss = pm.loss(net, torch.Generator(), t(x), t(mask), t(cond), train=True)
    grads = torch.autograd.grad(loss, list(net.parameters()), allow_unused=True,
                                materialize_grads=True)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        pfm.FlowMatchingModel(**train_configs.model_block(config, "model.dtype=float16"))
    for name in ("float32", "null"):
        block = train_configs.model_block(config, f"model.dtype={name}")
        assert pfm.FlowMatchingModel(**block).compute_dtype is None


def test_dtype_names_and_types():
    for dtype in ("bfloat16", "jnp.bfloat16", torch.bfloat16):
        assert pfm.compute_dtype(dtype) == torch.bfloat16
    for dtype in (None, "float32", torch.float32):
        assert pfm.compute_dtype(dtype) is None
    for dtype in ("float16", torch.float16, "int8"):
        with pytest.raises(NotImplementedError, match="bfloat16"):
            pfm.compute_dtype(dtype)


def test_train_cli_with_bfloat16_raises_at_the_loss(tmp_path):
    """train.py with model.dtype=bfloat16 trains: a finite val_loss, float32
    parameters (the resume and the checkpoints: tests/test_torch_train_bf16_cli.py)."""
    args = ["experiment=jetnet/fm_tops30_cond", "data.synthetic=true",
            "data.synthetic_num_jets=256", "trainer=smoke", "model.scheduler.name=constant",
            "device=cpu", "callbacks=none", "model.hidden_dim=8", "model.latent=4",
            "model.layers=1", "data.batch_size=64", "trainer.max_epochs=1",
            f"output_dir={tmp_path}"]
    metrics, objs = ptrain.main(args + ["model.dtype=bfloat16"])
    trainer = objs["trainer"]
    assert trainer.model.compute_dtype == torch.bfloat16 and trainer.state.step > 0
    assert np.isfinite(metrics["val_loss"])
    assert all(p.dtype == torch.float32 for p in trainer.state.params())


def test_evaluate_and_eval_ckpt_sample_a_float32_run_in_bfloat16(tmp_path, monkeypatch):
    from tests.test_torch_eval_cli import ARGS, EVAL

    _, objs = ptrain.main(ARGS + EVAL + ["trainer.max_epochs=1",
                                         "callbacks.jetnet_eval.num_jet_samples=40",
                                         f"output_dir={tmp_path}"])
    out = objs["out_dir"]
    seen = []
    integrate = pfm.FlowMatchingModel.integrate

    def spy(self, net, *args, **kwargs):
        seen.append((self.compute_dtype, next(net.parameters()).dtype))
        return integrate(self, net, *args, **kwargs)

    monkeypatch.setattr(pfm.FlowMatchingModel, "integrate", spy)
    results = evaluate.main([f"ckpt_path={out}", "ckpt=last", "device=cpu",
                             "model.dtype=bfloat16"])
    assert np.isfinite(results["w1m_mean"])
    assert seen and set(seen) == {(torch.bfloat16, torch.float32)}
    seen.clear()
    metrics = eval_ckpt.main(["--run_dir", out, "--device", "cpu", "--ode_steps", "3",
                              "--n_samples", "50", "--batch_size", "32", "--dtype", "bfloat16"])
    assert np.isfinite(metrics["w1m_mean"])
    assert seen and set(seen) == {(torch.bfloat16, torch.float32)}
    assert os.path.exists(os.path.join(out, "generated_best_50_bf16.npz"))
