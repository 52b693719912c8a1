"""PyTorch port, ReFlow distillation (particle_fm_tpu_torch/training/reflow.py,
data/pairs.py) held against the JAX package on the CPU:

- `ReflowPairsDataModule`'s splits, statistics and batches equal JAX's bit for
  bit;
- `generate_pairs` given the JAX package's noise (its per-batch key chain)
  gives JAX's pairs (x0 exactly, x1 within 1e-4; the sincos time embedding,
  as JAX's sampler is jitted: see tests/test_torch_samplers_adaptive.py for
  why the cosine one is not compared under jit), with the same resampled
  mask and cond rows;
- `straightness` of the same coupling within 1e-5 (relative);
- the guards raise as the JAX package's do (tests/test_reflow.py);
- a tiny student trains on the pairs through the port's train.py
  (`data=reflow_pairs`) and samples.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from particle_fm_tpu.data.pairs import ReflowPairsDataModule as JaxPairs
from particle_fm_tpu.training import reflow as jreflow
from particle_fm_tpu_torch import train as ptrain
from particle_fm_tpu_torch.data.pairs import ReflowPairsDataModule
from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel
from particle_fm_tpu_torch.training import reflow
from tests.torch_port_helpers import YAML_FLAGSHIP, cloud, model_pair, t

CFG = dict(YAML_FLAGSHIP, num_particles=8, t_emb="sincos", frequencies=2)


def _pairs_file(path, n=50, seed=0, stats=True):
    rs = np.random.RandomState(seed)
    x1 = rs.randn(n, 6, 3).astype(np.float32)
    x0 = rs.randn(n, 6, 3).astype(np.float32)
    mask = (np.arange(6)[None, :] < rs.randint(2, 7, (n, 1))).astype(np.float32)[..., None]
    extra = dict(means=np.zeros(3), stds=np.ones(3)) if stats else {}
    np.savez(path, x1=x1, x0=x0, mask=mask, cond=rs.randn(n, 2).astype(np.float32), **extra)
    return path


@pytest.mark.parametrize("val_fraction,seed", [(0.1, 42), (0.3, 7)])
def test_pairs_datamodule_splits_equal_jax(tmp_path, val_fraction, seed):
    path = str(_pairs_file(tmp_path / "pairs.npz"))
    kw = dict(pairs_path=path, batch_size=16, val_fraction=val_fraction, seed=seed)
    dm, jdm = ReflowPairsDataModule(**kw), JaxPairs(**kw)
    dm.setup()
    jdm.setup()
    for split in ("train", "val", "test"):
        a, b = getattr(dm, split), getattr(jdm, split)
        for f in ("x", "mask", "cond"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for k in ("means", "stds", "tensor_train", "mask_train", "tensor_val", "mask_test",
              "tensor_conditioning_train", "tensor_conditioning_test"):
        np.testing.assert_array_equal(getattr(dm, k), getattr(jdm, k))
    assert dm.train.x.shape[-1] == 6  # concat(x1, x0)
    for a, b in zip(dm.train_batches(3), jdm.train_batches(3)):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


def _jax_batch_noise(seed, n_batches, shape):
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n_batches):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape)))
    return out


def test_generate_pairs_and_straightness_match_jax(monkeypatch):
    jm, variables, pm, net = model_pair(CFG, fill=True)
    _, mask, cond, _ = cloud(b=6, n=8, seed=3)
    kw = dict(mask=mask, cond=cond, batch_size=4, ode_solver="midpoint", ode_steps=3, seed=5)
    jx1, jx0, jm_, jc = jreflow.generate_pairs(jm, variables, 7, **kw)
    noise = iter(_jax_batch_noise(5, 2, (4, 8, 3)))
    monkeypatch.setattr(reflow, "draw_noise", lambda gen, shape, dev: t(next(noise)).to(dev))
    x1, x0, m, c = reflow.generate_pairs(pm, net, 7, **kw)
    np.testing.assert_array_equal(m, jm_)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(x0, jx0)
    np.testing.assert_allclose(x1, jx1, atol=1e-4)
    assert x1.shape == (7, 8, 3) and np.abs(x1[m[..., 0] == 0]).max() == 0
    assert not any(mod._kernel_weights is not None for mod in net.modules()
                   if hasattr(mod, "_kernel_weights"))  # the teacher is left unfolded

    want = jreflow.straightness(jm, variables, jx1, jx0, jm_, jc, n_times=3)
    got = reflow.straightness(pm, net, jx1, jx0, jm_, jc, n_times=3)
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # without mask and cond pools: all ones, no cond
    jm2, v2, pm2, net2 = model_pair(dict(CFG, global_cond_dim=0, local_cond_dim=0), fill=True)
    want = jreflow.straightness(jm2, v2, jx1, jx0, None, None, n_times=2)
    np.testing.assert_allclose(reflow.straightness(pm2, net2, jx1, jx0, None, None, n_times=2),
                               want, rtol=1e-5)


def test_generate_pairs_guards():
    droid = FlowMatchingModel(model="epic", features=3, num_particles=4, hidden_dim=8, layers=1,
                              latent=2, loss_type="droid", droid_t_max=25.0)
    with pytest.raises(ValueError, match="N\\(0,1\\)"):
        reflow.generate_pairs(droid, droid.init(device="cpu"), 4, mask=np.ones((4, 4, 1)))
    normed = FlowMatchingModel(model="epic", features=3, num_particles=4, hidden_dim=8, layers=1,
                               latent=2, use_normaliser=True)
    with pytest.raises(NotImplementedError, match="normalisation"):
        reflow.generate_pairs(normed, normed.init(device="cpu"), 4)


def test_student_model():
    teacher = FlowMatchingModel(**CFG)
    student = reflow.student_model(teacher)
    assert student.loss_type == "reflow" and student.sigma == teacher.sigma
    fields = [f.name for f in dataclasses.fields(teacher) if f.name != "loss_type"]
    assert all(getattr(student, f) == getattr(teacher, f) for f in fields)
    assert reflow.student_model(teacher, sigma=0.0).sigma == 0.0


def test_student_trains_through_train_py(tmp_path):
    teacher = FlowMatchingModel(**dict(CFG, num_particles=30, hidden_dim=16, latent=4))
    net = teacher.init(seed=0, device="cpu")
    _, mask, cond, _ = cloud(b=40, n=30, seed=1)
    x1, x0, m, c = reflow.generate_pairs(teacher, net, 96, mask=mask, cond=cond, batch_size=48,
                                         ode_steps=3)
    np.savez(tmp_path / "pairs.npz", x1=x1, x0=x0, mask=m, cond=c)
    _, objects = ptrain.main([
        "data=reflow_pairs", f"data.pairs_path={tmp_path / 'pairs.npz'}", "data.batch_size=32",
        "model.loss_type=reflow", "model.num_particles=30", "model.global_cond_dim=2",
        "model.local_cond_dim=2", "model.hidden_dim=16", "model.latent=4", "model.layers=2",
        "model.scheduler.name=constant", "trainer=smoke", "callbacks=none", "test=false",
        "device=cpu", f"output_dir={tmp_path / 'run'}"])
    trainer = objects["trainer"]
    assert objects["model"].loss_type == "reflow"
    assert len(trainer.metrics_history) == 2
    assert all(np.isfinite(h["val_loss"]) for h in trainer.metrics_history)
    student_net = trainer.state.ema_network()
    s = reflow.straightness(objects["model"], student_net, x1[:8], x0[:8], m[:8], c[:8],
                            n_times=2)
    assert np.isfinite(s)
    out = objects["model"].sample(student_net, torch.Generator().manual_seed(3), cond=t(c[:8]),
                                  mask=t(m[:8]), ode_solver="euler", ode_steps=3)
    assert out.shape == (8, 30, 3) and torch.isfinite(out).all()
