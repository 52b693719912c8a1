"""PyTorch port, the data and config layers of training held against the JAX
package on the CPU, exactly (numpy on both sides):

- `data/synthetic.py::synthetic_jetnet` gives the JAX generator's arrays;
- `data/jetnet.py::JetNetDataModule` (synthetic) gives the JAX datamodule's
  splits, masks, cond and statistics, and raises the JAX message when the
  hdf5 files are missing;
- the trainer's epoch batches are the JAX trainer's: the same
  `default_rng(seed + epoch)` shuffle over the same usable batches, with and
  without gradient accumulation (the JAX trainer runs on the 8-device CPU
  mesh here, so the batch size is a multiple of 8);
- `config/core.py::compose` gives the JAX composition for the JetNet
  experiments, and `instantiate` builds the port's classes for the JAX
  package's targets and raises for one the port lacks.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest

from particle_fm_tpu.config.core import compose as jax_compose
from particle_fm_tpu.data.jetnet import JetNetDataModule as JaxJetNet
from particle_fm_tpu.data.synthetic import synthetic_jetnet as jax_synthetic
from particle_fm_tpu.parallel.train import make_optimizer as jax_make_optimizer
from particle_fm_tpu.training.trainer import Trainer as JaxTrainer
from particle_fm_tpu_torch.config.core import compose, instantiate
from particle_fm_tpu_torch.data.jetnet import JetNetDataModule
from particle_fm_tpu_torch.data.synthetic import synthetic_jetnet
from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel
from particle_fm_tpu_torch.training.step import make_optimizer
from particle_fm_tpu_torch.training.trainer import Trainer
from tests.torch_port_helpers import YAML_FLAGSHIP

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


@pytest.mark.parametrize("types,n_jets,n", [(["t"], 300, 30), (["t", "q"], 200, 150)])
def test_synthetic_jetnet_matches_jax(types, n_jets, n):
    for got, want in zip(synthetic_jetnet(types, n_jets, n, seed=3), jax_synthetic(types, n_jets, n, seed=3)):
        np.testing.assert_array_equal(got, want)


DATA = {
    "tops30": dict(jet_type=("t",), num_particles=30, centering=False, conditioning_type=False,
                   conditioning_eta=False, conditioning_num_particles=False),
    "tops150 centred, every cond": dict(jet_type=("t", "w"), num_particles=150, centering=True),
    "fixed size": dict(jet_type=("t",), num_particles=30, variable_jet_sizes=False),
}


@pytest.mark.parametrize("name", list(DATA))
def test_jetnet_datamodule_matches_jax(name):
    kw = dict(DATA[name], synthetic=True, synthetic_num_jets=600, batch_size=64)
    mine, ref = JetNetDataModule(**kw), JaxJetNet(**kw)
    mine.setup()
    ref.setup()
    for split in ("train", "val", "test"):
        for field in ("x", "mask", "cond"):
            np.testing.assert_array_equal(getattr(getattr(mine, split), field),
                                          getattr(getattr(ref, split), field))
    for field in ("means", "stds", "cond_means", "cond_stds", "tensor_test", "mask_test"):
        np.testing.assert_array_equal(getattr(mine, field), getattr(ref, field))
    assert mine.steps_per_epoch == ref.steps_per_epoch
    batches = list(zip(mine.val_batches(), ref.val_batches()))
    assert batches and all(np.array_equal(a, b) for pair in batches for a, b in zip(*pair))


def test_jetnet_without_files_raises_as_jax(tmp_path):
    kw = dict(data_dir=str(tmp_path), num_particles=30)
    with pytest.raises(FileNotFoundError) as want:
        JaxJetNet(**kw).setup()
    with pytest.raises(FileNotFoundError) as got:
        JetNetDataModule(**kw).setup()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("accum", [1, 2])
def test_epoch_batches_match_the_jax_trainer(accum):
    kw = dict(DATA["tops30"], synthetic=True, synthetic_num_jets=512, batch_size=16)
    dm, jdm = JetNetDataModule(**kw), JaxJetNet(**kw)
    dm.setup()
    jdm.setup()
    trainer = Trainer(FlowMatchingModel(**YAML_FLAGSHIP), dm, make_optimizer(), seed=7,
                      device="cpu", accumulate_grad_batches=accum, verbose=False)
    jtrainer = JaxTrainer(model=None, datamodule=jdm, optimizer=jax_make_optimizer(), seed=7,
                          accumulate_grad_batches=accum, verbose=False, ckpt_dir=None)
    split = dm.train
    dev = trainer._to_device((split.x, split.mask, split.cond))
    jdev = tuple(jnp.asarray(a) for a in (split.x, split.mask, split.cond))
    jbatches = jtrainer._epoch_accum_batches if accum > 1 else jtrainer._epoch_batches
    n = len(split)
    assert trainer._usable_batches(n, 16, accum) == jtrainer._usable_batches(n, 16, accum)
    for epoch in range(3):
        got = list(trainer._epoch_batches(dev, epoch))
        want = list(jbatches(jdev, epoch))
        assert len(got) == len(want) == (n // 16) // accum
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("experiment", ["jetnet/fm_tops30_cond", "jetnet/fm_tops150_cond"])
def test_compose_matches_jax(experiment):
    overrides = [f"experiment={experiment}", "data.synthetic=true", "trainer=smoke",
                 "model.hidden_dim=16", "callbacks=none"]
    assert compose(CONFIG_DIR, "train", overrides) == jax_compose(CONFIG_DIR, "train", overrides)


def test_instantiate_maps_targets_to_the_port():
    cfg = compose(CONFIG_DIR, "train", ["experiment=jetnet/fm_tops150_cond", "data.synthetic=true"])
    model_cfg = {k: v for k, v in cfg["model"].items() if k not in ("optimizer", "scheduler")}
    model = instantiate(model_cfg)
    assert isinstance(model, FlowMatchingModel)
    assert (model.hidden_dim, model.layers, model.latent, model.num_particles,
            model.global_cond_dim, model.local_cond_dim) == (128, 6, 10, 150, 2, 2)
    assert isinstance(instantiate(cfg["data"]), JetNetDataModule)
    from particle_fm_tpu_torch.eval.callbacks import JetNetEvalCallback

    assert isinstance(instantiate(cfg["callbacks"]["jetnet_eval"]), JetNetEvalCallback)
    from particle_fm_tpu_torch.eval.callbacks import FlatEvalCallback

    flat = {"_target_": "particle_fm_tpu.eval.callbacks.FlatEvalCallback"}
    assert isinstance(instantiate(flat), FlatEvalCallback)
    stats = {"_target_": "particle_fm_tpu.eval.callbacks.DeviceStatsCallback"}
    with pytest.raises(NotImplementedError, match="DeviceStatsCallback is not ported"):
        instantiate(stats)
