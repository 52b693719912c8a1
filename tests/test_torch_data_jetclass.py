"""PyTorch port, the JetClass datamodule (`particle_fm_tpu_torch/data/
jetclass.py`) and the Trainer's per-jet-type validation losses, held against
the JAX package on the CPU.

- The synthetic file the port writes (`synthetic_jetclass_file`, through
  `synthetic_jetclass_arrays` and `write_jetclass_h5`) holds the JAX
  package's arrays and names bit for bit; with the 10 additional particle
  features the first three features and every other key are unchanged.
- The datamodule read from h5 files (h5py is installed here) equals the JAX
  package's on the same files, bit for bit, for the shipped conditioning
  choices (`jetclass.yaml`, `jetclass_cond.yaml`), a subset of jet types
  and capped jet counts; the in-memory route (`synthetic=True`, which opens
  no file) gives the same datamodule as the h5 route.
- `Trainer._per_jettype_losses` of a small EPiC (2 layers, width 16) with the
  JAX weights, on the validation split, each type's draws pinned alike:
  within 1e-5 relative of the JAX trainer's (on a one-device mesh, so that
  neither side trims a type's sets), with the same metric names.
"""

from __future__ import annotations

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.data import jetclass as jjc
from particle_fm_tpu.parallel import train as jtrain
from particle_fm_tpu.parallel.mesh import make_mesh
from particle_fm_tpu.training.trainer import Trainer as JaxTrainer
from particle_fm_tpu_torch.data import jetclass as pjc
from particle_fm_tpu_torch.training import step as pstep
from particle_fm_tpu_torch.training.trainer import Trainer
from tests.test_torch_data_lhco import assert_same_array, assert_same_datamodule
from tests.torch_port_helpers import (
    YAML_FLAGSHIP, jax_cos_table, model_pair, pin_draws_on_demand,
)

N_PART = 16
SIZES = {"train": (400, 0), "val": (100, 1), "test": (100, 2)}


def _h5(path) -> dict:
    with h5py.File(path, "r") as f:
        return {k: (np.asarray(f[k]), {a: np.asarray(v) for a, v in f[k].attrs.items()})
                for k in f.keys()}


def test_synthetic_file_matches_jax(tmp_path):
    jjc.synthetic_jetclass_file(str(tmp_path / "j.h5"), 300, N_PART, 3, seed=1)
    pjc.synthetic_jetclass_file(str(tmp_path / "p.h5"), 300, N_PART, 3, seed=1)
    want, got = _h5(tmp_path / "j.h5"), _h5(tmp_path / "p.h5")
    assert sorted(want) == sorted(got)
    for key, (data, attrs) in want.items():
        assert_same_array(data, got[key][0], key)
        assert sorted(attrs) == sorted(got[key][1])
        for a in attrs:
            assert_same_array(attrs[a], got[key][1][a], f"{key}.{a}")
    extra = pjc.synthetic_jetclass_arrays(300, N_PART, 3, seed=1, additional_features=True)
    assert extra["part_features"].shape[-1] == 13
    assert_same_array(want["part_features"][0], extra["part_features"][..., :3], "first three")
    for key in ("part_mask", "jet_features", "labels"):
        assert_same_array(want[key][0], extra[key], key)
    m = extra["part_mask"] == 0
    assert not extra["part_features"][m].any()  # padding stays zero
    flags = extra["part_features"][..., 8:]
    np.testing.assert_array_equal(flags.sum(-1), extra["part_mask"])  # one class a particle


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The h5 files of the in-memory synthetic splits (train, val, test)."""
    d = tmp_path_factory.mktemp("jetclass")
    out = {}
    for split, (n, seed) in SIZES.items():
        out[split] = str(d / f"{split}.h5")
        pjc.write_jetclass_h5(out[split], pjc.synthetic_jetclass_arrays(
            n, N_PART, num_types=10, seed=seed, additional_features=True))
    return out


CONDITIONING = {
    "jetclass.yaml": {},
    "jetclass_cond.yaml": dict(
        conditioning_jet_type_all=True, conditioning_eta=True, conditioning_mass=False,
        additional_part_features=pjc.ADDITIONAL_PART_FEATURES),
    "types and counts": dict(used_jet_types=["QCD", "Tbqq", "Wqq"], number_of_used_jets=90,
                             number_of_used_jets_val=20, conditioning_num_particles=True,
                             conditioning_energy=True),
}


@pytest.mark.parametrize("name", list(CONDITIONING))
def test_datamodule_matches_jax_and_the_array_route(files, name):
    kw = dict(batch_size=64, **CONDITIONING[name])
    jdm = jjc.JetClassDataModule(filename_dict=files, **kw)
    jdm.setup()
    pdm = pjc.JetClassDataModule(filename_dict=files, **kw)
    pdm.setup()
    assert_same_datamodule(jdm, pdm)
    seam = pjc.JetClassDataModule(synthetic=True, synthetic_num_jets=SIZES["train"][0],
                                  synthetic_num_particles=N_PART, **kw)
    seam.setup()
    assert_same_datamodule(pdm, dataclass_with_files(seam, files))
    for a, b in zip(pdm.train_batches(seed=2), jdm.train_batches(seed=2)):
        for x, y in zip(a, b):
            assert_same_array(y, x, "batch")


def dataclass_with_files(dm, files):
    """The datamodule as the h5 route built it: the same fields but the
    source switches."""
    import dataclasses

    return dataclasses.replace(dm, filename_dict=files, synthetic=False,
                               synthetic_num_jets=pjc.JetClassDataModule.synthetic_num_jets,
                               synthetic_num_particles=pjc.JetClassDataModule
                               .synthetic_num_particles)


def test_per_jettype_losses_match_jax(files, monkeypatch):
    # cond: 3 types, pt, mass (the JAX side runs op by op, so that each type's
    # draws are taken at its call: each type costs it some seconds)
    kw = dict(batch_size=64, used_jet_types=["QCD", "Hbb", "Tbqq"])
    jdm = jjc.JetClassDataModule(filename_dict=files, **kw)
    jdm.setup()
    pdm = pjc.JetClassDataModule(synthetic=True, synthetic_num_jets=SIZES["train"][0],
                                 synthetic_num_particles=N_PART, **kw)
    pdm.setup()
    cfg = dict(YAML_FLAGSHIP, num_particles=N_PART, hidden_dim=16, global_cond_dim=5,
               local_cond_dim=5)
    jm, variables, pm, net = model_pair(cfg, fill=0.1)
    params = variables["params"]
    jopt = jtrain.make_optimizer(lr=1e-3)
    jtrainer = JaxTrainer(model=jm, datamodule=jdm, optimizer=jopt, loss_per_jettype=True,
                          mesh=make_mesh(devices=jax.devices()[:1]), verbose=False)
    jtrainer.state = jtrain.TrainState(
        params=params, norm_stats={}, ema_params=params, opt_state=jopt.init(params),
        step=jnp.zeros((), jnp.int32))
    trainer = Trainer(pm, pdm, pstep.make_optimizer(lr=1e-3), loss_per_jettype=True,
                      device="cpu", verbose=False)
    trainer.state = pstep.create_train_state(pm, trainer.optimizer, device="cpu")
    trainer.state.net.load_state_dict(net.state_dict())  # the JAX weights
    for flow in trainer.state.net.flows:  # and the JAX cosine table (not in a state_dict)
        flow.cos_freqs.copy_(torch.from_numpy(jax_cos_table(flow.cos_freqs.shape[0])))

    pin_draws_on_demand(monkeypatch, seed=4)
    with jax.disable_jit():
        want = jtrainer._per_jettype_losses()
    got = trainer._per_jettype_losses()
    assert sorted(got) == sorted(want) == ["val_loss_Hbb", "val_loss_QCD", "val_loss_Tbqq"]
    assert all(k.startswith("val_loss_") for k in got)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
