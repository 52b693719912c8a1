"""PyTorch port, the classifier-test driver (scripts/torch_classifier_test.py)
held against the JAX script (scripts/classifier_test.py) in its three modes
and with `--load_weights_from`, on small inputs the test makes itself.

The two scripts read the same inputs: the run loaders return one narrow
generator (seeded JAX weights carried into the port) and each package's
synthetic datamodule, or the h5 files written here. The port's generation
draws the JAX driver's noise, and its classifier starts from the JAX
classifier's initial (or fine-tuned) parameters, so that both train from
the same point on the same first batch (one batch an epoch, the train split
a multiple of the JAX trainer's 8 devices).

Held, for each mode: the generated sets within 1e-4; the
GenVsRealDataModule arrays equal (the real rows, and the datamodule the port
builds from the JAX sets); the first step's loss within 1e-5; the YAML's
keys equal, its values in [0, 1]. With `--load_weights_from` the port's
network holds the checkpoint's trunk before the head is drawn anew.
"""

from __future__ import annotations

import sys

import h5py
import jax
import numpy as np
import pytest
import torch
import yaml

from particle_fm_tpu.config.core import compose as jax_compose
from particle_fm_tpu.config.core import instantiate as jax_instantiate
from particle_fm_tpu.models.classifiers import HLClassifierModel as JaxHLClassifier
from particle_fm_tpu.models.classifiers import SetClassifierModel as JaxClassifier
from particle_fm_tpu.training import trainer as jtrainer
from particle_fm_tpu_torch.config.core import compose, instantiate
from particle_fm_tpu_torch.data.classifier import GenVsRealDataModule
from particle_fm_tpu_torch.data.jetclass_classifier import (
    HL_NAMES,
    JetClassClassifierDataModule,
)
from particle_fm_tpu_torch.models.classifiers import SetClassifierModel
from particle_fm_tpu_torch.train import CONFIG_DIR
from particle_fm_tpu_torch.training import trainer as ptrainer
from particle_fm_tpu_torch.training.checkpoint import CheckpointManager
from particle_fm_tpu_torch.utils.from_jax import load_flax_params
from scripts import classifier_test as jscript
from scripts import torch_classifier_test as pscript
from tests.test_torch_scripts_sampling import pin, run_pair

TOL, LOSS_TOL = 1e-4, 1e-5
GEN_RUN = ["experiment=jetnet/fm_tops30_cond", "data.synthetic=true",
           "data.synthetic_num_jets=300", "model.hidden_dim=16", "model.layers=2",
           "model.latent=4", "model.num_particles=12", "model.t_emb=sincos"]
SCRIPT_ARGS = ["--epochs", "1", "--batch_size", "32", "--ode_steps", "3"]


def _copy_into(state, params) -> None:
    load_flax_params(state.net, jax.device_get(params))
    with torch.no_grad():
        for e, p in zip(state.ema_params, state.net.parameters(), strict=True):
            e.copy_(p)


@pytest.fixture
def shared_start(monkeypatch):
    """The JAX Trainer's initial parameters become the port Trainer's; both
    Trainers are recorded."""
    seen = {}
    inner = jtrainer.create_train_state
    for cls in (JaxClassifier, JaxHLClassifier):  # flax's init jitted: one compile, not op by op
        init = cls.init
        monkeypatch.setattr(cls, "init", lambda self, rng, _init=init: jax.jit(
            lambda r: _init(self, r))(rng))

    def jax_state(model, rng, optimizer):
        state = inner(model, rng, optimizer)
        seen["params"] = jax.device_get(state.params)  # the step donates its input
        return state

    def port_state(model, optimizer, seed=0, device="cuda"):
        state = pinner(model, optimizer, seed=seed, device=device)
        _copy_into(state, seen["params"])
        return state

    pinner = ptrainer.create_train_state
    monkeypatch.setattr(jtrainer, "create_train_state", jax_state)
    monkeypatch.setattr(ptrainer, "create_train_state", port_state)
    for side, cls in (("jax", jtrainer.Trainer), ("port", ptrainer.Trainer)):
        fit = cls.fit

        def recorded(self, *a, _fit=fit, _side=side, **k):
            seen[_side] = self
            return _fit(self, *a, **k)
        monkeypatch.setattr(cls, "fit", recorded)
    return seen


def run_both(monkeypatch, tmp_path, argv, out_name="classifier_test.yaml"):
    monkeypatch.setattr(sys, "argv", ["classifier_test.py", "--run_dir", str(tmp_path)] + argv)
    jscript.main()
    want = yaml.safe_load(open(tmp_path / out_name))
    got = pscript.main(["--run_dir", str(tmp_path), "--device", "cpu"] + argv)
    assert yaml.safe_load(open(tmp_path / out_name)) == got
    assert got.keys() == want.keys() == {"classifier_auc", "classifier_accuracy"}
    assert all(0.0 <= v <= 1.0 for v in got.values())
    return want, got


def hold_first_step(seen) -> None:
    jt, pt = seen["jax"], seen["port"]
    assert pt.datamodule.steps_per_epoch == jt.datamodule.steps_per_epoch == 1
    assert len(pt.datamodule.train.x) % 8 == 0  # the JAX device cache keeps every row
    assert len(pt.datamodule.train.x) < 2 * pt.datamodule.batch_size
    np.testing.assert_allclose(pt.metrics_history[0]["train_loss"],
                               jt.metrics_history[0]["train_loss"], rtol=0, atol=LOSS_TOL)


def hold_datamodules(jdm, pdm, gen_tol: float = 0.0) -> None:
    for split in ("train", "val", "test"):
        a, b = getattr(pdm, split), getattr(jdm, split)
        np.testing.assert_allclose(a.x, b.x, atol=gen_tol, rtol=0)
        for name in ("mask", "cond"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_generated_mode_matches_jax(tmp_path, monkeypatch, shared_start):
    jax_run, port_run = run_pair(GEN_RUN)
    samples = pin(monkeypatch, jax_run, port_run, 0)
    run_both(monkeypatch, tmp_path, SCRIPT_ARGS + ["--n_samples", "40", "--ckpt", "last"])
    (gen_j,), (gen_p,) = samples["jax"], samples["port"]
    np.testing.assert_allclose(gen_p, gen_j, atol=TOL)
    jdm = shared_start["jax"].datamodule
    hold_datamodules(jdm, shared_start["port"].datamodule, gen_tol=TOL)
    real = port_run[1]
    rebuilt = GenVsRealDataModule(real=real.tensor_test[:40], real_mask=real.mask_test[:40],
                                  gen=gen_j, gen_mask=(np.abs(gen_j).sum(-1, keepdims=True) > 0)
                                  .astype(np.float32), batch_size=32)
    rebuilt.setup()
    hold_datamodules(jdm, rebuilt)
    hold_first_step(shared_start)


def test_fine_tuning_starts_from_the_checkpoint_trunk(tmp_path, monkeypatch, shared_start):
    """--load_weights_from: the JAX side's checkpoint read is the same
    parameters as the port's checkpoint file; the head is the JAX script's
    re-drawn head on both sides (the two packages draw from other streams)."""
    from particle_fm_tpu.training import checkpoint as jckpt
    from particle_fm_tpu_torch.training.step import create_train_state, make_optimizer

    jax_run, port_run = run_pair(GEN_RUN)
    pin(monkeypatch, jax_run, port_run, 0)
    clf = SetClassifierModel(arch="epic", n_classes=1, num_particles=12, features=3)
    pretrained = jax.device_get(JaxClassifier(arch="epic", n_classes=1, num_particles=12,
                                              features=3).init(jax.random.PRNGKey(7))["params"])
    state = create_train_state(clf, make_optimizer(), seed=3, device="cpu")
    _copy_into(state, pretrained)
    path = CheckpointManager(str(tmp_path / "ckpt"), async_save=False).save_last(state)
    monkeypatch.setattr(jckpt, "load_weights_from",
                        lambda p, s: s.replace(params=pretrained, ema_params=pretrained))
    heads, trunks = {}, []
    jreinit = JaxClassifier.reinit_head

    def jax_head(self, variables, rng):
        fresh = jreinit(self, variables, rng)
        heads["params"] = jax.device_get(fresh["params"])  # the step donates its input
        return fresh

    def port_head(self, net, seed=0):
        trunks.append({k: v.clone() for k, v in net.state_dict().items()})
        state = type("S", (), {"net": net, "ema_params": [p.detach().clone()
                                                           for p in net.parameters()]})
        _copy_into(state, heads["params"])
        return net

    monkeypatch.setattr(JaxClassifier, "reinit_head", jax_head)
    monkeypatch.setattr(SetClassifierModel, "reinit_head", port_head)
    run_both(monkeypatch, tmp_path, SCRIPT_ARGS + ["--n_samples", "40", "--ckpt", "last",
                                                   "--load_weights_from", path])
    (trunk,) = trunks
    for k, v in state.net.state_dict().items():
        assert torch.equal(trunk[k], v), k
    hold_first_step(shared_start)


def write_jetclass_classifier_h5(path) -> None:
    """A gen/sim classifier file and its `_substructure.h5` twin in the
    schema eval_ckpt --write_classifier_h5 writes (the datamodule's
    synthetic pair: gen a smeared copy of sim)."""
    dm = JetClassClassifierDataModule(synthetic=True, synthetic_num_jets=60,
                                      synthetic_num_particles=12, seed=2)
    arrays, part_names, cond_names, hl = dm._load_synthetic()
    with h5py.File(path, "w") as f:
        for key, value in arrays.items():
            d = f.create_dataset(key, data=value)
            if key.startswith(("part_data", "cond_data")):
                d.attrs["names"] = part_names if key.startswith("part") else cond_names
    with h5py.File(str(path).replace(".h5", "_substructure.h5"), "w") as f:
        for name in HL_NAMES:
            for tag in ("gen", "sim"):
                f.create_dataset(f"{name}_{tag}", data=hl[f"{name}_{tag}"])


@pytest.mark.parametrize("arch", ["epic", "hl"])
def test_data_file_mode_matches_jax(tmp_path, monkeypatch, shared_start, arch):
    write_jetclass_classifier_h5(tmp_path / "classifier_data.h5")
    run_both(monkeypatch, tmp_path, SCRIPT_ARGS + [
        "--data_file", str(tmp_path / "classifier_data.h5"), "--used_flavor", "QCD",
        "--arch", arch, "--batch_size", "16"])  # a train split of 24 QCD rows
    hold_datamodules(shared_start["jax"].datamodule, shared_start["port"].datamodule)
    hold_first_step(shared_start)


LHCO_RUN = ["experiment=lhco/x_jet", "data.synthetic=true", "data.synthetic_num_events=300",
            "data.num_particles=12", "model.num_particles=12", "model.hidden_dim=16",
            "model.layers=2", "model.latent=4"]


@pytest.mark.parametrize("control", [False, True], ids=["generated", "control"])
def test_lhco_signal_region_mode_matches_jax(tmp_path, monkeypatch, shared_start, control):
    cfg = compose(CONFIG_DIR, "train", overrides=LHCO_RUN)
    jcfg = jax_compose(CONFIG_DIR, "train", overrides=LHCO_RUN)
    jdm2, pdm2 = jax_instantiate(jcfg["data"]), instantiate(cfg["data"])
    from particle_fm_tpu.utils import run_io as jrun_io
    from particle_fm_tpu_torch.utils import run_io as prun_io

    monkeypatch.setattr(jrun_io, "load_run", lambda *a, **k: (jcfg, jdm2, None, None))
    monkeypatch.setattr(prun_io, "load_run", lambda *a, **k: (cfg, pdm2, None, None))
    real, _ = pscript.lhco_sr_events(pdm2)
    rs = np.random.RandomState(1)  # the events lhco_chain.py writes: x and y jets, masks
    n_ev, n_p = 40, 16
    with h5py.File(tmp_path / "lhco_events.h5", "w") as f:
        mask = (np.arange(n_p)[None, :] < rs.randint(3, n_p + 1, (n_ev, 1))).astype(np.float32)
        for suffix in ("", "_y"):
            f[f"constituents{suffix}"] = (rs.randn(n_ev, n_p, 3) * mask[..., None]).astype(
                np.float32)
            f[f"mask{suffix}"] = mask
    argv = SCRIPT_ARGS + ["--gen_h5", str(tmp_path / "lhco_events.h5"), "--n_samples", "11"]
    tag = "control" if control else "sr"
    run_both(monkeypatch, tmp_path, argv + (["--control"] if control else []),
             out_name=f"classifier_test_sr_{tag}.yaml")
    assert len(real) >= 4 * 12  # enough signal-region events for both halves of the control
    hold_datamodules(shared_start["jax"].datamodule, shared_start["port"].datamodule)
    hold_first_step(shared_start)
