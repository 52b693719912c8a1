"""PyTorch port, a guard over every shipped experiment: composed from
`configs/experiment/` with `data.synthetic=true` (the LHCO classifiers:
with small h5 files) and `device=cpu`, each
builds its callbacks, datamodule (set up), model, optimizer, Trainer and
network in the port: every one of them is ported.

Then the card machine's installation, checked here: in a subprocess where
`sklearn`, `h5py` and `matplotlib` cannot be imported, the GenChallenge
experiment builds and its callback, which plots by default, raises an
ImportError that names matplotlib when it comes to plot, the CaloChallenge datamodule (with
its scaler, fitted, and the rotation) builds and its scaler round-trips the
hits, the JetClass datamodule builds from its in-memory synthetic splits,
so does the JetClass classifier datamodule, whose EPiC discriminator
predicts and whose AUROC is computed without sklearn, the training and
evaluation entry points import, and no module of jax,
flax, optax or the JAX package is loaded.
"""

from __future__ import annotations

import glob
import os
import subprocess
import sys

import pytest

from particle_fm_tpu_torch import train as ptrain
from particle_fm_tpu_torch.config.core import compose
from particle_fm_tpu_torch.training.step import create_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERIMENTS = sorted(os.path.relpath(p, os.path.join(ROOT, "configs", "experiment"))[:-5]
                     for p in glob.glob(os.path.join(ROOT, "configs", "experiment", "**", "*.yaml"),
                                        recursive=True))
# the synthetic gen/sim pair of the JetClass classifier data has 3 flavours
# (the experiments pick Tbqq); the LHCO classifiers read h5 files, which
# `_overrides` writes, as the JAX package has no synthetic mode there
JETCLASS_CLASSIFIERS = ("jetclass_classifier", "jetclass_classifier_epic",
                        "jetclass_classifier_hl", "jetclass_classifier_particlenet")
LHCO_CLASSIFIERS = ("lhco/epic_classifier", "lhco/hl_classifier")


def _overrides(experiment: str, tmp_path) -> list[str]:
    if experiment in LHCO_CLASSIFIERS:
        from tests.torch_port_helpers import write_gen_vs_real_h5

        return write_gen_vs_real_h5(tmp_path, flat=experiment == "lhco/hl_classifier")
    extra = ["data.synthetic=true"]
    if experiment in JETCLASS_CLASSIFIERS:
        extra.append("data.used_flavor=QCD")
    return extra


def test_the_list_covers_every_experiment():
    assert len(EXPERIMENTS) == 36
    assert {"gen_challenge/gen_challenge", "lhco/jet_features",
            "jetnet/fm_moe_transformer"} < set(EXPERIMENTS)


@pytest.mark.parametrize("experiment", EXPERIMENTS)
def test_experiment_builds_or_names_what_is_missing(experiment, tmp_path):
    cfg = compose(ptrain.CONFIG_DIR, "train",
                  [f"experiment={experiment}", "device=cpu"] + _overrides(experiment, tmp_path))

    trainer = ptrain.build_trainer(cfg)
    state = create_train_state(trainer.model, trainer.optimizer, device="cpu")
    dm = trainer.datamodule
    assert len(dm.train) > 0 and trainer.device.type == "cpu"
    assert sum(p.numel() for p in state.net.parameters()) > 0
    assert all(callable(cb) for cb in trainer.callbacks)


CARD_INSTALLATION = r"""
import sys
sys.modules["sklearn"] = None  # as on the card's machine: none of the three is installed
sys.modules["h5py"] = None
sys.modules["matplotlib"] = None
import numpy as np
import pytest
from particle_fm_tpu_torch.data.calo import CaloChallengeDataModule
from particle_fm_tpu_torch.data.calo_scalers import default_calo_scaler
from particle_fm_tpu_torch.data.jetclass import JetClassDataModule
import particle_fm_tpu_torch.train, particle_fm_tpu_torch.evaluate, particle_fm_tpu_torch.eval_ckpt

calo = CaloChallengeDataModule(synthetic=True, synthetic_num_showers=100, max_hits=64,
                               bucket_multiple=16, rotate_alpha=True, batch_size=16,
                               scaler=default_calo_scaler())
calo.setup()
assert len(list(calo.train_batches(seed=1))) == calo.steps_per_epoch
raw = np.concatenate(calo._raw_splits["test"])
back = calo.scaler.inverse_transform(calo.scaler.transform(raw))
np.testing.assert_array_equal(back[:, 1:], raw[:, 1:])  # dequantised bins floor back
np.testing.assert_allclose(back[:, 0], raw[:, 0], rtol=1e-5)
jets = JetClassDataModule(synthetic=True, synthetic_num_jets=64, synthetic_num_particles=16,
                          conditioning_jet_type_all=True)
jets.setup()
assert jets.train.x.shape == (64, 16, 3) and jets.train.cond.shape == (64, 12)
import torch
from particle_fm_tpu_torch.data.jetclass_classifier import JetClassClassifierDataModule
from particle_fm_tpu_torch.models.classifiers import SetClassifierModel, binary_metrics
clf = JetClassClassifierDataModule(synthetic=True, synthetic_num_jets=200,
                                   synthetic_num_particles=16, used_flavor="QCD")
clf.setup()
model = SetClassifierModel(features=clf.train.x.shape[-1], num_particles=16,
                           net_config=dict(hid_dim=8, latent_dim=2, equiv_layers=1))
net = model.init(device="cpu")
probs = model.predict(net, torch.as_tensor(clf.test.x), torch.as_tensor(clf.test.mask))
assert 0.0 <= binary_metrics(probs.numpy(), clf.test.cond)["auroc"] <= 1.0
from particle_fm_tpu_torch import train as ptrain
from particle_fm_tpu_torch.config.core import compose
from particle_fm_tpu_torch.training.step import create_train_state
cfg = compose(ptrain.CONFIG_DIR, "train", [
    "experiment=gen_challenge/gen_challenge", "data.synthetic=true", "device=cpu",
    "data.synthetic_num_events=500", "callbacks.gen_challenge_eval.num_samples=8",
    "callbacks.gen_challenge_eval.ode_steps=2"])
trainer = ptrain.build_trainer(cfg)
trainer.state = create_train_state(trainer.model, trainer.optimizer, device="cpu")
trainer.testing = True
cb = trainer.callbacks[0]
assert cb.make_plots and cb.split == "val"
with pytest.raises(ImportError, match="matplotlib"):
    cb(trainer)
bad = [m for m, mod in sys.modules.items() if mod is not None
       and m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "particle_fm_tpu", "sklearn",
                               "h5py", "matplotlib")]
assert not bad, bad
print("ok")
"""


def test_the_data_paths_need_neither_sklearn_nor_h5py():
    """... nor matplotlib, until a run plots."""
    out = subprocess.run([sys.executable, "-c", CARD_INSTALLATION], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]
