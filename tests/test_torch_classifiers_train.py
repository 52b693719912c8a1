"""PyTorch port, the classifier test through the entry points on the CPU: each
of the six shipped classifier experiments (jetclass_classifier (ParT),
_epic, _hl, _particlenet on the synthetic gen/sim pair with one flavour the
synthetic pair has; lhco/epic_classifier and lhco/hl_classifier from small
h5 files written here, as the JAX package reads them) trains through
`train.py` with `trainer=smoke` at narrow widths, and `ClassifierEvalCallback`
reports accuracy and AUROC every epoch and in the test pass; the callback
leaves the live network as it was (unfolded, its parameters untouched) and
reports what `binary_metrics` gives on the predictions of its copy.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from particle_fm_tpu_torch import train as ptrain
from particle_fm_tpu_torch.data.classifier import GenVsRealDataModule
from particle_fm_tpu_torch.eval.callbacks import ClassifierEvalCallback
from particle_fm_tpu_torch.models.classifiers import SetClassifierModel, binary_metrics
from particle_fm_tpu_torch.models.flow_matching import is_folded
from particle_fm_tpu_torch.training.step import make_optimizer
from particle_fm_tpu_torch.training.trainer import Trainer
from tests.torch_port_helpers import write_gen_vs_real_h5

JETCLASS = ["data.synthetic=true", "data.synthetic_num_jets=300", "data.synthetic_num_particles=12",
            "data.used_flavor=QCD"]  # the synthetic pair has 3 flavours: QCD, Hbb, Hcc
NARROW = {
    "jetclass_classifier": JETCLASS + [
        "model.num_particles=12", "model.net_config.embed_dims=[16,32,16]",
        "model.net_config.num_heads=2", "model.net_config.num_layers=1",
        "model.net_config.num_cls_layers=1", "model.net_config.pair_embed_dims=[8,8]"],
    "jetclass_classifier_epic": JETCLASS + [
        "model.num_particles=12", "model.net_config.hid_dim=16", "model.net_config.latent_dim=4",
        "model.net_config.equiv_layers=2"],
    "jetclass_classifier_hl": JETCLASS,
    "jetclass_classifier_particlenet": JETCLASS + [
        "model.num_particles=12", "model.net_config.conv_params=[[4,[8,8]],[4,[16,16]]]",
        "model.net_config.fc_params=[[16,0.1]]"],
    "lhco/epic_classifier": ["model.num_particles=16", "model.net_config.hid_dim=16",
                             "model.net_config.latent_dim=4", "model.net_config.equiv_layers=2"],
    "lhco/hl_classifier": [],
}


@pytest.mark.parametrize("experiment", list(NARROW))
def test_classifier_experiment_trains_and_reports_auroc(experiment, tmp_path):
    extra = list(NARROW[experiment])
    if experiment.startswith("lhco/"):
        extra += write_gen_vs_real_h5(tmp_path, flat="hl" in experiment)
    metrics, objs = ptrain.main([f"experiment={experiment}", "trainer=smoke",
                                 "trainer.max_epochs=2", "data.batch_size=32", "device=cpu",
                                 f"output_dir={tmp_path / 'run'}"] + extra)
    trainer = objs["trainer"]
    assert [type(cb) for cb in trainer.callbacks] == [ClassifierEvalCallback]
    assert [m["epoch"] for m in trainer.metrics_history] == [0, 1]
    for m in trainer.metrics_history:
        assert np.isfinite(m["train_loss"]) and np.isfinite(m["val_loss"])
        assert 0.0 <= m["accuracy"] <= 1.0 and 0.0 <= m["auroc"] <= 1.0
    assert 0.0 <= metrics["auroc"] <= 1.0  # the test pass on the best checkpoint
    assert not is_folded(trainer.state.net)


def _separable(n=240, parts=8, seed=0):
    rs = np.random.RandomState(seed)
    mask = np.ones((n, parts, 1), np.float32)
    return (rs.randn(n, parts, 3).astype(np.float32) + 1.0, mask,
            rs.randn(n, parts, 3).astype(np.float32) - 1.0, mask)


@pytest.mark.parametrize("n_classes", [1, 2])
def test_the_callback_reports_the_copy_and_moves_nothing(n_classes):
    real, rm, gen, gm = _separable()
    dm = GenVsRealDataModule(real=real, real_mask=rm, gen=gen, gen_mask=gm, batch_size=32)
    dm.setup()
    model = SetClassifierModel(arch="epic", n_classes=n_classes, num_particles=8, features=3,
                               net_config=dict(hid_dim=16, latent_dim=4, equiv_layers=1,
                                               dropout=0.1))
    cb = ClassifierEvalCallback(every_n_epochs=1)
    trainer = Trainer(model=model, datamodule=dm, optimizer=make_optimizer(lr=3e-3),
                      max_epochs=3, callbacks=[cb], verbose=False, device="cpu")
    trainer.fit()
    final = trainer.metrics_history[-1]
    assert final["auroc"] > 0.9 and final["accuracy"] > 0.8
    before = [p.detach().clone() for p in trainer.state.net.parameters()]
    out = cb(trainer)
    assert not is_folded(trainer.state.net)
    assert all(torch.equal(p, q) for p, q in zip(trainer.state.net.parameters(), before))
    net = trainer.state.net
    probs = np.concatenate([model.predict(net, torch.as_tensor(x), torch.as_tensor(m)).numpy()
                            for x, m, _ in dm.test_batches()])
    want = binary_metrics(probs if n_classes == 1 else probs[:, 1], dm.test.cond)
    assert out == pytest.approx(want, abs=1e-6)


def test_the_callback_gives_accuracy_alone_for_more_classes():
    real, rm, gen, gm = _separable(n=96)
    dm = GenVsRealDataModule(real=real, real_mask=rm, gen=gen, gen_mask=gm, batch_size=32)
    dm.setup()
    model = SetClassifierModel(arch="transformer", n_classes=3, num_particles=8, features=3,
                               net_config=dict(te_config={"model_dim": 16, "num_layers": 1}))
    trainer = Trainer(model=model, datamodule=dm, optimizer=make_optimizer(), max_epochs=1,
                      verbose=False, device="cpu")
    trainer.fit()
    out = ClassifierEvalCallback()(trainer)
    assert set(out) == {"accuracy"} and 0.0 <= out["accuracy"] <= 1.0
