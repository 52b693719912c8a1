"""PyTorch port, the scanned and fused epochs (training/epochs.py through
training/trainer.py) on the CPU, where a run of steps is the plain loop of
the body that the card replays as a captured graph:

- `scan_epochs=True` trains to the same bits as the per-step path, with the
  generator's own draws (each step seeded from (seed + 1, step) on both
  paths), with and without accumulation;
- against the JAX package's Trainer (scanned, fused, the partial group,
  accumulation) from the same initial state, with every draw of t and the
  noise pinned to one array a shape (`pin_fixed_draws`: the jitted JAX epoch
  takes its draws once, at its trace): each logged train_loss and val_loss
  rtol 1e-5, and the parameters and the EMA within the trajectory tests'
  bound (tests/test_torch_train_step.py), 0.02 times the summed learning
  rates, 99% of the entries within 1e-3 of that;
- fused groups align to multiples of fuse_epochs: 4 epochs in groups of 2
  validated every 2, 5 epochs in groups of 3 and 2, a run resumed mid-group
  (a short first group) ends where the uninterrupted one ends, to the bit;
- `make_train_epoch` over stacked (K, B, ...) and (K, A, B, ...) batches
  against JAX's `make_train_epoch` (losses rtol 1e-5, the parameters within
  the trajectory bound) and the port's per-step path, to the bit;
- the per-step rule: OT-CFM with the exact pairing takes the per-step path,
  said once in the log.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from particle_fm_tpu.data.jetnet import JetNetDataModule as JaxJetNet
from particle_fm_tpu.parallel import train as jtrain
from particle_fm_tpu.training.trainer import Trainer as JaxTrainer
from particle_fm_tpu_torch.data.jetnet import JetNetDataModule
from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel as PortModel
from particle_fm_tpu_torch.training import step as pstep
from particle_fm_tpu_torch.training.epochs import make_train_epoch, step_seed
from particle_fm_tpu_torch.training.trainer import Trainer
from particle_fm_tpu_torch.utils.from_jax import load_flax_train_state
from tests.torch_port_helpers import grads_by_name, model_pair, pin_fixed_draws

LR = 1e-3
# 321 jets: a train split of 224 sets, which the JAX trainer's 8-device CPU
# mesh does not trim, so both trainers shuffle the same sets
DATA = dict(jet_type=("t",), num_particles=8, batch_size=64, synthetic=True,
            synthetic_num_jets=321)
# the JAX trainer test's model (tests/test_trainer.py), sincos time: the cosine
# ladder's field is chaotic in t, and jit rounds its products otherwise
MODEL = dict(model="epic", features=3, num_particles=8, hidden_dim=16, latent=4, layers=1,
             frequencies=6, loss_type="CFM", t_emb="sincos", global_cond_dim=5,
             local_cond_dim=5)


def datamodule(jax_side: bool = False, **kw):
    dm = (JaxJetNet if jax_side else JetNetDataModule)(**dict(DATA, **kw))
    dm.setup()
    assert dm.num_cond_features == MODEL["global_cond_dim"]
    return dm


def port_fit(tmp_path=None, state=None, resume=None, **kw):
    kw.setdefault("save_last_every_n_epoch", 1)
    trainer = Trainer(model=PortModel(**MODEL), datamodule=datamodule(
        batch_size=kw.pop("batch_size", 64)), optimizer=pstep.make_optimizer(lr=LR),
        device="cpu", verbose=False, ckpt_dir=None if tmp_path is None else str(tmp_path), **kw)
    trainer.fit(resume_from=resume, initial_state=state)
    return trainer


def tensors(state) -> list[torch.Tensor]:
    opt = state.opt_state.state
    return ([p.detach() for p in state.params()] + list(state.ema_params)
            + [opt[p][k] for p in state.params() for k in ("exp_avg", "exp_avg_sq")])


def assert_same_bits(a, b) -> None:
    assert a.state.step == b.state.step
    for x, y in zip(tensors(a.state), tensors(b.state), strict=True):
        assert torch.equal(x, y)
    assert [m["train_loss"] for m in a.metrics_history] == \
        [m["train_loss"] for m in b.metrics_history]


@pytest.mark.parametrize("accum", [1, 2])
def test_scanned_epochs_equal_the_per_step_path_bit_for_bit(accum):
    kw = dict(max_epochs=2, accumulate_grad_batches=accum, batch_size=64 // accum)
    scanned, per_step = port_fit(scan_epochs=True, **kw), port_fit(scan_epochs=False, **kw)
    assert scanned.train_superepoch is not None and per_step.train_superepoch is None
    assert scanned.state.step == 2 * 3  # 3 optimizer steps an epoch either way
    assert_same_bits(scanned, per_step)
    assert scanned.last_metrics["val_loss"] == per_step.last_metrics["val_loss"]


def states():
    """The JAX initial TrainState and the port's, carried across."""
    jm, variables, pm, _ = model_pair(MODEL)
    jopt = jtrain.make_optimizer(lr=LR)
    jstate = jtrain.create_train_state(jm, jax.random.PRNGKey(0), jopt)
    jstate = jstate.replace(params=variables["params"],
                            ema_params=jax.tree_util.tree_map(np.copy, variables["params"]))
    opt = pstep.make_optimizer(lr=LR)
    pstate = load_flax_train_state(pstep.create_train_state(pm, opt, device="cpu"), jstate)
    return jm, jopt, jstate, pstate


def jax_fit(jm, jopt, jstate, tmp_path, **kw):
    accum = kw.get("accumulate_grad_batches", 1)
    trainer = JaxTrainer(model=jm, datamodule=datamodule(True, batch_size=64 // accum),
                         optimizer=jopt, callbacks=[], ckpt_dir=None, log_dir=str(tmp_path),
                         verbose=False, **kw)
    trainer.fit(initial_state=jstate)
    return trainer


def assert_close_to_jax(port, ref, n_steps: int) -> None:
    assert port.state.step == int(np.asarray(ref.state.step)) == n_steps
    assert [m["epoch"] for m in port.metrics_history] == [m["epoch"] for m in ref.metrics_history]
    for mine, want in zip(port.metrics_history, ref.metrics_history):
        for key in ("train_loss", "val_loss"):
            assert (key in mine) == (key in want), key
            if key in want:
                np.testing.assert_allclose(mine[key], want[key], rtol=1e-5, err_msg=key)
    tol = 0.02 * LR * n_steps
    names = [n for n, _ in port.state.net.named_parameters()]
    diffs = []
    for got, tree in ((port.state.params(), ref.state.params),
                      (port.state.ema_params, ref.state.ema_params)):
        want = grads_by_name(tree)
        for name, g in zip(names, got):
            np.testing.assert_allclose(g.detach().numpy(), want[name], atol=tol, err_msg=name)
            diffs.append(np.abs(g.detach().numpy() - want[name]).ravel())
    assert np.quantile(np.concatenate(diffs), 0.99) <= 1e-3 * tol


JAX_CASES = {
    "scanned": (dict(max_epochs=2), 6),
    "fused 2 of 4, val every 2": (dict(max_epochs=4, fuse_epochs=2, check_val_every_n_epoch=2),
                                  12),
    "partial group, 5 in groups of 3": (dict(max_epochs=5, fuse_epochs=3,
                                             check_val_every_n_epoch=100), 15),
    "accumulation 2": (dict(max_epochs=2, accumulate_grad_batches=2), 6),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_scanned_and_fused_epochs_match_the_jax_trainer(monkeypatch, tmp_path, case):
    kw, n_steps = JAX_CASES[case]
    pin_fixed_draws(monkeypatch, seed=3)
    jm, jopt, jstate, pstate = states()
    ref = jax_fit(jm, jopt, jstate, tmp_path, **kw)
    accum = kw.get("accumulate_grad_batches", 1)
    port = port_fit(state=pstate, batch_size=64 // accum, **kw)
    assert_close_to_jax(port, ref, n_steps)
    fused = kw.get("fuse_epochs", 1)
    if fused > 1:  # groups aligned to multiples of fuse_epochs, the last one short
        want = [e for e in range(kw["max_epochs"])
                if (e + 1) % fused == 0 or e == kw["max_epochs"] - 1]
        assert [m["epoch"] for m in port.metrics_history] == want
        sequential = port_fit(state=states()[3], **dict(kw, fuse_epochs=1))
        assert sequential.state.step == port.state.step
        for x, y in zip(tensors(port.state), tensors(sequential.state), strict=True):
            assert torch.equal(x, y)
        assert port.last_metrics["train_loss"] == sequential.last_metrics["train_loss"]


@pytest.mark.parametrize("accum", [1, 2])
def test_train_epoch_over_stacked_batches_matches_jax_and_the_per_step_path(monkeypatch,
                                                                           accum):
    pin_fixed_draws(monkeypatch, seed=5)
    jm, jopt, jstate, pstate = states()
    k, b = 3, 32
    row = (k, accum, b) if accum > 1 else (k, b)
    split = datamodule().train
    xs, ms, cs = (np.ascontiguousarray(a[:k * accum * b]).reshape(row + a.shape[1:])
                  for a in (split.x, split.mask, split.cond))
    jstate, jlosses = jtrain.make_train_epoch(jm, jopt, ema_decay=0.9, accum=accum)(
        jstate, jax.random.PRNGKey(0), xs, ms, cs)
    opt = pstep.make_optimizer(lr=LR)
    losses = make_train_epoch(PortModel(**MODEL), opt, ema_decay=0.9, accum=accum, seed=4)(
        pstate, *(torch.from_numpy(a) for a in (xs, ms, cs)))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-5)
    assert pstate.step == int(jstate.step) == k
    want = grads_by_name(jstate.params)
    for (name, p) in pstate.net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=0.02 * LR * k,
                                   err_msg=name)
    per_step = states()[3]
    step = pstep.make_train_step(PortModel(**MODEL), opt, ema_decay=0.9, accum=accum)
    gen = torch.Generator()
    for i in range(k):
        gen.manual_seed(step_seed(4, per_step.step))
        loss = step(per_step, gen, *(torch.from_numpy(a[i]) for a in (xs, ms, cs)))
        assert torch.equal(loss.reshape(()), losses[i])
    for x, y in zip(tensors(pstate), tensors(per_step), strict=True):
        assert torch.equal(x, y)


def test_a_run_resumed_mid_group_ends_where_the_uninterrupted_one_ends(tmp_path):
    first = port_fit(tmp_path / "first", max_epochs=2, fuse_epochs=3)
    assert [m["epoch"] for m in first.metrics_history] == [1]  # a group cut by max_epochs
    last = first.ckpt.last_path()
    resumed = port_fit(tmp_path / "resumed", resume=last, max_epochs=5, fuse_epochs=3)
    assert [m["epoch"] for m in resumed.metrics_history] == [2, 4]  # a short first group
    straight = port_fit(tmp_path / "straight", max_epochs=5, fuse_epochs=3)
    assert [m["epoch"] for m in straight.metrics_history] == [2, 4]
    assert resumed.state.step == straight.state.step == 5 * 3
    for x, y in zip(tensors(resumed.state), tensors(straight.state), strict=True):
        assert torch.equal(x, y)
    assert resumed.last_metrics["train_loss"] == straight.last_metrics["train_loss"]


def test_exact_ot_pairing_takes_the_per_step_path(capsys):
    cfg = dict(MODEL, loss_type="CFM-OT", ot_config={"ot_method": "exact"})
    trainer = Trainer(model=PortModel(**cfg), datamodule=datamodule(),
                      optimizer=pstep.make_optimizer(lr=LR), device="cpu", max_epochs=1)
    assert not trainer.scan_epochs and trainer.train_superepoch is None
    assert "ot_method=exact" in trainer.per_step_reason
    out = capsys.readouterr().out
    assert out.count("scan_epochs off") == 1 and "per step" in out
    trainer.fit()
    assert trainer.state.step == 3 and np.isfinite(trainer.last_metrics["train_loss"])
    sinkhorn = Trainer(model=PortModel(**dict(cfg, ot_config={"ot_method": "sinkhorn"})),
                       datamodule=datamodule(), optimizer=pstep.make_optimizer(lr=LR),
                       device="cpu", verbose=False)
    assert sinkhorn.scan_epochs and sinkhorn.per_step_reason is None
