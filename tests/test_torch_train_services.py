"""PyTorch port, the training loop's services on the CPU:

- `training/checkpoint.py::load_weights_from` against the JAX package's on
  the same state: the parameters and the EMA from the file, the AdamW
  moments and the step fresh, to the bit; through `Trainer.fit`;
- `should_stop` (set by a callback) ends `fit` after the epoch's
  checkpoints, `last` saved at the stop, at the epoch where the JAX trainer
  stops, with and without fused epochs; a second `fit` starts afresh;
- asynchronous checkpoints (`async_save`, the default) are the bytes of
  synchronous ones, `last` and the top-k of a monitor alike, the state
  snapshotted at the call;
- the `debug` presets through the CLI: `debug=default` trains under
  `torch.autograd.detect_anomaly` on the per-step path, `debug=profiler`
  writes its `torch.profiler` trace;
- `DeviceStatsCallback` gives None on the CPU, as the JAX one there;
- the `tensorboard` logger backend writes the scalars under `<log_dir>/tb`,
  and without the `tensorboard` package raises an ImportError naming it;
- `scripts/torch_hparam_search.py` runs 2 tiny trials with `--prune`.
"""

from __future__ import annotations

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.parallel import train as jtrain
from particle_fm_tpu.training import checkpoint as jckpt
from particle_fm_tpu.training.trainer import Trainer as JaxTrainer
from particle_fm_tpu_torch import train as ptrain
from particle_fm_tpu_torch.eval.callbacks import DeviceStatsCallback
from particle_fm_tpu_torch.training import checkpoint as pckpt
from particle_fm_tpu_torch.training import step as pstep
from particle_fm_tpu_torch.training.loggers import MultiLogger
from particle_fm_tpu_torch.training.trainer import Trainer
from particle_fm_tpu_torch.utils.from_jax import load_flax_train_state
from tests.test_torch_train_scan import LR, MODEL, PortModel, datamodule, port_fit
from tests.torch_port_helpers import grads_by_name, model_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = ["experiment=jetnet/fm_tops30_cond", "data.synthetic=true", "data.synthetic_num_jets=512",
       "trainer=smoke", "model.scheduler.name=constant", "device=cpu", "callbacks=none",
       "model.hidden_dim=16", "model.latent=4", "model.layers=2", "data.batch_size=64",
       "trainer.max_epochs=1"]


def trained_pair():
    """A JAX TrainState that has moved away from its start (parameters,
    EMA, moments, step) and the port's copy of it."""
    jm, variables, pm, _ = model_pair(MODEL, fill=0.2)
    jopt = jtrain.make_optimizer(lr=LR)
    params = variables["params"]
    rs = np.random.RandomState(1)
    state = jtrain.create_train_state(jm, jax.random.PRNGKey(0), jopt)
    mu = jax.tree_util.tree_map(lambda a: jnp.asarray(rs.randn(*a.shape), jnp.float32), params)
    adam = state.opt_state[1][0]._replace(mu=mu, count=jnp.asarray(7, jnp.int32))
    state = state.replace(params=params, step=jnp.asarray(7, jnp.int32),
                          ema_params=jax.tree_util.tree_map(lambda a: a * 0.5, params),
                          opt_state=(state.opt_state[0], (adam,) + state.opt_state[1][1:]))
    port = load_flax_train_state(pstep.create_train_state(pm, pstep.make_optimizer(lr=LR),
                                                          device="cpu"), state)
    return jm, jopt, state, pm, port


def test_load_weights_from_matches_jax(tmp_path):
    jm, jopt, jtrained, pm, ptrained = trained_pair()
    jmgr = jckpt.CheckpointManager(str(tmp_path / "jax"), async_save=False)
    jpath = jmgr.save_last(jtrained)
    ppath = pckpt.CheckpointManager(str(tmp_path / "port")).save_last(ptrained)
    jfresh = jtrain.create_train_state(jm, jax.random.PRNGKey(3), jopt)
    pfresh = load_flax_train_state(pstep.create_train_state(pm, pstep.make_optimizer(lr=LR),
                                                            device="cpu"), jfresh)
    jloaded = jckpt.load_weights_from(jpath, jfresh)
    ploaded = pckpt.load_weights_from(ppath, pfresh)
    assert ploaded.step == int(jloaded.step) == 0
    names = [n for n, _ in ploaded.net.named_parameters()]
    for got, tree in ((ploaded.params(), jloaded.params), (ploaded.ema_params,
                                                            jloaded.ema_params)):
        want = grads_by_name(tree)
        for name, g in zip(names, got):
            np.testing.assert_array_equal(g.detach().numpy(), want[name], err_msg=name)
    adam = jloaded.opt_state[1][0]
    assert int(adam.count) == 0
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        want = grads_by_name(tree)
        for name, p in zip(names, ploaded.params()):
            np.testing.assert_array_equal(ploaded.opt_state.state[p][key].numpy(), want[name])
    # through fit: an epoch of 3 steps from step 0 and the file's weights
    seen = {}

    def first_epoch(tr):
        seen.setdefault("step", tr.state.step)
        return {}

    trainer = Trainer(model=PortModel(**MODEL), datamodule=datamodule(), device="cpu",
                      optimizer=pstep.make_optimizer(lr=0.0), max_epochs=1, verbose=False,
                      callbacks=[first_epoch])
    trainer.fit(load_weights_from=ppath)
    assert seen["step"] == 3
    for a, b in zip(trainer.state.params(), ptrained.params()):  # lr 0: the weights stay
        assert torch.equal(a, b)


@pytest.mark.parametrize("fuse", [1, 2])
def test_should_stop_ends_fit_after_the_checkpoints_where_jax_stops(tmp_path, fuse):
    def stop_at_epoch_1(trainer):
        if trainer.epoch >= 1:
            trainer.should_stop = True
        return {}

    port = port_fit(tmp_path / "port", max_epochs=50, fuse_epochs=fuse,
                    callbacks=[stop_at_epoch_1], save_last_every_n_epoch=10)
    jdm = datamodule(True)
    jm = model_pair(MODEL)[0]
    ref = JaxTrainer(model=jm, datamodule=jdm, optimizer=jtrain.make_optimizer(lr=LR),
                     max_epochs=50, fuse_epochs=fuse, callbacks=[stop_at_epoch_1],
                     ckpt_dir=str(tmp_path / "jax"), save_last_every_n_epoch=10, verbose=False)
    ref.fit()
    assert port.epoch == ref.epoch == 1
    assert [m["epoch"] for m in port.metrics_history] == \
        [m["epoch"] for m in ref.metrics_history]
    assert port.state.step == int(ref.state.step) == 2 * 3
    last = torch.load(port.ckpt.last_path(), weights_only=True)
    assert last["step"] == port.state.step  # `last` written at the stop
    assert os.path.isdir(ref.ckpt.last_path())
    port.callbacks = []
    port.max_epochs = 3
    port.fit(resume_from=port.ckpt.last_path())  # a second fit does not stop at once
    assert port.epoch == 2 and port.state.step == 3 * 3


def test_async_checkpoints_are_the_bytes_of_synchronous_ones(tmp_path):
    state = trained_pair()[4]
    managers = {mode: pckpt.CheckpointManager(str(tmp_path / mode), {"val_loss": "min"},
                                              top_k=2, async_save=mode == "async")
                for mode in ("async", "sync")}
    for mgr in managers.values():
        assert mgr.save_metric(state, "val_loss", 3.0, 7) is not None
        mgr.save_last(state)
    with torch.no_grad():  # the snapshot was taken at the call
        for p in state.params():
            p.add_(1.0)
    for step, value in ((8, 2.0), (9, 5.0), (10, 1.0)):
        for mgr in managers.values():
            mgr.save_metric(state, "val_loss", value, step)
    for mgr in managers.values():
        mgr.flush()
    for rel in ("last.pt", "val_loss"):
        a, b = tmp_path / "async" / rel, tmp_path / "sync" / rel
        if rel.endswith(".pt"):
            assert a.read_bytes() == b.read_bytes()
            continue
        assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == [
            "step_10_metric_1.000000.pt", "step_8_metric_2.000000.pt"]
        for name in os.listdir(a):
            assert (a / name).read_bytes() == (b / name).read_bytes()
    loaded = torch.load(tmp_path / "async" / "last.pt", weights_only=True)
    assert loaded["step"] == 7
    assert torch.equal(next(iter(loaded["params"].values())) + 1.0, state.params()[0].detach())


def test_debug_presets_through_the_cli(tmp_path, monkeypatch):
    entered = []
    anomaly = torch.autograd.detect_anomaly

    class Recorded(anomaly):
        def __enter__(self):
            entered.append(True)
            return super().__enter__()

    monkeypatch.setattr(torch.autograd, "detect_anomaly", Recorded)
    _, objects = ptrain.main(CLI + ["debug=default", f"output_dir={tmp_path / 'nans'}"])
    trainer = objects["trainer"]
    assert entered and not trainer.scan_epochs and trainer.state.step == 5
    _, objects = ptrain.main(CLI + ["debug=profiler", f"output_dir={tmp_path / 'prof'}"])
    trace = os.path.join(str(tmp_path / "prof"), "profile", "trace.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert objects["trainer"].scan_epochs and len(events) > 100
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_device_stats_is_none_on_the_cpu():
    class T:
        epoch, device, testing = 0, "cpu", False

    assert DeviceStatsCallback()(T()) is None
    T.testing = True
    assert DeviceStatsCallback(every_n_epochs=5, on_test=True)(T()) is None


def test_tensorboard_backend_writes_events(tmp_path, monkeypatch):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    logger = MultiLogger(str(tmp_path), backends=("jsonl", "tensorboard"))
    for epoch in range(3):
        logger.log_metrics({"epoch": epoch, "train_loss": 1.0 / (epoch + 1)}, step=epoch)
    logger.close()
    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    got = [(e.step, e.value) for e in acc.Scalars("train_loss")]
    assert got == [(0, 1.0), (1, 0.5), (2, pytest.approx(1 / 3))]
    assert os.path.exists(tmp_path / "metrics.jsonl")
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="`tensorboard` package"):
        MultiLogger(str(tmp_path / "missing"), backends=("tensorboard",))


def test_hparam_search_script_runs_two_pruned_trials(tmp_path, monkeypatch):
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_hparam_search

    out = tmp_path / "results.json"
    ranked = torch_hparam_search.main([
        "--experiment", "jetnet/fm_tops30_cond", "--metric", "val_loss", "--n_trials", "2",
        "--prune", "--prune-startup-trials", "1", "--space", "model.layers=1,2",
        "--space-log", "model.optimizer.lr=1e-4:1e-2", "--out", str(out),
        "--overrides", "device=cpu", "data.synthetic=true", "data.synthetic_num_jets=128",
        "data.batch_size=64", "data.num_particles=8", "model.num_particles=8",
        "model.hidden_dim=16", "model.latent=4", "model.scheduler.name=constant",
        "trainer=smoke", "trainer.max_epochs=2",
        "callbacks=none", f"output_dir={tmp_path}/run"])
    assert len(ranked) == 2 and {r["trial"] for r in ranked} == {0, 1}
    assert all(np.isfinite(r["val_loss"]) for r in ranked)
    assert json.loads(out.read_text()) == ranked
