"""PyTorch port, the JAX trainer's cache, prefetch and logger keys
(`cache_data_on_device`, `device_cache_limit_mb`, `prefetch_batches`,
`logger_kwargs` of training/trainer.py), the task helpers
(utils/helpers.py, utils/pylogger.py) and eval_ckpt's comparison plot, held
against the JAX package where it has the same behaviour.

- For each setting of the cache keys the port's Trainer places the train
  split on the device exactly where the JAX trainer does, on the same
  synthetic split; the streamed path hands prefetch the JAX trainer's depth
  (0: no worker), and both yield the same batches.
- `logger_kwargs` (and the `logger` group's keys through train.py) reach the
  backends; a key the Trainer does not declare still raises.
- `task_wrapper` writes `exec_error.log` with the traceback and raises again,
  as JAX's does; `count_parameters` and `print_config_tree` agree with JAX's.
- eval_ckpt writes `eval_ckpt_comparison.png` where matplotlib imports; with
  matplotlib hidden it writes the metrics and prints one line that names it.
"""

from __future__ import annotations

import os
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from particle_fm_tpu.data.jetnet import JetNetDataModule as JaxJetNet
from particle_fm_tpu.models.flow_matching import FlowMatchingModel as JaxModel
from particle_fm_tpu.parallel.train import make_optimizer as jax_make_optimizer
from particle_fm_tpu.training.trainer import Trainer as JaxTrainer
from particle_fm_tpu.utils import helpers as jhelpers
from particle_fm_tpu_torch import eval_ckpt as peval_ckpt
from particle_fm_tpu_torch import train as ptrain
from particle_fm_tpu_torch.data.jetnet import JetNetDataModule
from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel
from particle_fm_tpu_torch.training import step as pstep
from particle_fm_tpu_torch.training import trainer as ptrainer
from particle_fm_tpu_torch.training.trainer import Trainer
from particle_fm_tpu_torch.utils import helpers as phelpers
from tests.torch_port_helpers import SMALL

SPLIT = dict(synthetic=True, synthetic_num_jets=200, jet_type=["t"], num_particles=16,
             batch_size=32)
# the train split (140 jets of 16 particles: x and mask) is 0.032 MiB
CACHE_CASES = [dict(), dict(device_cache_limit_mb=0), dict(cache_data_on_device=False),
               dict(cache_data_on_device=True, device_cache_limit_mb=0),
               dict(cache_data_on_device=None, device_cache_limit_mb=1)]


@pytest.fixture(scope="module")
def splits():
    jdm, pdm = JaxJetNet(**SPLIT), JetNetDataModule(**SPLIT)
    jdm.setup()
    pdm.setup()
    np.testing.assert_array_equal(jdm.train.x, pdm.train.x)
    return jdm, pdm


def _trainers(splits, **kw):
    jdm, pdm = splits
    cfg = dict(SMALL, global_cond_dim=0, local_cond_dim=0)
    jt = JaxTrainer(model=JaxModel(**cfg), datamodule=jdm, optimizer=jax_make_optimizer(),
                    verbose=False, **kw)
    pt = Trainer(FlowMatchingModel(**cfg), pdm, pstep.make_optimizer(), device="cpu",
                 verbose=False, **kw)
    return jt, pt


@pytest.mark.parametrize("kw", CACHE_CASES,
                         ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "defaults")
def test_the_cache_choice_is_jax_s(splits, kw):
    jt, pt = _trainers(splits, **kw)
    want, got = jt._maybe_cache_train_data(), pt._maybe_cache_train_data()
    assert (got is None) == (want is None)
    if got is not None:  # JAX trims the split to a multiple of its devices
        n = len(want[0])
        np.testing.assert_array_equal(got[0].numpy()[:n], np.asarray(want[0]))


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_streamed_batches_take_the_prefetch_depth(splits, monkeypatch, depth):
    from particle_fm_tpu.data import prefetch as jprefetch

    seen = {}

    def recording(module, side):
        inner = module.prefetch_to_device

        def prefetch(iterator, place, depth):
            seen[side] = depth
            return inner(iterator, place, depth)
        monkeypatch.setattr(module, "prefetch_to_device", prefetch)

    recording(jprefetch, "jax")
    recording(ptrainer, "port")
    jt, pt = _trainers(splits, cache_data_on_device=False, prefetch_batches=depth)
    assert pt._maybe_cache_train_data() is None
    want = [np.asarray(b[0]) for b in jt._epoch_batches(None, 1)]
    got = [b[0].numpy() for b in pt._epoch_batches(None, 1)]
    assert seen == {"jax": depth, "port": depth}
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_logger_kwargs_reach_the_backends(splits, tmp_path):
    _, pdm = splits
    cfg = dict(SMALL, global_cond_dim=0, local_cond_dim=0)
    kw = {"jsonl": {"filename": "run.jsonl"}, "csv": {"filename": "run.csv"},
          "wandb": {"project": "unused"}}  # a backend not asked for: its entry is not read
    trainer = Trainer(FlowMatchingModel(**cfg), pdm, pstep.make_optimizer(), device="cpu",
                      verbose=False, log_dir=str(tmp_path), logger_kwargs=kw,
                      logger_backends=("jsonl", "csv"))
    trainer.logger.log_metrics({"loss": 1.5}, step=0)
    trainer.logger.close()
    assert yaml.safe_load(open(tmp_path / "run.jsonl")) == {"loss": 1.5}
    assert open(tmp_path / "run.csv").read().split() == ["loss", "1.5"]
    with pytest.raises(TypeError, match="no_such_argument"):
        Trainer(FlowMatchingModel(**cfg), pdm, pstep.make_optimizer(), device="cpu",
                verbose=False, log_dir=str(tmp_path), logger_backends=("csv",),
                logger_kwargs={"csv": {"no_such_argument": 1}})


def test_train_cli_takes_the_keys_and_refuses_others(tmp_path):
    base = ["experiment=jetnet/fm_tops30_cond", "data.synthetic=true",
            "data.synthetic_num_jets=200", "device=cpu", "callbacks=none"]
    from particle_fm_tpu_torch.config.core import compose

    cfg = compose(ptrain.CONFIG_DIR, "train", overrides=base + [
        "trainer.cache_data_on_device=false", "trainer.device_cache_limit_mb=64",
        "trainer.prefetch_batches=0", "logger=csv"])
    cfg["logger"]["csv"] = {"filename": "group.csv"}
    trainer = ptrain.build_trainer(cfg, str(tmp_path))
    assert (trainer.cache_data_on_device, trainer.device_cache_limit_mb,
            trainer.prefetch_batches) == (False, 64, 0)
    assert trainer.logger.loggers[0].path == os.path.join(str(tmp_path), "group.csv")
    cfg["trainer"]["logger_kwargs"] = {"csv": {"filename": "t.csv"}}  # on top of the group's
    trainer = ptrain.build_trainer(cfg, str(tmp_path))
    assert trainer.logger_kwargs == {"csv": {"filename": "t.csv"}}
    assert trainer.logger.loggers[0].path == os.path.join(str(tmp_path), "t.csv")
    cfg["trainer"]["no_such_key"] = 1
    with pytest.raises(NotImplementedError, match="no_such_key"):
        ptrain.build_trainer(cfg, None)


def test_task_wrapper_logs_and_raises_as_jax(tmp_path):
    def task(cfg):
        raise RuntimeError("the task failed here")

    for side, helpers in (("jax", jhelpers), ("port", phelpers)):
        out = tmp_path / side
        with pytest.raises(RuntimeError, match="failed here"):
            helpers.task_wrapper(task)({"output_dir": str(out)})
        log = open(out / "exec_error.log").read()
        assert "Traceback" in log and "RuntimeError: the task failed here" in log
    assert phelpers.task_wrapper(lambda cfg, k=0: cfg["a"] + k)({"a": 2}, k=1) == 3
    with pytest.raises(ValueError, match="unknown scheduler"):  # train.py main, wrapped
        ptrain.main(["experiment=jetnet/fm_tops30_cond", "data.synthetic=true",
                     "data.synthetic_num_jets=200", "device=cpu", "callbacks=none",
                     f"output_dir={tmp_path / 'run'}", "model.scheduler.name=no_such"])
    assert "Traceback" in open(tmp_path / "run" / "exec_error.log").read()


def test_count_parameters_and_config_tree_match_jax(capsys):
    cfg = dict(SMALL)
    variables = jax.eval_shape(JaxModel(**cfg).init, jax.random.PRNGKey(0))  # shapes suffice
    net = FlowMatchingModel(**cfg).init(device="cpu")
    assert phelpers.count_parameters(net) == jhelpers.count_parameters(variables["params"])
    tree = {"model": {"hidden_dim": 32, "layers": [1, 2]}, "seed": 3}
    jhelpers.print_config_tree(tree)
    want = capsys.readouterr().out
    phelpers.print_config_tree(tree)
    assert capsys.readouterr().out == want


@pytest.fixture(scope="module")
def imported_run(tmp_path_factory):
    """A run directory written by the import CLI from a seeded network."""
    from scripts import torch_import_reference_ckpt as pcli
    from tests.test_torch_port_reference_import import NARROW_RUN, lightning_state_dict

    tmp = tmp_path_factory.mktemp("eval_ckpt")
    from particle_fm_tpu_torch.config.core import compose
    from particle_fm_tpu_torch.utils.run_io import build_run

    _, model, _ = build_run(compose(ptrain.CONFIG_DIR, "train", overrides=NARROW_RUN))
    torch.save({"state_dict": lightning_state_dict(model.init(seed=4, device="cpu"))},
               tmp / "ref.ckpt")
    return pcli.main(["--ckpt", str(tmp / "ref.ckpt"), "--out", str(tmp / "run")] + NARROW_RUN)


def test_eval_ckpt_plots_where_matplotlib_imports(imported_run, monkeypatch, capsys):
    argv = ["--run_dir", imported_run, "--ckpt", "last", "--n_samples", "40", "--ode_steps", "2",
            "--device", "cpu"]
    png = os.path.join(imported_run, "eval_ckpt_comparison.png")
    metrics = peval_ckpt.main(argv)
    assert os.path.getsize(png) > 0
    os.remove(png)
    os.remove(os.path.join(imported_run, "eval_metrics.yaml"))
    for name in [m for m in sys.modules if m.startswith("matplotlib")] + [
            "particle_fm_tpu_torch.eval.plotting"]:
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    capsys.readouterr()
    again = peval_ckpt.main(argv)  # from the cached samples
    out = capsys.readouterr().out
    assert f"matplotlib is not installed: not writing the plot {png}" in out
    assert not os.path.exists(png)
    written = yaml.safe_load(open(os.path.join(imported_run, "eval_metrics.yaml")))
    assert written == {k: float(v) for k, v in again.items()}
    assert again["generation_time"] == metrics["generation_time"]  # the cached samples
