"""Training entry point; counterpart of particle_fm_tpu/train.py.

    python -m particle_fm_tpu_torch.train experiment=jetnet/fm_tops150_cond \
        data.synthetic=true [key=value ...] [device=cpu]

Composes the same `configs/` (the JAX package's `_target_` classes built as
the port's), snapshots the resolved config into the run directory, builds
the datamodule, the model and the callbacks, pops `optimizer`/`scheduler`
from the model block and `grad_clip`/`ema` from the trainer block, converts
an epoch-denominated schedule with the optimizer steps of an epoch, runs
`Trainer.fit` (from `load_weights_from`'s parameters and EMA when it is
given), with `test: true` runs `Trainer.test` on the best checkpoint (of
`w1m_mean` when it is monitored), and writes `final_metrics.yaml`.
Training and evaluation run on the card unless `device=cpu` is given;
without CUDA they raise. `train(cfg, extra_callbacks=...)` adds callbacks
that a config cannot name (the hyperparameter search's pruning callback,
scripts/torch_hparam_search.py).

The `debug` presets (configs/debug/): `debug_nans` runs training under
`torch.autograd.detect_anomaly` and `disable_jit` on the eager per-step path
(both turn `scan_epochs` off: anomaly mode reads the host at every
backward), and `profiler_dir` records the run with `torch.profiler` and
writes its trace to `<profiler_dir>/trace.json`.

The JetNet, LHCO (`lhco`, `lhco_whole_event`), CaloChallenge (`calo`),
classifier (`classifier`), flat (`flat_eval`) and GenChallenge
(`gen_challenge`) eval callbacks and `device_stats` are ported; the
classifier models train as the generators do (labels in `cond`), and the
flat models on (B, F) batches without a mask. A callback the port lacks
raises through config/core.py. An entry without a `_target_`, as an
experiment overlay leaves after `callbacks=none`, is skipped, as in the JAX
package. The `logger` group's `backends` names the logger backends and its
other keys are their init arguments (`logger_kwargs`, with
`trainer.logger_kwargs` on top); `trainer.cache_data_on_device`,
`device_cache_limit_mb` and `prefetch_batches` choose the device cache or
the stream as in the JAX trainer. A trainer key the port's Trainer does not
declare raises NotImplementedError. `main` runs the task under
utils/helpers.py::task_wrapper: a failed run appends its traceback to
`<output_dir>/exec_error.log` and raises again.

Across processes, every rank runs the same command:

    torchrun --nproc_per_node=W -m particle_fm_tpu_torch.train trainer.strategy=dp ...

The process group starts (parallel/dist.py: torchrun's environment,
`trainer.multihost=true` or PFM_MULTIHOST=1; NCCL on the card, gloo with
`device=cpu`, or PFM_DIST_BACKEND=gloo for several ranks on one card)
before the Trainer is built; `trainer.strategy` is `dp`, `fsdp`, or, on a
(data, model) mesh of W / `trainer.model_axis_size` x model_axis_size
ranks (default 2, as in the JAX trainer; `configs/` does not set it),
`dp_tp`, `sp` or `dp_ep` (parallel/mesh.py, parallel/tp.py), or, over
`trainer.model_axis_size` pipeline stages of the droid full transformer's
layers and `trainer.pp_microbatches` microbatches, `pp` (W stages) or
`dp_pp` (W / stages pipelines) (parallel/pp.py). Rank 0 names the run directory and writes the config, the
logs, the checkpoints (the single-process format, gathered) and
`final_metrics.yaml`; every rank trains and evaluates.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time

from particle_fm_tpu_torch.config.core import compose, instantiate, save_config
from particle_fm_tpu_torch.parallel import dist
from particle_fm_tpu_torch.training.trainer import Trainer
from particle_fm_tpu_torch.utils.device import resolve_device
from particle_fm_tpu_torch.utils.run_io import build_run

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def build_callbacks(callbacks_cfg: dict | None) -> list:
    """Instantiate callback entries; entries without a `_target_` (e.g. an
    experiment overlay patching a callback after `callbacks=none` removed the
    group) are skipped with a warning instead of crashing the run."""
    out = []
    for name, cb_cfg in (callbacks_cfg or {}).items():
        if not isinstance(cb_cfg, dict) or "_target_" not in cb_cfg:
            print(f"[train] skipping callback {name!r}: no _target_ (group overridden?)")
            continue
        out.append(instantiate(cb_cfg))
    return out


def build_trainer(cfg: dict, out_dir: str | None = None,
                  extra_callbacks: list | None = None) -> Trainer:
    """The Trainer of a composed config: its callbacks built (then
    `extra_callbacks`), its datamodule set up, its model and optimizer
    built; checkpoints and logs under `out_dir` (None: none, and nothing is
    written). The debug presets that need the eager path turn
    `scan_epochs` off."""
    device = resolve_device(cfg.get("device", "cuda"))
    trainer_cfg = dict(cfg.get("trainer") or {})
    debug_cfg = cfg.get("debug") or {}
    if debug_cfg.get("debug_nans") or debug_cfg.get("disable_jit"):
        trainer_cfg["scan_epochs"] = False
    for key in ("multihost", "grad_clip"):
        trainer_cfg.pop(key, None)
    ema_cfg = trainer_cfg.pop("ema", {})
    logger_cfg = dict(cfg.get("logger") or {})
    backends = tuple(logger_cfg.pop("backends", ["jsonl"]))
    logger_kwargs = {**logger_cfg, **(trainer_cfg.pop("logger_kwargs", None) or {})}
    declared = {f.name for f in dataclasses.fields(Trainer)}
    unported = sorted(k for k in trainer_cfg if k not in declared)
    if unported:
        raise NotImplementedError(f"trainer keys {unported} are not ported")
    callbacks = build_callbacks(cfg.get("callbacks")) + list(extra_callbacks or [])
    dm, model, optimizer = build_run(cfg)
    return Trainer(
        model=model,
        datamodule=dm,
        optimizer=optimizer,
        callbacks=callbacks,
        ema_decay=ema_cfg.get("decay", 0.999),
        ema_every_n=ema_cfg.get("every_n", 1),
        ema_start_step=ema_cfg.get("start_step", 0),
        ckpt_dir=os.path.join(out_dir, "checkpoints") if out_dir else None,
        log_dir=out_dir,
        logger_backends=backends,
        logger_kwargs=logger_kwargs,
        seed=cfg.get("seed", 0),
        device=device,
        **trainer_cfg,
    )


@contextlib.contextmanager
def debug_presets(debug_cfg: dict | None, device):
    """The `debug` group's anomaly mode and profiler around training."""
    debug_cfg = debug_cfg or {}
    profiler_dir = debug_cfg.get("profiler_dir")
    with contextlib.ExitStack() as stack:
        if debug_cfg.get("debug_nans"):
            import torch

            stack.enter_context(torch.autograd.detect_anomaly())
        prof = None
        if profiler_dir:
            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = stack.enter_context(torch.profiler.profile(activities=activities))
        yield
    if prof is not None and dist.is_rank_zero():
        os.makedirs(str(profiler_dir), exist_ok=True)
        path = os.path.join(str(profiler_dir), "trace.json")
        prof.export_chrome_trace(path)
        print(f"[train] profiler trace written to {path}", flush=True)


def train(cfg: dict, extra_callbacks: list | None = None) -> tuple[dict, dict]:
    """Returns (metrics, objects) like the JAX package's train();
    `extra_callbacks` join the config's. In a process group, rank 0 names the
    run directory and writes its files."""
    dist.maybe_initialize_distributed((cfg.get("trainer") or {}).get("multihost"),
                                      cfg.get("device", "cuda"))
    out_dir = dist.broadcast_object(os.path.join(
        cfg.get("output_dir", "runs/train"), time.strftime("%Y-%m-%d_%H-%M-%S")))
    trainer = build_trainer(cfg, out_dir, extra_callbacks)
    rank0 = dist.is_rank_zero()
    if rank0:
        save_config(cfg, os.path.join(out_dir, "config.yaml"))
        print(f"[train] run dir: {out_dir}", flush=True)
    dm, model = trainer.datamodule, trainer.model

    metrics = {}
    if cfg.get("train", True):
        with debug_presets(cfg.get("debug"), trainer.device):
            trainer.fit(resume_from=cfg.get("ckpt_path"),
                        load_weights_from=cfg.get("load_weights_from"))
        if trainer.metrics_history:
            metrics.update(trainer.metrics_history[-1])
    if cfg.get("test", False):
        monitor = "w1m_mean" if "w1m_mean" in trainer.ckpt_monitors else None
        metrics.update(trainer.test(ckpt="best", monitor=monitor))
    if rank0:
        save_config(
            {k: float(v) for k, v in metrics.items() if isinstance(v, (int, float))},
            os.path.join(out_dir, "final_metrics.yaml"),
        )
    return metrics, {"trainer": trainer, "model": model, "datamodule": dm, "out_dir": out_dir}


def main(argv: list[str] | None = None) -> tuple[dict, dict]:
    from particle_fm_tpu_torch.utils.helpers import task_wrapper

    argv = argv if argv is not None else sys.argv[1:]
    return task_wrapper(train)(compose(CONFIG_DIR, "train", overrides=list(argv)))


if __name__ == "__main__":
    main()
