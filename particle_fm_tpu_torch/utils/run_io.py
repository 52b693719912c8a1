"""Run loading shared by the offline entry points; counterpart of
particle_fm_tpu/utils/run_io.py.

One recipe: reload a run's saved config, rebuild the datamodule, the model
and the optimizer as train.py built them (the checkpointed AdamW state
belongs to that optimizer), restore the requested checkpoint onto `device`
(CUDA unless the caller asks for the CPU), and hand back the network to
sample with: the EMA weights, or the live ones.
"""

from __future__ import annotations

import os


def build_run(cfg: dict):
    """(datamodule set up, model, optimizer) of a composed config: the model
    block's `optimizer`/`scheduler` popped, an epoch-denominated schedule
    converted with the optimizer steps of an epoch, the trainer's
    `grad_clip`."""
    from particle_fm_tpu_torch.config.core import instantiate
    from particle_fm_tpu_torch.training.lr_schedules import build_lr
    from particle_fm_tpu_torch.training.step import make_optimizer

    dm = instantiate(cfg["data"])
    dm.setup()
    model_cfg = dict(cfg["model"])
    opt_cfg = model_cfg.pop("optimizer", {})
    sched_cfg = model_cfg.pop("scheduler", None)
    model = instantiate(model_cfg)
    trainer_cfg = cfg.get("trainer") or {}
    # schedules count optimizer steps: with accumulation an epoch makes
    # steps_per_epoch // accumulate_grad_batches of them
    accum = int(trainer_cfg.get("accumulate_grad_batches", 1) or 1)
    optimizer = make_optimizer(
        lr=build_lr(opt_cfg, sched_cfg, max(dm.steps_per_epoch // max(accum, 1), 1)),
        weight_decay=opt_cfg.get("weight_decay", 5e-5),
        grad_clip=trainer_cfg.get("grad_clip", 0.5),
    )
    return dm, model, optimizer


def load_run(run_dir: str, ckpt: str = "best", ema: bool = True, device="cuda", dtype=None):
    """Returns (cfg, datamodule, model, net): the network of the best
    checkpoint of the run's first monitor (else `last`), or of `last`, with
    the EMA weights when `ema`. `dtype` (a name such as "bfloat16") replaces
    the run's `model.dtype`: a run trained in either type is served in either."""
    from particle_fm_tpu_torch.config.core import load_config
    from particle_fm_tpu_torch.training.checkpoint import CheckpointManager
    from particle_fm_tpu_torch.training.step import create_train_state
    from particle_fm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg = load_config(os.path.join(run_dir, "config.yaml"))
    if dtype is not None:
        cfg["model"]["dtype"] = dtype
    dm, model, optimizer = build_run(cfg)
    state = create_train_state(model, optimizer, seed=0, device=dev)
    cm = CheckpointManager(
        os.path.join(run_dir, "checkpoints"),
        (cfg.get("trainer") or {}).get("ckpt_monitors", {"val_loss": "min"}),
    )
    path = cm.last_path() if ckpt == "last" else (
        cm.best_path(next(iter(cm.monitors))) or cm.last_path()
    )
    if path is None:
        raise FileNotFoundError(f"no checkpoint found under {run_dir}/checkpoints")
    cm.restore(path, state)
    return cfg, dm, model, state.ema_network() if ema else state.net
