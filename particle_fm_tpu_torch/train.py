"""Training entry point; counterpart of particle_fm_tpu/train.py.

    python -m particle_fm_tpu_torch.train experiment=jetnet/fm_tops150_cond \
        data.synthetic=true callbacks=none [key=value ...] [device=cpu]

Composes the same `configs/` (the JAX package's `_target_` classes built as
the port's), snapshots the resolved config into the run directory, builds
the datamodule and the model, pops `optimizer`/`scheduler` from the model
block and `grad_clip`/`ema` from the trainer block, converts an
epoch-denominated schedule with the optimizer steps of an epoch, runs
`Trainer.fit` and writes `final_metrics.yaml`. Training runs on the card
unless `device=cpu` is given; without CUDA it raises.

Eval callbacks are not ported: a callback entry with a `_target_` raises,
so pass `callbacks=none` (an entry without a `_target_`, as an experiment
overlay leaves after `callbacks=none`, is skipped, as in the JAX package).
"""

from __future__ import annotations

import os
import sys
import time

from particle_fm_tpu_torch.config.core import compose, instantiate, save_config
from particle_fm_tpu_torch.training.lr_schedules import build_lr
from particle_fm_tpu_torch.training.step import make_optimizer
from particle_fm_tpu_torch.training.trainer import Trainer
from particle_fm_tpu_torch.utils.device import resolve_device

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def check_callbacks(callbacks_cfg: dict | None) -> None:
    """Raise for a callback the config asks for; skip entries without a
    `_target_`."""
    for name, cb_cfg in (callbacks_cfg or {}).items():
        if not isinstance(cb_cfg, dict) or "_target_" not in cb_cfg:
            print(f"[train] skipping callback {name!r}: no _target_ (group overridden?)")
            continue
        raise NotImplementedError(
            f"callback {name!r} ({cb_cfg['_target_']}) is not ported: the port trains without "
            "eval callbacks (pass callbacks=none)"
        )


def train(cfg: dict) -> tuple[dict, dict]:
    """Returns (metrics, objects) like the JAX package's train()."""
    device = resolve_device(cfg.get("device", "cuda"))
    if cfg.get("debug") or (cfg.get("trainer") or {}).get("multihost") or cfg.get(
            "load_weights_from"):
        raise NotImplementedError(
            "the debug presets, multi-host runs and load_weights_from are not ported")
    check_callbacks(cfg.get("callbacks"))
    out_dir = os.path.join(cfg.get("output_dir", "runs/train"), time.strftime("%Y-%m-%d_%H-%M-%S"))
    os.makedirs(out_dir, exist_ok=True)
    save_config(cfg, os.path.join(out_dir, "config.yaml"))
    print(f"[train] run dir: {out_dir}", flush=True)

    dm = instantiate(cfg["data"])
    dm.setup()

    model_cfg = dict(cfg["model"])
    optimizer_cfg = model_cfg.pop("optimizer", {})
    scheduler_cfg = model_cfg.pop("scheduler", None)
    model = instantiate(model_cfg)

    trainer_cfg = dict(cfg.get("trainer", {}))
    trainer_cfg.pop("multihost", None)
    # schedules count optimizer steps: with accumulation an epoch makes
    # steps_per_epoch // accumulate_grad_batches of them
    accum = int(trainer_cfg.get("accumulate_grad_batches", 1) or 1)
    lr = build_lr(optimizer_cfg, scheduler_cfg, max(dm.steps_per_epoch // max(accum, 1), 1))
    optimizer = make_optimizer(
        lr=lr,
        weight_decay=optimizer_cfg.get("weight_decay", 5e-5),
        grad_clip=trainer_cfg.pop("grad_clip", 0.5),
    )
    ema_cfg = trainer_cfg.pop("ema", {})
    logger_backends = tuple((cfg.get("logger") or {}).get("backends", ["jsonl"]))

    trainer = Trainer(
        model=model,
        datamodule=dm,
        optimizer=optimizer,
        ema_decay=ema_cfg.get("decay", 0.999),
        ema_every_n=ema_cfg.get("every_n", 1),
        ema_start_step=ema_cfg.get("start_step", 0),
        ckpt_dir=os.path.join(out_dir, "checkpoints"),
        log_dir=out_dir,
        logger_backends=logger_backends,
        seed=cfg.get("seed", 0),
        device=device,
        **trainer_cfg,
    )

    metrics = {}
    if cfg.get("train", True):
        trainer.fit(resume_from=cfg.get("ckpt_path"))
        if trainer.metrics_history:
            metrics.update(trainer.metrics_history[-1])
    if cfg.get("test", False):
        print("[train] test: no eval callbacks are ported, nothing to run")
    save_config(
        {k: float(v) for k, v in metrics.items() if isinstance(v, (int, float))},
        os.path.join(out_dir, "final_metrics.yaml"),
    )
    return metrics, {"trainer": trainer, "model": model, "datamodule": dm, "out_dir": out_dir}


def main(argv: list[str] | None = None) -> tuple[dict, dict]:
    argv = argv if argv is not None else sys.argv[1:]
    return train(compose(CONFIG_DIR, "train", overrides=list(argv)))


if __name__ == "__main__":
    main()
