"""Training entry point; counterpart of particle_fm_tpu/train.py.

    python -m particle_fm_tpu_torch.train experiment=jetnet/fm_tops150_cond \
        data.synthetic=true [key=value ...] [device=cpu]

Composes the same `configs/` (the JAX package's `_target_` classes built as
the port's), snapshots the resolved config into the run directory, builds
the datamodule, the model and the callbacks, pops `optimizer`/`scheduler`
from the model block and `grad_clip`/`ema` from the trainer block, converts
an epoch-denominated schedule with the optimizer steps of an epoch, runs
`Trainer.fit`, with `test: true` runs `Trainer.test` on the best checkpoint
(of `w1m_mean` when it is monitored), and writes `final_metrics.yaml`.
Training and evaluation run on the card unless `device=cpu` is given;
without CUDA they raise.

The JetNet, LHCO (`lhco`, `lhco_whole_event`), CaloChallenge (`calo`),
classifier (`classifier`), flat (`flat_eval`) and GenChallenge
(`gen_challenge`) eval callbacks are ported; the classifier models train as
the generators do (labels in `cond`), and the flat models on (B, F) batches
without a mask. A callback the port lacks (`device_stats`) raises through
config/core.py. An entry without a `_target_`, as an experiment overlay
leaves after `callbacks=none`, is skipped, as in the JAX package. A trainer
key the port's Trainer does not declare (the JAX trainer's `scan_epochs`,
`ckpt_async`, `model_axis_size`, ...) raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

from particle_fm_tpu_torch.config.core import compose, instantiate, save_config
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


def build_trainer(cfg: dict, out_dir: str | None = None) -> Trainer:
    """The Trainer of a composed config: its callbacks built, its datamodule
    set up, its model and optimizer built; checkpoints and logs under
    `out_dir` (None: none, and nothing is written)."""
    device = resolve_device(cfg.get("device", "cuda"))
    if cfg.get("debug") or (cfg.get("trainer") or {}).get("multihost") or cfg.get(
            "load_weights_from"):
        raise NotImplementedError(
            "the debug presets, multi-host runs and load_weights_from are not ported")
    trainer_cfg = dict(cfg.get("trainer") or {})
    for key in ("multihost", "grad_clip"):
        trainer_cfg.pop(key, None)
    ema_cfg = trainer_cfg.pop("ema", {})
    declared = {f.name for f in dataclasses.fields(Trainer)}
    unported = sorted(k for k in trainer_cfg if k not in declared)
    if unported:
        raise NotImplementedError(f"trainer keys {unported} are not ported")
    callbacks = build_callbacks(cfg.get("callbacks"))
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
        logger_backends=tuple((cfg.get("logger") or {}).get("backends", ["jsonl"])),
        seed=cfg.get("seed", 0),
        device=device,
        **trainer_cfg,
    )


def train(cfg: dict) -> tuple[dict, dict]:
    """Returns (metrics, objects) like the JAX package's train()."""
    out_dir = os.path.join(cfg.get("output_dir", "runs/train"), time.strftime("%Y-%m-%d_%H-%M-%S"))
    trainer = build_trainer(cfg, out_dir)
    save_config(cfg, os.path.join(out_dir, "config.yaml"))
    print(f"[train] run dir: {out_dir}", flush=True)
    dm, model = trainer.datamodule, trainer.model

    metrics = {}
    if cfg.get("train", True):
        trainer.fit(resume_from=cfg.get("ckpt_path"))
        if trainer.metrics_history:
            metrics.update(trainer.metrics_history[-1])
    if cfg.get("test", False):
        monitor = "w1m_mean" if "w1m_mean" in trainer.ckpt_monitors else None
        metrics.update(trainer.test(ckpt="best", monitor=monitor))
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
