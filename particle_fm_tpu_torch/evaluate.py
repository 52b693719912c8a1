"""Standalone evaluation entry point; counterpart of particle_fm_tpu/evaluate.py.

    python -m particle_fm_tpu_torch.evaluate ckpt_path=<run_dir> [ckpt=best|last] \
        [device=cpu] [key=value ...]

Reload the run's saved config.yaml (with the overrides), rebuild the
datamodule, the model and the optimizer as train.py built them, restore the
best (of `w1m_mean` when it is monitored, else the first monitor) or last
checkpoint, run the `on_test` eval callbacks and write
final_eval_metrics.yaml into the run directory. The overrides are read as
the training CLI reads its own. Runs on the card unless this call gives
`device=cpu`, whatever device the run was trained on; without CUDA it
raises.

Under torchrun every rank runs the same call (parallel/dist.py): the
generation is rank-split and rank 0 writes final_eval_metrics.yaml.
"""

from __future__ import annotations

import os
import sys

import yaml

from particle_fm_tpu_torch.config.core import load_config, set_overrides
from particle_fm_tpu_torch.parallel import dist
from particle_fm_tpu_torch.train import build_trainer


def evaluate(run_dir: str, ckpt: str = "best", overrides: dict | None = None) -> dict:
    cfg = load_config(os.path.join(run_dir, "config.yaml"))
    overrides = dict(overrides or {})
    # the device is this call's, never the one the run was trained on
    cfg["device"] = overrides.pop("device", "cuda")
    set_overrides(cfg, overrides.items())
    dist.maybe_initialize_distributed((cfg.get("trainer") or {}).get("multihost"),
                                      cfg["device"])
    trainer = build_trainer(cfg, run_dir)
    monitor = "w1m_mean" if "w1m_mean" in trainer.ckpt_monitors else None
    results = trainer.test(ckpt=ckpt, monitor=monitor)
    if dist.is_rank_zero():
        with open(os.path.join(run_dir, "final_eval_metrics.yaml"), "w") as f:
            yaml.safe_dump({k: float(v) for k, v in results.items()}, f)
    return results


def main(argv: list[str] | None = None) -> dict:
    argv = argv if argv is not None else sys.argv[1:]
    kv = dict(a.split("=", 1) for a in argv)
    run_dir = kv.pop("ckpt_path", None) or kv.pop("run_dir", None)
    if run_dir is None:
        raise SystemExit(
            "usage: python -m particle_fm_tpu_torch.evaluate ckpt_path=<run_dir> [ckpt=best|last]")
    ckpt = kv.pop("ckpt", "best")
    return evaluate(run_dir, ckpt=ckpt, overrides=kv)


if __name__ == "__main__":
    main()
