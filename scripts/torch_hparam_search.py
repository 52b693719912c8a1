"""Hyperparameter search of the PyTorch port; the flags of
scripts/hparam_search.py.

    python scripts/torch_hparam_search.py --experiment jetnet/fm_tops30_cond \
        --metric val_loss --n_trials 8 \
        --space model.hidden_dim=64,128,256 model.layers=4,6,8 \
        --space-log model.optimizer.lr=1e-4:3e-3 \
        [--overrides data.synthetic=true trainer.max_epochs=5 ...]

Parity: the reference runs Optuna through the hydra sweeper
(configs/hparams_search/*.yaml, train.py:119-141 returns the monitored
metric). This script searches categorical and log-uniform spaces with either
seeded random search or a native TPE sampler (--sampler tpe — the
reference's Optuna TPESampler semantics, particle_fm_tpu_torch/training/
hparam.py), runs each trial through the port's train() entry point
(particle_fm_tpu_torch/train.py, on the card unless the overrides say
`device=cpu`), and writes a ranked summary. --prune enables Optuna-style
median pruning: a trial whose monitored metric lags the median of completed
trials at the same epoch is stopped early
(particle_fm_tpu_torch.training.stopping.MedianPruner).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None,
                    help="yaml sweep spec (configs/hparams_search/*); CLI flags override it")
    ap.add_argument("--experiment", default=None)
    ap.add_argument("--metric", default="val_loss")
    ap.add_argument("--mode", default="min", choices=["min", "max"])
    ap.add_argument("--n_trials", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--space", nargs="*", default=[], help="key=a,b,c categorical choices")
    ap.add_argument("--space-log", nargs="*", default=[], help="key=lo:hi log-uniform float")
    ap.add_argument("--overrides", nargs="*", default=[])
    ap.add_argument("--out", default="hparam_search_results.json")
    ap.add_argument("--sampler", default="random", choices=["random", "tpe"],
                    help="tpe: Tree-structured Parzen Estimator (the reference's "
                         "Optuna TPESampler, configs/hparams_search/mnist_optuna.yaml, "
                         "implemented in training/hparam.py); random: "
                         "seeded random search")
    ap.add_argument("--tpe-startup-trials", type=int, default=4,
                    help="random trials before TPE kicks in")
    ap.add_argument("--prune", action="store_true",
                    help="median-prune trials that lag completed ones (Optuna semantics)")
    ap.add_argument("--prune-startup-trials", type=int, default=2)
    ap.add_argument("--prune-warmup-epochs", type=int, default=0)
    args = ap.parse_args(argv)

    from particle_fm_tpu_torch.config.core import compose
    from particle_fm_tpu_torch.train import CONFIG_DIR, train

    cat_space = {}
    for s in args.space:
        k, v = s.split("=", 1)
        cat_space[k] = v.split(",")
    log_space = {}
    for s in args.space_log:
        k, v = s.split("=", 1)
        lo, hi = v.split(":")
        log_space[k] = (float(lo), float(hi))

    if args.config:
        import yaml

        with open(args.config) as f:
            spec = yaml.safe_load(f) or {}
        # explicit CLI flags win over the spec; spec fills in the defaults
        args.experiment = args.experiment or spec.get("experiment")
        for name in ("metric", "mode", "n_trials"):
            if getattr(args, name) == ap.get_default(name) and name in spec:
                setattr(args, name, spec[name])
        args.prune = args.prune or bool(spec.get("prune", False))
        if args.sampler == ap.get_default("sampler") and "sampler" in spec:
            args.sampler = spec["sampler"]
        for k, choices in (spec.get("space") or {}).items():
            cat_space.setdefault(k, [str(c) for c in choices])
        for k, (lo, hi) in (spec.get("space_log") or {}).items():
            log_space.setdefault(k, (float(lo), float(hi)))
        args.overrides = list(args.overrides) + [
            f"{k}={v}" for k, v in (spec.get("overrides") or {}).items()
        ]
    if not args.experiment:
        ap.error("--experiment (or a --config with one) is required")

    from particle_fm_tpu_torch.training.hparam import TrialRecord, make_sampler

    sampler = make_sampler(
        args.sampler, cat_space, log_space, seed=args.seed, mode=args.mode,
        **({"n_startup_trials": args.tpe_startup_trials} if args.sampler == "tpe" else {}),
    )
    history: list[TrialRecord] = []
    pruner = None
    if args.prune:
        from particle_fm_tpu_torch.training.stopping import MedianPruner

        pruner = MedianPruner(
            mode=args.mode,
            n_startup_trials=args.prune_startup_trials,
            n_warmup_epochs=args.prune_warmup_epochs,
        )
    results = []
    for trial in range(args.n_trials):
        picks = sampler.suggest(history)
        overrides = (
            [f"experiment={args.experiment}"]
            + list(args.overrides)
            + [f"{k}={v}" for k, v in picks.items()]
        )
        print(f"[hparam] trial {trial}: {picks}")
        cfg = compose(CONFIG_DIR, "train", overrides)
        cfg["test"] = False
        prune_cb = None
        extra = None
        if pruner is not None:
            from particle_fm_tpu_torch.training.stopping import PruningCallback

            prune_cb = PruningCallback(pruner, monitor=args.metric)
            extra = [prune_cb]
        try:
            metrics, _ = train(cfg, extra_callbacks=extra)
            value = float(metrics.get(args.metric, np.nan))
        except Exception as e:  # a bad config shouldn't kill the sweep
            print(f"[hparam] trial {trial} failed: {e}")
            value = float("nan")
        pruned = bool(prune_cb.pruned) if prune_cb is not None else False
        if pruner is not None and prune_cb is not None and not pruned and np.isfinite(value):
            # only COMPLETED (non-pruned, non-failed) trials inform the
            # median (Optuna semantics)
            pruner.complete(prune_cb.history)
        # pruned/failed trials enter TPE history as NaN (ignored by the
        # good/bad split) — only completed objectives shape the proposals
        history.append(TrialRecord(params=picks,
                                   value=value if not pruned else float("nan")))
        results.append(
            {"trial": trial, "params": picks, args.metric: value, "pruned": pruned}
        )

    sign = 1 if args.mode == "min" else -1
    # failed (NaN) trials always rank last, regardless of mode
    ranked = sorted(
        results,
        key=lambda r: sign * r[args.metric] if np.isfinite(r[args.metric]) else np.inf,
    )
    with open(args.out, "w") as f:
        json.dump(ranked, f, indent=2)
    print(f"[hparam] best: {ranked[0]}")
    print(f"[hparam] wrote {args.out}")
    return ranked


if __name__ == "__main__":
    main()
