"""Early stopping and Optuna-style median pruning; the port's copy of
particle_fm_tpu/training/stopping.py (numpy only).

Parity: the reference exposes Lightning's EarlyStopping through its callback
configs (e.g. configs/experiment/lhco/*.yaml early_stopping blocks) and runs
hyperparameter sweeps through the hydra Optuna sweeper
(configs/hparams_search/*.yaml). Here both are plain trainer callbacks: they
read the epoch's metrics from `trainer.last_metrics` and request a stop via
`trainer.should_stop = True` (the Trainer breaks out of its epoch loop after
checkpointing).

MedianPruner follows Optuna's MedianPruner semantics: a trial is pruned at
epoch E when its monitored value is worse than the median of previously
COMPLETED trials' values at the same epoch, after `n_startup_trials`
completed trials and `n_warmup_epochs` epochs of grace per trial.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _is_better(a: float, b: float, mode: str) -> bool:
    return a < b if mode == "min" else a > b


@dataclass
class EarlyStopping:
    """Stop training when `monitor` hasn't improved for `patience` checks."""

    monitor: str = "val_loss"
    mode: str = "min"
    patience: int = 100
    min_delta: float = 0.0
    check_finite: bool = True  # stop when the monitor turns NaN/inf (Lightning default)

    best: float = field(default=float("nan"), init=False)
    wait: int = field(default=0, init=False)

    def __call__(self, trainer) -> dict:
        metrics = getattr(trainer, "last_metrics", None) or {}
        if self.monitor not in metrics:
            return {}
        value = float(metrics[self.monitor])
        if not np.isfinite(value):
            if self.check_finite:
                trainer.should_stop = True
                print(f"[early_stopping] {self.monitor} is not finite ({value}) — stopping")
            return {}
        if not np.isfinite(self.best) or _is_better(
            value, self.best - self.min_delta if self.mode == "min" else self.best + self.min_delta,
            self.mode,
        ):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                trainer.should_stop = True
                print(
                    f"[early_stopping] {self.monitor} plateaued for "
                    f"{self.patience} checks (best {self.best:.5g}) — stopping"
                )
        return {}


@dataclass
class MedianPruner:
    """Cross-trial state for median pruning (shared by the trials of a sweep)."""

    mode: str = "min"
    n_startup_trials: int = 2
    n_warmup_epochs: int = 0

    # per completed trial: {epoch: value}
    completed: list = field(default_factory=list)

    def should_prune(self, epoch: int, value: float) -> bool:
        if len(self.completed) < self.n_startup_trials or epoch < self.n_warmup_epochs:
            return False
        peers = [h[epoch] for h in self.completed if epoch in h]
        if not peers:
            return False
        median = float(np.median(peers))
        return not _is_better(value, median, self.mode) and value != median

    def complete(self, history: dict) -> None:
        """Record a finished (or pruned) trial's {epoch: value} curve."""
        if history:
            self.completed.append(dict(history))


@dataclass
class PruningCallback:
    """Per-trial callback: reports `monitor` to the pruner each epoch and
    stops the trial when the pruner says so."""

    pruner: MedianPruner
    monitor: str = "val_loss"

    history: dict = field(default_factory=dict, init=False)
    pruned: bool = field(default=False, init=False)

    def __call__(self, trainer) -> dict:
        metrics = getattr(trainer, "last_metrics", None) or {}
        if self.monitor not in metrics:
            return {}
        value = float(metrics[self.monitor])
        self.history[trainer.epoch] = value
        if self.pruner.should_prune(trainer.epoch, value):
            self.pruned = True
            trainer.should_stop = True
            print(
                f"[pruning] epoch {trainer.epoch}: {self.monitor}={value:.5g} "
                "worse than the running median — pruning trial"
            )
        return {}
