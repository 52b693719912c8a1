"""Checkpoints: `last` plus top-k per monitored metric; counterpart of
particle_fm_tpu/training/checkpoint.py.

One file holds the whole TrainState: the network's state dict (parameters
and buffers), the EMA twin, the AdamW state and the step, written with
`torch.save`. Saving is synchronous. Retention is per monitor, with the
metric's value in the file name, as in the JAX package:

    {dir}/last.pt                                   always the latest state
    {dir}/{monitor}/step_{s}_metric_{v}.pt          top-k of each monitor
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

import numpy as np
import torch


def _sanitize(v: float) -> str:
    return f"{v:.6f}".replace("-", "m")


def _parse(name: str) -> float:
    m = re.search(r"metric_(m?[\d.]+?)\.pt$", name)
    if not m:
        return np.inf
    return float(m.group(1).replace("m", "-"))


@dataclass
class CheckpointManager:
    directory: str
    monitors: dict = field(default_factory=lambda: {"val_loss": "min"})
    top_k: int = 1

    def __post_init__(self):
        self.directory = os.path.abspath(self.directory)
        os.makedirs(self.directory, exist_ok=True)

    def _write(self, path: str, state) -> None:
        tmp = path + ".tmp"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, path)

    def save_last(self, state) -> str:
        path = os.path.join(self.directory, "last.pt")
        self._write(path, state)
        return path

    def _sign(self, monitor: str) -> float:
        return 1.0 if self.monitors.get(monitor, "min") == "min" else -1.0

    def save_metric(self, state, monitor: str, value: float, step: int) -> str | None:
        """Save iff `value` makes the monitor's top-k; prune beyond top_k."""
        mdir = os.path.join(self.directory, monitor)
        os.makedirs(mdir, exist_ok=True)
        sign = self._sign(monitor)
        entries = sorted(((_parse(n), n) for n in os.listdir(mdir) if n.endswith(".pt")),
                         key=lambda e: sign * e[0])
        if len(entries) >= self.top_k and sign * value >= sign * entries[-1][0]:
            return None
        name = f"step_{step}_metric_{_sanitize(value)}.pt"
        path = os.path.join(mdir, name)
        self._write(path, state)
        entries = sorted(entries + [(value, name)], key=lambda e: sign * e[0])
        for _, stale in entries[self.top_k:]:
            os.remove(os.path.join(mdir, stale))
        return path

    def best_path(self, monitor: str) -> str | None:
        mdir = os.path.join(self.directory, monitor)
        names = [n for n in os.listdir(mdir) if n.endswith(".pt")] if os.path.isdir(mdir) else []
        if not names:
            return None
        sign = self._sign(monitor)
        return os.path.join(mdir, min(names, key=lambda n: sign * _parse(n)))

    def last_path(self) -> str | None:
        path = os.path.join(self.directory, "last.pt")
        return path if os.path.exists(path) else None

    def restore(self, path: str, state):
        """Load the checkpoint at `path` into `state` (same model and
        optimizer), in place; returns it."""
        device = next(state.net.parameters()).device
        state.load_state_dict(torch.load(path, map_location=device, weights_only=True))
        return state
