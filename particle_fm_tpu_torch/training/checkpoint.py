"""Checkpoints: `last` plus top-k per monitored metric; counterpart of
particle_fm_tpu/training/checkpoint.py.

One file holds the whole TrainState: the network's state dict (parameters
and buffers), the EMA twin, the AdamW state and the step, written with
`torch.save`. Retention is per monitor, with the metric's value in the file
name, as in the JAX package:

    {dir}/last.pt                                   always the latest state
    {dir}/{monitor}/step_{s}_metric_{v}.pt          top-k of each monitor

Saves are asynchronous by default (`async_save=True`): the state dict is
snapshotted by a copy of each tensor on its device, made at the call (so
the next train step, which updates the tensors in place, cannot change
it), and written on one worker thread; the files are byte for byte those
of a synchronous save. Top-k admission and pruning read an in-memory
mirror of each monitor's directory, so queued saves count at once; every
read (`restore`, `best_path`, `last_path`) and the trainer's end of `fit`
join the queue first (`flush`), so what can be observed is what
synchronous saving gives.

In a process group every rank makes the same calls: rank 0 decides whether
a metric's checkpoint is kept (and tells the others), every rank builds
the state dict (a sharded state gathers its tensors whole, so the file is
the single-device format), rank 0 writes and prunes, and a barrier ends the
save (or, asynchronous, the flush); every rank restores.
"""

from __future__ import annotations

import os
import re
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from particle_fm_tpu_torch.parallel import dist


def _sanitize(v: float) -> str:
    return f"{v:.6f}".replace("-", "m")


def _parse(name: str) -> float:
    m = re.search(r"metric_(m?[\d.]+?)\.pt$", name)
    if not m:
        return np.inf
    return float(m.group(1).replace("m", "-"))


def _snapshot(obj):
    """A copy of every tensor of a state dict, on its device (the rest as is)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, dict):
        out = type(obj)((k, _snapshot(v)) for k, v in obj.items())
        if hasattr(obj, "__dict__"):  # a module state dict's _metadata
            out.__dict__.update(obj.__dict__)
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(_snapshot(v) for v in obj)
    return obj


def _write_file(path: str, sd: dict, stale: tuple[str, ...]) -> None:
    tmp = path + ".tmp"
    torch.save(sd, tmp)
    os.replace(tmp, path)
    for p in stale:
        if os.path.exists(p):
            os.remove(p)


@dataclass
class CheckpointManager:
    directory: str
    monitors: dict = field(default_factory=lambda: {"val_loss": "min"})
    top_k: int = 1
    async_save: bool = True

    def __post_init__(self):
        self.directory = os.path.abspath(self.directory)
        os.makedirs(self.directory, exist_ok=True)
        self._pool = (ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
                      if self.async_save else None)
        self._pending = []
        # each monitor's kept checkpoints, [(value, file name)]: queued saves
        # appear here at once
        self._entries: dict[str, list] = {}

    def _write(self, path: str, state, stale: tuple[str, ...] = ()) -> None:
        """Write `state` to `path` and remove the `stale` files (rank 0), now
        or on the worker thread."""
        sd = state.state_dict()
        if self._pool is None:
            if dist.is_rank_zero():
                _write_file(path, sd, stale)
            dist.barrier()
        elif dist.is_rank_zero():
            self._pending.append(self._pool.submit(_write_file, path, _snapshot(sd), stale))

    def flush(self) -> None:
        """Join the queued saves (raising a worker's exception)."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()
        if self._pool is not None:
            dist.barrier()

    def save_last(self, state) -> str:
        path = os.path.join(self.directory, "last.pt")
        self._write(path, state)
        return path

    def _sign(self, monitor: str) -> float:
        return 1.0 if self.monitors.get(monitor, "min") == "min" else -1.0

    def _monitor_entries(self, monitor: str, mdir: str) -> list:
        if monitor not in self._entries:
            self._entries[monitor] = [(_parse(n), n) for n in os.listdir(mdir) if n.endswith(".pt")]
        return self._entries[monitor]

    def save_metric(self, state, monitor: str, value: float, step: int) -> str | None:
        """Save iff `value` makes the monitor's top-k; prune beyond top_k."""
        mdir = os.path.join(self.directory, monitor)
        os.makedirs(mdir, exist_ok=True)
        sign = self._sign(monitor)
        entries = self._monitor_entries(monitor, mdir)
        entries.sort(key=lambda e: sign * e[0])
        keep = dist.broadcast_object(
            not (len(entries) >= self.top_k and sign * value >= sign * entries[-1][0]))
        if not keep:
            return None
        name = f"step_{step}_metric_{_sanitize(value)}.pt"
        path = os.path.join(mdir, name)
        entries.append((value, name))
        entries.sort(key=lambda e: sign * e[0])
        stale = tuple(os.path.join(mdir, n) for _, n in entries[self.top_k:])
        del entries[self.top_k:]
        self._write(path, state, stale)
        return path

    def best_path(self, monitor: str) -> str | None:
        self.flush()
        mdir = os.path.join(self.directory, monitor)
        names = [n for n in os.listdir(mdir) if n.endswith(".pt")] if os.path.isdir(mdir) else []
        if not names:
            return None
        sign = self._sign(monitor)
        return os.path.join(mdir, min(names, key=lambda n: sign * _parse(n)))

    def last_path(self) -> str | None:
        self.flush()
        path = os.path.join(self.directory, "last.pt")
        return path if os.path.exists(path) else None

    def restore(self, path: str, state):
        """Load the checkpoint at `path` into `state` (same model and
        optimizer), in place; returns it."""
        self.flush()
        device = next(state.net.parameters()).device
        state.load_state_dict(torch.load(path, map_location=device, weights_only=True))
        return state


def load_weights_from(path: str, state):
    """The parameters and their EMA twin of the checkpoint at `path` into
    `state` in place, its AdamW state, step and buffers (the normalisers'
    statistics) kept fresh: the JAX package's fine-tuning start (its
    `load_weights_from` replaces params and ema_params only); returns it."""
    device = next(state.net.parameters()).device
    sd = torch.load(path, map_location=device, weights_only=True)
    with torch.no_grad():
        for (name, p), e, saved in zip(state.net.named_parameters(), state.ema_params,
                                       sd["ema_params"], strict=True):
            p.copy_(sd["params"][name])
            e.copy_(saved)
    return state
