"""Metric loggers; the file backends of particle_fm_tpu/training/loggers.py
(`jsonl`: metrics.jsonl, `csv`: metrics.csv in the run directory) and
`tensorboard` (event files under `<log_dir>/tb`, through
`torch.utils.tensorboard`: where the `tensorboard` package is missing it
raises an ImportError that names it, where the JAX package skips the
backend). The others log to outside services: asking for one raises.
`MultiLogger`'s keyword arguments are the backends' init arguments, one dict
a backend name (the trainer's `logger_kwargs`, the `logger` config group
less its `backends`): the file name of `jsonl` and `csv`, and
`SummaryWriter`'s arguments for `tensorboard`. In a
process group only rank 0 logs (the Trainer builds no logger on the other
ranks; one built there writes nothing).
"""

from __future__ import annotations

import csv
import json
import os

from particle_fm_tpu_torch.parallel import dist


class JsonlLogger:
    def __init__(self, log_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)

    def log_metrics(self, metrics: dict, step: int) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({k: float(v) for k, v in metrics.items()}) + "\n")

    def close(self) -> None:
        pass


class CSVLogger:
    """Appends rows in O(1); the file is rewritten only when a new metric key
    widens the header (rare: typically once when eval callbacks first fire) —
    a 10k-epoch run logs in O(n), not O(n^2)."""

    def __init__(self, log_dir: str, filename: str = "metrics.csv"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._keys: list[str] = []
        self._rows: list[dict] = []

    def log_metrics(self, metrics: dict, step: int) -> None:
        row = {k: float(v) for k, v in metrics.items()}
        self._rows.append(row)
        new_keys = [k for k in row if k not in self._keys]
        if new_keys or not os.path.exists(self.path):
            self._keys.extend(new_keys)
            with open(self.path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._keys)
                w.writeheader()
                for r in self._rows:
                    w.writerow(r)
            return
        with open(self.path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self._keys).writerow(row)

    def close(self) -> None:
        pass


class TensorBoardLogger:
    """One scalar a metric a step, flushed each call."""

    def __init__(self, log_dir: str, **writer_kwargs):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise ImportError("the tensorboard logger backend needs the `tensorboard` package, "
                              f"which is not installed ({e})") from e
        self._writer = SummaryWriter(os.path.join(log_dir, "tb"), **writer_kwargs)

    def log_metrics(self, metrics: dict, step: int) -> None:
        for k, v in metrics.items():
            self._writer.add_scalar(k, float(v), global_step=step)
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()


_BACKENDS = {"jsonl": JsonlLogger, "csv": CSVLogger, "tensorboard": TensorBoardLogger}


class MultiLogger:
    """Fan-out to the configured backends."""

    def __init__(self, log_dir: str, backends: tuple = ("jsonl",), **kwargs):
        unknown = [name for name in backends if name not in _BACKENDS]
        if unknown:
            raise NotImplementedError(
                f"logger backends {unknown} are not ported (the port logs to {sorted(_BACKENDS)})"
            )
        self.loggers = ([_BACKENDS[name](log_dir, **(kwargs.get(name) or {}))
                         for name in backends]
                        if dist.is_rank_zero() else [])

    def log_metrics(self, metrics: dict, step: int) -> None:
        for lg in self.loggers:
            lg.log_metrics(metrics, step)

    def close(self) -> None:
        for lg in self.loggers:
            lg.close()
