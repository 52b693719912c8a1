"""Metric loggers; the two file backends of particle_fm_tpu/training/loggers.py
(`jsonl`: metrics.jsonl, `csv`: metrics.csv in the run directory). The
others log to outside services or need packages the port does not carry:
asking for one raises.
"""

from __future__ import annotations

import csv
import json
import os


class JsonlLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")

    def log_metrics(self, metrics: dict, step: int) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({k: float(v) for k, v in metrics.items()}) + "\n")

    def close(self) -> None:
        pass


class CSVLogger:
    """Appends rows in O(1); the file is rewritten only when a new metric key
    widens the header (rare: typically once when eval callbacks first fire) —
    a 10k-epoch run logs in O(n), not O(n^2)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.csv")
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


_BACKENDS = {"jsonl": JsonlLogger, "csv": CSVLogger}


class MultiLogger:
    """Fan-out to the configured backends."""

    def __init__(self, log_dir: str, backends: tuple = ("jsonl",)):
        unknown = [name for name in backends if name not in _BACKENDS]
        if unknown:
            raise NotImplementedError(
                f"logger backends {unknown} are not ported (the port logs to {sorted(_BACKENDS)})"
            )
        self.loggers = [_BACKENDS[name](log_dir) for name in backends]

    def log_metrics(self, metrics: dict, step: int) -> None:
        for lg in self.loggers:
            lg.log_metrics(metrics, step)

    def close(self) -> None:
        for lg in self.loggers:
            lg.close()
