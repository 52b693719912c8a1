"""Task helpers; counterpart of particle_fm_tpu/utils/helpers.py.

`task_wrapper` runs a task and, when it fails, appends the traceback to
`exec_error.log` in the config's `output_dir` and raises the exception
again; `print_config_tree` prints the resolved config as YAML;
`count_parameters` counts a module's trainable parameters.
"""

from __future__ import annotations

import functools
import os
import traceback
from typing import Callable

import yaml
from torch import nn

from particle_fm_tpu_torch.utils.pylogger import get_pylogger

log = get_pylogger(__name__)


def task_wrapper(task_func: Callable) -> Callable:
    """Run `task_func(cfg, ...)`; on an exception write its traceback to
    `<cfg.output_dir>/exec_error.log` and raise it again."""

    @functools.wraps(task_func)
    def wrap(cfg: dict, *args, **kwargs):
        try:
            return task_func(cfg, *args, **kwargs)
        except Exception:
            out_dir = cfg.get("output_dir", ".")
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "exec_error.log"), "a") as f:
                f.write(traceback.format_exc())
            log.error("Task failed — traceback saved to exec_error.log")
            raise
        finally:
            log.info("Task finished (loggers closed).")

    return wrap


def print_config_tree(cfg: dict) -> None:
    """Print the resolved config as YAML."""
    print(yaml.safe_dump(cfg, sort_keys=False))


def count_parameters(module: nn.Module) -> int:
    """The number of trainable parameter values of `module`."""
    return int(sum(p.numel() for p in module.parameters() if p.requires_grad))
