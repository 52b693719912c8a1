"""Rank-zero logging; counterpart of particle_fm_tpu/utils/pylogger.py.

Log records are dropped on every process but rank 0 of the process group
(parallel/dist.py::is_rank_zero), so a run of W ranks prints one copy of
each line. Without a process group every record passes.
"""

from __future__ import annotations

import logging

from particle_fm_tpu_torch.parallel.dist import is_rank_zero


class _RankZeroFilter(logging.Filter):
    def filter(self, record):  # noqa: A003
        return is_rank_zero()


def get_pylogger(name: str = __name__) -> logging.Logger:
    """A logger whose records are dropped on ranks other than 0."""
    logger = logging.getLogger(name)
    if not any(isinstance(f, _RankZeroFilter) for f in logger.filters):
        logger.addFilter(_RankZeroFilter())
    if not logger.handlers and not logging.getLogger().handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("[%(name)s] %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger
