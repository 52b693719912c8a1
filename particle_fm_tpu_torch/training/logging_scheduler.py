"""Epoch-predicate logging schedules for the eval callbacks; counterpart of
particle_fm_tpu/training/logging_scheduler.py.

Parity: particle_fm/schedulers/logging_scheduler.py:4-51 — named predicates
selecting which epochs run the (expensive) generation + W1 evaluation.
"""

from __future__ import annotations


def custom1(current_epoch: int) -> bool:
    return current_epoch in (2, 7)


def custom5000epochs(current_epoch: int) -> bool:
    if current_epoch == 100:
        return True
    if current_epoch <= 4500:
        return current_epoch % 750 == 0
    return current_epoch <= 5000


def epochs10000(current_epoch: int) -> bool:
    if current_epoch == 100:
        return True
    for i in range(1, 9):
        t = 1000 * i
        if t - 5 < current_epoch <= t:
            return True
    return current_epoch > 9975


def custom10000epochs(current_epoch: int) -> bool:
    if current_epoch == 100:
        return True
    if current_epoch <= 9500:
        return current_epoch % 500 == 0
    return current_epoch <= 10000


def nolog10000(current_epoch: int) -> bool:
    if current_epoch == 200:
        return True
    if current_epoch <= 9500:
        return False
    return current_epoch <= 10000


SCHEDULES = {
    "custom1": custom1,
    "custom5000epochs": custom5000epochs,
    "epochs10000": epochs10000,
    "custom10000epochs": custom10000epochs,
    "nolog10000": nolog10000,
}


def should_log(schedule: int | str, current_epoch: int) -> bool:
    """int schedule -> every N epochs; str -> named predicate.
    Parity: callbacks/jetnet_eval.py:99-105,149-165."""
    if isinstance(schedule, int):
        return current_epoch % schedule == 0
    return SCHEDULES[schedule](current_epoch)
