"""Base datamodule; counterpart of particle_fm_tpu/data/base.py (numpy only).

Every datamodule produces (x, mask, cond) arrays per split and keeps the raw
tensors and the normalisation statistics beside them. Batches have fixed
shapes: the train iterator shuffles and drops the last partial batch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np


@dataclass
class Split:
    x: np.ndarray  # (B, N, F) padded particle features
    mask: np.ndarray  # (B, N, 1)
    cond: Optional[np.ndarray]  # (B, C) or None

    def __len__(self):
        return len(self.x)


@dataclass
class ArrayDataModule:
    """In-memory datamodule base. Subclasses implement `setup()` and fill
    train/val/test splits plus normalization stats."""

    batch_size: int = 256
    drop_last: bool = False

    # populated by setup()
    train: Optional[Split] = field(default=None, repr=False)
    val: Optional[Split] = field(default=None, repr=False)
    test: Optional[Split] = field(default=None, repr=False)
    means: Optional[np.ndarray] = None
    stds: Optional[np.ndarray] = None
    cond_means: Optional[np.ndarray] = None
    cond_stds: Optional[np.ndarray] = None
    # unnormalized tensors for eval callbacks
    tensor_train: Optional[np.ndarray] = field(default=None, repr=False)
    mask_train: Optional[np.ndarray] = field(default=None, repr=False)
    tensor_val: Optional[np.ndarray] = field(default=None, repr=False)
    mask_val: Optional[np.ndarray] = field(default=None, repr=False)
    tensor_test: Optional[np.ndarray] = field(default=None, repr=False)
    mask_test: Optional[np.ndarray] = field(default=None, repr=False)
    tensor_conditioning_train: Optional[np.ndarray] = field(default=None, repr=False)
    tensor_conditioning_val: Optional[np.ndarray] = field(default=None, repr=False)
    tensor_conditioning_test: Optional[np.ndarray] = field(default=None, repr=False)
    variable_jet_sizes: bool = True
    # a split of fixed-shape batches may be placed on the device once for the
    # whole run (the Trainer's cache); datamodules that build their batches
    # on the host (bucketed lengths) turn this off and are streamed
    device_cacheable: bool = True

    def setup(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    # ------------------------------------------------------------ batching
    def _batches(
        self, split: Split, rng: np.random.Generator | None, drop_last: bool
    ) -> Iterator[tuple]:
        n = len(split)
        idx = np.arange(n)
        if rng is not None:
            rng.shuffle(idx)
        stop = n - (n % self.batch_size) if drop_last else n
        if stop == 0 and n > 0:
            # split smaller than batch_size: one short batch beats silently
            # yielding nothing (which turns the epoch loss into NaN)
            stop = n
        for s in range(0, stop, self.batch_size):
            sel = idx[s : s + self.batch_size]
            cond = split.cond[sel] if split.cond is not None else None
            mask = split.mask[sel] if split.mask is not None else None
            yield split.x[sel], mask, cond

    def train_batches(self, seed: int = 0) -> Iterator[tuple]:
        """One shuffled epoch of fixed-shape train batches (last partial
        batch dropped)."""
        return self._batches(self.train, np.random.default_rng(seed), drop_last=True)

    def val_batches(self) -> Iterator[tuple]:
        return self._batches(self.val, None, drop_last=self.drop_last)

    def test_batches(self) -> Iterator[tuple]:
        return self._batches(self.test, None, drop_last=False)

    @property
    def steps_per_epoch(self) -> int:
        return len(self.train) // self.batch_size


def reference_split(n: int, val_fraction: float, test_fraction: float):
    """The reference's split indices (note the historical len-1 offsets,
    jetnet_datamodule.py:210-216): returns (end_train, end_val)."""
    n_val = int(val_fraction * n)
    n_test = int(test_fraction * n)
    return n - 1 - (n_val + n_test), n - 1 - n_test
