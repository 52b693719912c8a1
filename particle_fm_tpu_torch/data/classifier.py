"""Gen-vs-real classifier data; counterpart of particle_fm_tpu/data/classifier.py
(numpy only).

Real samples are labelled 1 and generated ones 0, shuffled with
`np.random.RandomState(seed)`, normalised, and split into train, val and
test, with the labels in the `cond` slot of the (x, mask, cond) batches.
Sets (B, N, F) come with masks, flat vectors (B, F) without. The arrays are
handed in memory, or read from h5 files (datasets `x` and, for sets,
`mask`), which needs h5py (data/utils.py::import_h5py). Under
`num_sup_sets` S, rows [i S, (i + 1) S) form one event and stay together
through the shuffle, the splits and the batches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from particle_fm_tpu_torch.data.base import ArrayDataModule, Split
from particle_fm_tpu_torch.data.utils import import_h5py, masked_mean_std


@dataclass
class GenVsRealDataModule(ArrayDataModule):
    """Binary classifier data from in-memory real/generated arrays or h5 files."""

    real: Optional[np.ndarray] = None
    real_mask: Optional[np.ndarray] = None
    gen: Optional[np.ndarray] = None
    gen_mask: Optional[np.ndarray] = None
    real_file: Optional[str] = None
    gen_file: Optional[str] = None
    val_fraction: float = 0.15
    test_fraction: float = 0.15
    normalize: bool = True
    num_sup_sets: int = 1
    seed: int = 0

    @staticmethod
    def _from_file(path):
        h5py = import_h5py()
        with h5py.File(path, "r") as f:
            x = np.asarray(f["x"])
            mask = np.asarray(f["mask"]) if "mask" in f else None
        return x, mask

    def setup(self) -> None:
        if self.train is not None:
            return
        real, real_mask = self.real, self.real_mask
        gen, gen_mask = self.gen, self.gen_mask
        if real is None and self.real_file:
            real, real_mask = self._from_file(self.real_file)
        if gen is None and self.gen_file:
            gen, gen_mask = self._from_file(self.gen_file)
        if real is None or gen is None:
            raise ValueError("need real+gen arrays or files")

        s = max(self.num_sup_sets, 1)
        if self.batch_size % s:
            raise ValueError(f"batch_size must be a multiple of num_sup_sets={s}")
        n = min(len(real), len(gen))
        n -= n % s  # whole events
        x = np.concatenate([real[:n], gen[:n]], axis=0).astype(np.float32)
        labels = np.concatenate([np.ones(n), np.zeros(n)]).astype(np.float32)[:, None]
        if real_mask is not None and gen_mask is not None:
            mask = np.concatenate([real_mask[:n], gen_mask[:n]], axis=0).astype(np.float32)
        else:
            mask = None

        rs = np.random.RandomState(self.seed)
        n_groups = len(x) // s
        perm = (rs.permutation(n_groups)[:, None] * s + np.arange(s)[None, :]).reshape(-1)
        x, labels = x[perm], labels[perm]
        if mask is not None:
            mask = mask[perm]

        if self.normalize:
            if mask is not None:
                self.means, self.stds = masked_mean_std(x, mask)
                stds = np.where(self.stds == 0, 1.0, self.stds)
                x = ((x - self.means) / stds * mask).astype(np.float32)
            else:
                self.means = x.mean(axis=0)
                self.stds = np.where(x.std(axis=0) == 0, 1.0, x.std(axis=0))
                x = ((x - self.means) / self.stds).astype(np.float32)

        n_total = len(x)
        n_val = int(self.val_fraction * n_total)
        n_test = int(self.test_fraction * n_total)
        lo, hi = n_total - n_val - n_test, n_total - n_test
        lo -= lo % s  # split on event boundaries
        hi -= hi % s

        def sl(a, start, end):
            return a[start:end] if a is not None else None

        self.train = Split(x[:lo], sl(mask, 0, lo), labels[:lo])
        self.val = Split(x[lo:hi], sl(mask, lo, hi), labels[lo:hi])
        self.test = Split(x[hi:], sl(mask, hi, n_total), labels[hi:])
        self.tensor_test = self.test.x
        self.mask_test = self.test.mask
        self.tensor_conditioning_test = self.test.cond
        self.variable_jet_sizes = mask is not None

    def _batches(self, split, rng, drop_last):
        """Group-preserving batches: events (groups of num_sup_sets rows) are
        shuffled, not rows."""
        s = max(self.num_sup_sets, 1)
        if s == 1:
            yield from super()._batches(split, rng, drop_last)
            return
        order = np.arange(len(split) // s)
        if rng is not None:
            rng.shuffle(order)
        idx = (order[:, None] * s + np.arange(s)[None, :]).reshape(-1)
        stop = len(idx) - (len(idx) % self.batch_size) if drop_last else len(idx)
        for start in range(0, stop, self.batch_size):
            sel = idx[start : start + self.batch_size]
            mask = split.mask[sel] if split.mask is not None else None
            cond = split.cond[sel] if split.cond is not None else None
            yield split.x[sel], mask, cond
