"""CaloChallenge datamodule: variable-length calorimeter hit clouds;
counterpart of particle_fm_tpu/data/calo.py, batch for batch (numpy only).

Batches are padded to a small set of lengths (multiples of
`bucket_multiple`) over showers sorted by length; with
`max_tokens_per_batch` a batch grows while its padded size stays within the
budget, so short showers come in larger batches. The conditioning is
log(E_inc) - 10. With `rotate_alpha` each train batch shifts every real
hit's raw alpha bin by a random amount (mod `n_alpha_bins`) before the
scaler is applied. The scaler is fitted on the train split's raw hits at
setup when it is not fitted yet.

Batches are built on the host per epoch (`device_cacheable = False`): the
Trainer streams them to the device through data/prefetch.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np

from particle_fm_tpu_torch.data.base import ArrayDataModule, Split
from particle_fm_tpu_torch.data.synthetic import synthetic_calo


def _pad_to(arrs: list[np.ndarray], length: int) -> tuple[np.ndarray, np.ndarray]:
    """Stack variable-length (n_i, F) arrays padded to `length`."""
    batch = np.zeros((len(arrs), length, arrs[0].shape[-1]), np.float32)
    mask = np.zeros((len(arrs), length, 1), np.float32)
    for i, a in enumerate(arrs):
        n = len(a)
        batch[i, :n] = a
        mask[i, :n] = 1.0
    return batch, mask


@dataclass
class CaloChallengeDataModule(ArrayDataModule):
    data_dir: str = "data/"
    dataset_file: Optional[str] = None  # npz with ragged arrays or (x, mask, E)
    val_fraction: float = 0.1
    test_fraction: float = 0.1
    max_hits: int = 6000
    bucket_multiple: int = 64
    max_tokens_per_batch: Optional[int] = None  # e.g. 400_000 (configs/data/calo)
    n_alpha_bins: int = 16  # alpha quantization for the rotation augmentation
    rotate_alpha: bool = False
    alpha_index: int = 2  # feature order (E, z, alpha, r)
    scaler: object = None  # optional ScalerBase applied to real hits
    seed: int = 0
    synthetic: bool = False
    synthetic_num_showers: int = 2000

    _sequences: list = field(default_factory=list, repr=False)
    _energies: Optional[np.ndarray] = None
    device_cacheable: bool = False  # bucketed shapes; batches built on host

    def _load(self):
        if self.synthetic:
            x, mask, e = synthetic_calo(self.synthetic_num_showers, min(self.max_hits, 200),
                                        seed=self.seed)
            seqs = [x[i][mask[i, :, 0] > 0] for i in range(len(x))]
            return seqs, e
        if self.dataset_file is None:
            raise FileNotFoundError(
                "CaloChallengeDataModule needs dataset_file (npz with 'showers' object "
                "array + 'energies') or synthetic=True"
            )
        data = np.load(self.dataset_file, allow_pickle=True)
        return list(data["showers"]), np.asarray(data["energies"]).reshape(-1, 1)

    def setup(self) -> None:
        if self.train is not None:
            return
        raw_seqs, energies = self._load()
        # truncate over-long showers to max_hits (_pad_to cannot pad past it)
        raw_seqs = [s[: self.max_hits] for s in raw_seqs]
        # keep RAW sequences for batching: the alpha-rotation augmentation
        # operates on raw bin indices; the scaler is applied per batch after it
        self._raw_sequences = raw_seqs
        n = len(raw_seqs)
        n_val = int(self.val_fraction * n)
        n_test = int(self.test_fraction * n)
        n_train = n - n_val - n_test
        if self.scaler is not None and not getattr(self.scaler, "fitted_", True):
            # fit on the train split's hits only
            self.scaler.fit(np.concatenate(raw_seqs[:n_train], axis=0))
        if self.scaler is not None:
            seqs = [self.scaler.transform(s) for s in raw_seqs]
        else:
            seqs = raw_seqs
        cond = (np.log(energies) - 10.0).astype(np.float32)

        self._splits = {
            "train": (seqs[:n_train], cond[:n_train]),
            "val": (seqs[n_train : n_train + n_val], cond[n_train : n_train + n_val]),
            "test": (seqs[n_train + n_val :], cond[n_train + n_val :]),
        }
        self._raw_splits = {
            "train": raw_seqs[:n_train],
            "val": raw_seqs[n_train : n_train + n_val],
            "test": raw_seqs[n_train + n_val :],
        }
        # padded full tensors for eval callbacks
        max_len = self._bucket_len(max(len(s) for s in seqs))
        for name in ("train", "val", "test"):
            s, c = self._splits[name]
            x, m = _pad_to(s, max_len)
            setattr(self, f"tensor_{name}", x)
            setattr(self, f"mask_{name}", m)
            setattr(self, f"tensor_conditioning_{name}", c)
        self.train = Split(self.tensor_train, self.mask_train, self._splits["train"][1])
        self.val = Split(self.tensor_val, self.mask_val, self._splits["val"][1])
        self.test = Split(self.tensor_test, self.mask_test, self._splits["test"][1])

    def _bucket_len(self, n: int) -> int:
        m = self.bucket_multiple
        return min(max(((n + m - 1) // m) * m, m), self.max_hits)

    def _rotate(self, x: np.ndarray, mask: np.ndarray, rs) -> np.ndarray:
        """Random per-hit cyclic alpha-bin shift."""
        a = x[..., self.alpha_index]
        shift = rs.randint(0, self.n_alpha_bins, size=a.shape)
        x = x.copy()
        x[..., self.alpha_index] = np.where(
            mask[..., 0] > 0, np.mod(a + shift, self.n_alpha_bins), a
        )
        return x

    def _batch_groups(self, name: str) -> list[np.ndarray]:
        """The split's showers grouped into batches, in length order: with
        `max_tokens_per_batch` a batch grows while its padded size stays
        within the budget (the showers are sorted, so the last one sets the
        pad length)."""
        seqs, _ = self._splits[name]
        order = np.argsort([len(s) for s in seqs])
        batches = []
        i = 0
        while i < len(order):
            bs = self.batch_size
            if self.max_tokens_per_batch:
                bs = 1
                while (
                    bs < self.batch_size
                    and i + bs < len(order)
                    and (bs + 1) * self._bucket_len(len(seqs[order[i + bs]]))
                    <= self.max_tokens_per_batch
                ):
                    bs += 1
            batches.append(order[i : i + bs])
            i += bs
        return batches

    def _bucketed_batches(
        self, name: str, shuffle_seed: int | None, augment: bool
    ) -> Iterator[tuple]:
        seqs, cond = self._splits[name]
        batches = self._batch_groups(name)
        rs = np.random.default_rng(shuffle_seed) if shuffle_seed is not None else None
        if rs is not None:
            rs.shuffle(batches)
        aug_rs = np.random.RandomState(0 if shuffle_seed is None else shuffle_seed)
        do_rotate = augment and self.rotate_alpha
        raw_seqs = self._raw_splits[name]
        for sel in batches:
            if do_rotate:
                # rotate the raw alpha bins, then apply the scaler
                arrs = [raw_seqs[j] for j in sel]
                blen = self._bucket_len(max(len(a) for a in arrs))
                x, m = _pad_to(arrs, blen)
                x = self._rotate(x, m, aug_rs)
                if self.scaler is not None:
                    keep = m[..., 0] > 0
                    x[keep] = self.scaler.transform(x[keep])
            else:
                arrs = [seqs[j] for j in sel]
                blen = self._bucket_len(max(len(a) for a in arrs))
                x, m = _pad_to(arrs, blen)
            yield x, m, cond[sel]

    def train_batches(self, seed: int = 0) -> Iterator[tuple]:
        return self._bucketed_batches("train", shuffle_seed=seed, augment=True)

    def val_batches(self) -> Iterator[tuple]:
        return self._bucketed_batches("val", shuffle_seed=None, augment=False)

    def test_batches(self) -> Iterator[tuple]:
        return self._bucketed_batches("test", shuffle_seed=None, augment=False)

    @property
    def steps_per_epoch(self) -> int:
        """The bucketed batches of an epoch (token-budget batches are smaller
        than batch_size, so len // batch_size would undercount and corrupt
        schedule lengths and resume accounting)."""
        return max(len(self._batch_groups("train")), 1)
