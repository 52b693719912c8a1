"""GenChallenge (the anomaly-detection generative challenge 2023)
datamodule; counterpart of particle_fm_tpu/data/gen_challenge.py.

K-fold .npy files (`outerdata_kfold_{0..4}.npy` for the sidebands,
`innerdata_kfold_{0..4}.npy` for the signal region): column 0 is mjj, the
conditioning, the other columns the flat features. Folds `val_sets` and
`test_sets` are held out, the others train. Every split has a signal-region
twin (`*_sr`).

Preprocessing, as in the JAX module: the optional logit transform
(data/calo_scalers.py::LogitScaler, epsilon 0.01, fitted on the train
sideband features only), then the sigma-scaled z-score with the features'
standard deviation over the population (ddof=0) and mjj's over the sample
(ddof=1). The test split's features stay unnormalised; its mjj is
normalised. `synthetic=True` draws each fold from
`RandomState(seed + k)` (+100 for the signal region), as the JAX module does.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from particle_fm_tpu_torch.data.base import ArrayDataModule, Split
from particle_fm_tpu_torch.data.calo_scalers import LogitScaler
from particle_fm_tpu_torch.data.utils import normalize_tensor


@dataclass
class GenChallengeDataModule(ArrayDataModule):
    data_dir: str = "data/"
    val_sets: tuple = (3,)
    test_sets: tuple = (4,)
    normalize: bool = True
    normalize_sigma: float = 5
    logit_transform: bool = False
    synthetic: bool = False
    synthetic_num_events: int = 4000
    seed: int = 0

    tensor_train_sr: Optional[np.ndarray] = None
    tensor_val_sr: Optional[np.ndarray] = None
    tensor_test_sr: Optional[np.ndarray] = None
    tensor_conditioning_train_sr: Optional[np.ndarray] = None
    tensor_conditioning_val_sr: Optional[np.ndarray] = None
    tensor_conditioning_test_sr: Optional[np.ndarray] = None

    def _load_fold(self, prefix: str, k: int) -> np.ndarray:
        if self.synthetic:
            rs = np.random.RandomState(self.seed + k + (100 if prefix == "innerdata" else 0))
            n = self.synthetic_num_events // 5
            mjj = (rs.uniform(3300, 3700, (n, 1)) if prefix == "innerdata"
                   else rs.uniform(2300, 3300, (n, 1)))
            feats = rs.randn(n, 4) * [50, 0.5, 50, 0.5] + [150, 0.3, 200, 0.4]
            return np.concatenate([mjj, feats], axis=-1).astype(np.float32)
        return np.load(os.path.join(self.data_dir, f"{prefix}_kfold_{k}.npy"))

    def setup(self) -> None:
        if self.train is not None:
            return
        outer = [self._load_fold("outerdata", k) for k in range(5)]
        inner = [self._load_fold("innerdata", k) for k in range(5)]
        held = set(self.val_sets) | set(self.test_sets)

        def fold_concat(folds, idxs):
            return np.concatenate([folds[i] for i in idxs], axis=0)

        train_idx = [i for i in range(5) if i not in held]
        splits = {
            "train": (fold_concat(outer, train_idx), fold_concat(inner, train_idx)),
            "val": (fold_concat(outer, self.val_sets), fold_concat(inner, self.val_sets)),
            "test": (fold_concat(outer, self.test_sets), fold_concat(inner, self.test_sets)),
        }

        self.scaler = None
        if self.logit_transform:
            self.scaler = LogitScaler(eps=0.01)
            self.scaler.fit(splits["train"][0][:, 1:].astype(np.float32))

        data = {}
        for name, (sb, sr) in splits.items():
            x, c = sb[:, 1:].astype(np.float32), sb[:, :1].astype(np.float32)
            xs, cs = sr[:, 1:].astype(np.float32), sr[:, :1].astype(np.float32)
            if self.scaler is not None:
                x = self.scaler.transform(x).astype(np.float32)
                xs = self.scaler.transform(xs).astype(np.float32)
            data[name] = (x, c, xs, cs)
            setattr(self, f"tensor_{name}", x.copy())
            setattr(self, f"tensor_{name}_sr", xs.copy())

        if self.normalize:
            x_tr, c_tr = data["train"][0], data["train"][1]
            self.means = x_tr.mean(axis=0)
            stds = x_tr.std(axis=0)
            self.stds = np.where(stds == 0, 1.0, stds)
            self.cond_means = c_tr.mean(axis=0)
            stds_c = c_tr.std(axis=0, ddof=1)
            self.cond_stds = np.where(stds_c == 0, 1.0, stds_c)

            def norm(x):
                return normalize_tensor(x, self.means, self.stds,
                                        self.normalize_sigma).astype(np.float32)

            def cnorm(c):
                return normalize_tensor(c, self.cond_means, self.cond_stds,
                                        self.normalize_sigma).astype(np.float32)

            for name in data:
                x, c, xs, cs = data[name]
                if name != "test":
                    x, xs = norm(x), norm(xs)
                data[name] = (x, cnorm(c), xs, cnorm(cs))

        for name, (x, c, xs, cs) in data.items():
            setattr(self, f"tensor_conditioning_{name}", c)
            setattr(self, f"tensor_conditioning_{name}_sr", cs)
        self.train = Split(data["train"][0], None, data["train"][1])
        self.val = Split(data["val"][0], None, data["val"][1])
        self.test = Split(data["test"][0], None, data["test"][1])
        self.variable_jet_sizes = False
