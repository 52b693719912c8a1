"""JetNet datamodule; counterpart of particle_fm_tpu/data/jetnet.py.

Pipeline: load -> (optional) center jets -> mask/truncate to num_particles
-> split train/val/test (the reference's historical len-1 offsets kept) ->
one-hot jet-type conditioning -> sigma-scaled z-score normalisation with
masked statistics of the train split.

Data sources: `synthetic=True` (schema-compatible synthetic jets, array for
array those of the JAX datamodule), or the
`{data_dir}/jetnet/{type}{30|150}.hdf5` files in the jetnet package's
on-disk format (datasets 'particle_features', 'jet_features'), read with
h5py. The port downloads nothing: without the files it raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from particle_fm_tpu_torch.data.base import ArrayDataModule, Split, reference_split
from particle_fm_tpu_torch.data.synthetic import synthetic_jetnet
from particle_fm_tpu_torch.data.utils import (
    center_jets,
    mask_data,
    masked_mean_std,
    normalize_tensor,
    one_hot_encode,
)


@dataclass
class JetNetDataModule(ArrayDataModule):
    data_dir: str = "data/"
    val_fraction: float = 0.15
    test_fraction: float = 0.15
    # data
    jet_type: tuple = ("t",)
    num_particles: int = 150
    variable_jet_sizes: bool = True
    conditioning_type: bool = True
    conditioning_pt: bool = True
    conditioning_eta: bool = True
    conditioning_mass: bool = True
    conditioning_num_particles: bool = True
    # preprocessing
    centering: bool = True
    normalize: bool = True
    normalize_sigma: float = 5
    # synthetic data (no files needed)
    synthetic: bool = False
    synthetic_num_jets: int = 20000
    seed: int = 0

    @property
    def num_cond_features(self) -> int:
        return sum(
            [
                self.conditioning_pt,
                self.conditioning_eta,
                self.conditioning_mass,
                self.conditioning_num_particles,
            ]
            + [self.conditioning_type] * len(self.jet_type)
        )

    # ------------------------------------------------------------- loading
    def _load(self) -> tuple[np.ndarray, np.ndarray]:
        load_n = 150 if self.num_particles > 30 else 30
        if self.num_particles in (30, 150):
            load_n = self.num_particles
        if self.synthetic:
            return synthetic_jetnet(
                list(self.jet_type), self.synthetic_num_jets, load_n, seed=self.seed
            )
        parts, jets = [], []
        for jt in self.jet_type:
            fname = os.path.join(self.data_dir, "jetnet", f"{jt}{load_n}.hdf5")
            if not os.path.exists(fname):
                raise FileNotFoundError(
                    f"JetNet file {fname} not found and the jetnet package is "
                    "unavailable; pass synthetic=True or provide the hdf5 files."
                )
            import h5py

            with h5py.File(fname, "r") as f:
                parts.append(np.asarray(f["particle_features"]))
                jets.append(np.asarray(f["jet_features"]))
        return np.concatenate(parts, axis=0), np.concatenate(jets, axis=0)

    # --------------------------------------------------------------- setup
    def setup(self) -> None:
        if self.train is not None:
            return
        particle_data, jet_data = self._load()

        if self.centering:
            m = particle_data[..., 3]
            centered = center_jets(particle_data[..., :3])
            particle_data = np.append(centered, m[..., None], axis=-1)

        x, mask, _, jet_data = mask_data(
            particle_data,
            jet_data,
            num_particles=self.num_particles,
            variable_jet_sizes=self.variable_jet_sizes,
        )

        end_train, end_val = reference_split(len(x), self.val_fraction, self.test_fraction)
        x_tr, x_va, x_te = x[:end_train], x[end_train:end_val], x[end_val:]
        m_tr, m_va, m_te = mask[:end_train], mask[end_train:end_val], mask[end_val:]

        cond = self._handle_conditioning(jet_data)
        if cond is not None:
            c_tr, c_va, c_te = (
                cond[:end_train].astype(np.float32),
                cond[end_train:end_val].astype(np.float32),
                cond[end_val:].astype(np.float32),
            )
        else:
            c_tr = c_va = c_te = None

        # raw (unnormalized) particle tensors for eval callbacks
        self.tensor_train, self.mask_train = x_tr.copy(), m_tr
        self.tensor_val, self.mask_val = x_va.copy(), m_va
        self.tensor_test, self.mask_test = x_te.copy(), m_te

        if self.normalize:
            means, stds = masked_mean_std(x_tr, m_tr)
            self.means, self.stds = means, stds
            x_tr = (normalize_tensor(x_tr, means, stds, self.normalize_sigma) * m_tr).astype(
                np.float32
            )
            x_va = (normalize_tensor(x_va, means, stds, self.normalize_sigma) * m_va).astype(
                np.float32
            )
            if cond is not None:
                # cond stats use torch-style ddof=1 (jetnet_datamodule.py:265-266);
                # constant columns (e.g. a single-type one-hot) would make
                # std=0 -> NaN in the reference — guard them to 1 so the
                # column normalizes to exactly 0 instead
                self.cond_means = c_tr.mean(axis=0)
                stds_c = c_tr.std(axis=0, ddof=1)
                self.cond_stds = np.where(stds_c == 0, 1.0, stds_c)
                c_tr = normalize_tensor(c_tr, self.cond_means, self.cond_stds, self.normalize_sigma)
                c_va = normalize_tensor(c_va, self.cond_means, self.cond_stds, self.normalize_sigma)
                c_te = normalize_tensor(c_te, self.cond_means, self.cond_stds, self.normalize_sigma)

        # NB: like the reference, the test particle tensors stay unnormalized
        # (eval callbacks consume physical units, jetnet_datamodule.py:308-319)
        # while conditioning is stored normalized for all splits (:284-290,367-369)
        # — the model always consumes normalized cond.
        self.tensor_conditioning_train = c_tr
        self.tensor_conditioning_val = c_va
        self.tensor_conditioning_test = c_te
        self.train = Split(x_tr.astype(np.float32), m_tr, c_tr)
        self.val = Split(x_va.astype(np.float32), m_va, c_va)
        self.test = Split(x_te.astype(np.float32), m_te, c_te)

    def _handle_conditioning(self, jet_data: np.ndarray) -> Optional[np.ndarray]:
        """One-hot the jet type and select the requested conditioning columns.
        Parity: jetnet_datamodule.py:413-446."""
        categories = np.unique(jet_data[:, 0])
        one_hot = one_hot_encode(
            jet_data, categories=list(categories), num_other_features=jet_data.shape[1] - 1
        )
        if not any(
            [
                self.conditioning_type,
                self.conditioning_pt,
                self.conditioning_eta,
                self.conditioning_mass,
                self.conditioning_num_particles,
            ]
        ):
            return None
        k = len(categories)
        keep = []
        if self.conditioning_type:
            keep.extend(range(k))
        if self.conditioning_pt:
            keep.append(k)
        if self.conditioning_eta:
            keep.append(k + 1)
        if self.conditioning_mass:
            keep.append(k + 2)
        if self.conditioning_num_particles:
            keep.append(k + 3)
        return one_hot[:, keep]
