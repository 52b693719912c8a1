"""JetClass classifier-test data, generated against simulated jets;
counterpart of particle_fm_tpu/data/jetclass_classifier.py, array for array
(numpy only).

Reads the classifier h5 that `eval_ckpt --write_classifier_h5` writes
(datasets part_data_{gen,sim}, part_mask_{gen,sim}, cond_data_{gen,sim}
with `names` attributes, and the `*_substructure.h5` twin with
{d2,tau1,tau2,tau21,tau3,tau32}_{gen,sim}), which needs h5py
(data/utils.py::import_h5py); `synthetic=True` makes a pair of the same
schema in memory instead (gen a smeared copy of sim) and opens no file.
Then as in the JAX package: the ParT-style particle features with the
reference's scalings (`derive_pf_features`), one jet flavour, labels gen 1
and sim 0 in `cond`, a shuffle with seed 1234 and the split by fractions.
With `use_hl_features` x is the flat (B, F) high-level features and the
mask None.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from particle_fm_tpu_torch.data.base import ArrayDataModule, Split
from particle_fm_tpu_torch.data.jetclass import JETCLASS_TYPES
from particle_fm_tpu_torch.data.utils import import_h5py

HL_NAMES = ["d2", "tau1", "tau2", "tau21", "tau3", "tau32"]

PF_FEATURES_KIN = [
    "part_etarel",
    "part_dphi",
    "log_part_pt",
    "log_part_energy",
    "log_part_ptrel",
    "log_part_energyrel",
    "part_deltaR",
]

NON_KIN_FEATURES = [
    "part_charge",
    "part_isChargedHadron",
    "part_isNeutralHadron",
    "part_isPhoton",
    "part_isElectron",
    "part_isMuon",
    "tanh_part_d0val",
    "part_d0err",
    "tanh_part_dzval",
    "part_dzerr",
]


def _decode(n):
    return n.decode() if isinstance(n, bytes) else str(n)


def _safe_log(x, eps=1e-9):
    return np.log(np.maximum(x, eps))


def derive_pf_features(parts, mask, cond, part_names, cond_names, *,
                       set_energy_equal_to_p=False,
                       set_neutral_particle_ips_zero=False, seed=1234):
    """(raw particle features, cond) -> named ParT-style feature dict.

    Exact scalings from jetclass_classifier_datamodule.py:308-345:
    log_part_pt = (log pt - 1.7)*0.7, log_part_energy = (log E - 2.0)*0.7,
    log_part_ptrel = (log ptrel + 4.7)*0.7, same for energyrel,
    part_deltaR = clip((hypot(etarel, dphi) - 0.2)*4, -5, 5).
    """
    part_names = [_decode(n) for n in part_names]
    cond_names = [_decode(n) for n in cond_names]
    ip = part_names.index
    ic = cond_names.index
    m = mask[..., 0]

    etarel = parts[..., ip("part_etarel")]
    dphi = parts[..., ip("part_dphi")]
    ptrel = parts[..., ip("part_ptrel")]
    jet_pt = cond[:, ic("jet_pt")][:, None]
    jet_eta = cond[:, ic("jet_eta")][:, None] if "jet_eta" in cond_names else 0.0

    pt = ptrel * jet_pt * m
    eta = (etarel + jet_eta) * m
    rng = np.random.default_rng(seed)
    # absolute phi is unphysical for *rel features; the reference assigns a
    # random jet phi (datamodule:222-225)
    phi = (dphi + rng.uniform(0, 2 * np.pi, size=(len(m), 1))) * m
    px, py, pz = pt * np.cos(phi), pt * np.sin(phi), pt * np.sinh(eta)
    p = np.sqrt(px**2 + py**2 + pz**2)

    if "part_energyrel" in part_names and "jet_energy" in cond_names and not set_energy_equal_to_p:
        energyrel = parts[..., ip("part_energyrel")]
        energy = energyrel * cond[:, ic("jet_energy")][:, None]
    else:
        energy = p
        energyrel = p / np.maximum(p.sum(axis=1, keepdims=True), 1e-9)

    def col(name, default=None):
        if name in part_names:
            return parts[..., ip(name)]
        if default is not None:
            return np.full_like(etarel, default)
        return np.zeros_like(etarel)

    feats = {
        "part_etarel": etarel,
        "part_dphi": dphi,
        "log_part_pt": np.where(m > 0, (_safe_log(pt) - 1.7) * 0.7, 0.0),
        "log_part_energy": np.where(m > 0, (_safe_log(energy) - 2.0) * 0.7, 0.0),
        "log_part_ptrel": np.where(m > 0, (_safe_log(ptrel) + 4.7) * 0.7, 0.0),
        "log_part_energyrel": np.where(m > 0, (_safe_log(energyrel) + 4.7) * 0.7, 0.0),
        "part_deltaR": np.clip((np.hypot(etarel, dphi) - 0.2) * 4.0, -5, 5) * m,
        "part_charge": col("part_charge"),
        "part_isChargedHadron": col("part_isChargedHadron"),
        "part_isNeutralHadron": col("part_isNeutralHadron"),
        "part_isPhoton": col("part_isPhoton"),
        "part_isElectron": col("part_isElectron"),
        "part_isMuon": col("part_isMuon"),
        "tanh_part_d0val": np.tanh(col("part_d0val")),
        "part_d0err": np.clip(col("part_d0err"), 0, 1),
        "tanh_part_dzval": np.tanh(col("part_dzval")),
        "part_dzerr": np.clip(col("part_dzerr"), 0, 1),
    }
    if set_neutral_particle_ips_zero:
        charged = (
            (feats["part_isChargedHadron"] != 0)
            | (feats["part_isElectron"] != 0)
            | (feats["part_isMuon"] != 0)
        )
        for k in ("tanh_part_d0val", "part_d0err", "tanh_part_dzval", "part_dzerr"):
            feats[k] = np.where(charged, feats[k], 0.0)
    return feats


@dataclass
class JetClassClassifierDataModule(ArrayDataModule):
    data_dir: str = "data/"
    data_file: Optional[str] = None
    train_val_test_split: tuple = (0.5, 0.2, 0.3)
    number_of_jets: Optional[int] = None
    used_flavor: Optional[str] = None  # e.g. "Tbqq"
    kin_only: bool = False
    pf_features_list: Optional[list] = None
    hl_features_list: Optional[list] = None
    use_hl_features: bool = False
    set_energy_equal_to_p: bool = False
    set_neutral_particle_ips_zero: bool = False
    synthetic: bool = False
    synthetic_num_jets: int = 2000
    synthetic_num_particles: int = 32
    seed: int = 1234

    names_pf_features: Optional[list] = None
    names_hl_features: Optional[list] = None

    # ------------------------------------------------------------- loading
    def _load_h5(self):
        h5py = import_h5py()
        with h5py.File(self.data_file, "r") as f:
            part_names = list(f["part_data_sim"].attrs["names"])
            cond_names = list(f["cond_data_sim"].attrs["names"])
            n = self.number_of_jets
            out = {
                key: np.asarray(f[key][:n])
                for key in (
                    "part_data_gen", "part_mask_gen", "cond_data_gen",
                    "part_data_sim", "part_mask_sim", "cond_data_sim",
                )
            }
        hl = {}
        subs = (self.data_file or "").replace(".h5", "_substructure.h5")
        if os.path.isfile(subs):
            with h5py.File(subs, "r") as f:
                for name in HL_NAMES:
                    for tag in ("gen", "sim"):
                        key = f"{name}_{tag}"
                        if key in f:
                            hl[key] = np.asarray(f[key][: self.number_of_jets])
        return out, part_names, cond_names, hl

    def _load_synthetic(self):
        """Schema-compatible synthetic gen/sim pair: gen is a smeared copy of
        sim so the classifier has real signal to find (tests, smoke runs)."""
        rs = np.random.RandomState(self.seed)
        n, npart = self.synthetic_num_jets, self.synthetic_num_particles
        mult = rs.randint(4, npart + 1, size=n)
        mask = (np.arange(npart)[None, :] < mult[:, None]).astype(np.float32)[..., None]
        etarel = rs.normal(0, 0.3, (n, npart)).astype(np.float32)
        dphi = rs.normal(0, 0.3, (n, npart)).astype(np.float32)
        raw = rs.exponential(1.0, (n, npart)).astype(np.float32) * mask[..., 0]
        ptrel = raw / np.maximum(raw.sum(1, keepdims=True), 1e-9)
        sim = np.stack([etarel, dphi, ptrel], axis=-1) * mask
        gen = sim + rs.normal(0, 0.05, sim.shape).astype(np.float32) * mask
        n_types = 3
        types = rs.randint(0, n_types, size=n)
        cond = np.concatenate(
            [
                np.eye(n_types, dtype=np.float32)[types],
                rs.uniform(400, 1000, (n, 1)).astype(np.float32),
                rs.normal(0, 1.5, (n, 1)).astype(np.float32),
            ],
            axis=-1,
        )
        cond_names = [f"jet_type_label_{t}" for t in JETCLASS_TYPES[:n_types]] + [
            "jet_pt", "jet_eta",
        ]
        part_names = ["part_etarel", "part_dphi", "part_ptrel"]
        arrays = {
            "part_data_gen": gen, "part_mask_gen": mask, "cond_data_gen": cond,
            "part_data_sim": sim, "part_mask_sim": mask.copy(), "cond_data_sim": cond.copy(),
        }
        hl = {
            f"{name}_{tag}": rs.rand(n).astype(np.float32)
            for name in HL_NAMES for tag in ("gen", "sim")
        }
        return arrays, part_names, cond_names, hl

    # --------------------------------------------------------------- setup
    def setup(self) -> None:
        if self.train is not None:
            return
        if self.synthetic:
            arrays, part_names, cond_names, hl = self._load_synthetic()
        else:
            if not self.data_file:
                raise ValueError("data_file must be specified (or synthetic=True)")
            arrays, part_names, cond_names, hl = self._load_h5()

        parts = np.concatenate([arrays["part_data_gen"], arrays["part_data_sim"]])
        mask = np.concatenate([arrays["part_mask_gen"], arrays["part_mask_sim"]])
        if mask.ndim == 2:
            mask = mask[..., None]
        cond = np.concatenate([arrays["cond_data_gen"], arrays["cond_data_sim"]])
        # reference labels: gen = 1, sim = 0 (datamodule:123,128)
        y = np.concatenate(
            [np.ones(len(arrays["part_data_gen"])), np.zeros(len(arrays["part_data_sim"]))]
        ).astype(np.float32)[:, None]

        if hl:
            hl_all = np.stack(
                [
                    np.concatenate([hl[f"{name}_gen"], hl[f"{name}_sim"]])
                    for name in HL_NAMES
                ],
                axis=-1,
            ).astype(np.float32)
        else:
            hl_all = np.zeros((len(parts), len(HL_NAMES)), np.float32)

        cond_names_d = [_decode(n) for n in cond_names]
        if self.used_flavor is not None:
            idx = cond_names_d.index(f"jet_type_label_{self.used_flavor}")
            sel = cond[:, idx] == 1
            parts, mask, cond, y, hl_all = (
                parts[sel], mask[sel], cond[sel], y[sel], hl_all[sel]
            )

        feats = derive_pf_features(
            parts, mask, cond, part_names, cond_names,
            set_energy_equal_to_p=self.set_energy_equal_to_p,
            set_neutral_particle_ips_zero=self.set_neutral_particle_ips_zero,
            seed=self.seed,
        )
        if self.kin_only:
            names = list(PF_FEATURES_KIN)
        elif self.pf_features_list is not None:
            names = list(self.pf_features_list)
        else:
            names = list(feats.keys())
        self.names_pf_features = names
        x = np.stack([feats[n] for n in names], axis=-1).astype(np.float32)
        x = x * mask

        self.names_hl_features = list(self.hl_features_list or HL_NAMES)
        hl_sel = hl_all[:, [HL_NAMES.index(n) for n in self.names_hl_features]]

        if self.use_hl_features:
            x, mask = hl_sel, None

        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(len(x))
        x, y = x[perm], y[perm]
        mask = mask[perm] if mask is not None else None

        fr_train, fr_val, _ = self.train_val_test_split
        n_total = len(x)
        lo = int(fr_train * n_total)
        hi = int((fr_train + fr_val) * n_total)

        def sl(a, s, e):
            return a[s:e] if a is not None else None

        self.train = Split(x[:lo], sl(mask, 0, lo), y[:lo])
        self.val = Split(x[lo:hi], sl(mask, lo, hi), y[lo:hi])
        self.test = Split(x[hi:], sl(mask, hi, n_total), y[hi:])
        self.tensor_test = self.test.x
        self.mask_test = self.test.mask
        self.tensor_conditioning_test = self.test.cond
        self.means = None
        self.stds = None
        self.variable_jet_sizes = mask is not None
