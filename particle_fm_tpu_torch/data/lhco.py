"""LHCO R&D datamodules (dijet anomaly detection); counterpart of
particle_fm_tpu/data/lhco.py, array for array (numpy only).

LHCODataModule: clustered dijet constituents.
  - mjj sideband split: keep (2300, 3300) U (3700, 5000); the signal region
    (SR) (3300, 3700) is kept as parallel `*_sr` arrays for the anomaly
    pipeline;
  - jet modes: "x"/"y" (leading/subleading jet), "all" (both jets stacked in
    Fortran order, so that the two jets of an event interleave), "all_one_pc"
    (both jets merged into one 2N-particle cloud);
  - constituents reordered (pt, eta, phi) -> (eta, phi, pt) as in JetNet;
  - optional log-pt log(1 - pt_rel) and a separate pt standardisation
    ((eta, phi) with sigma=10, pt with sigma=5);
  - conditioning: the dijet jet features (+ multiplicities).

LHCOJetFeatureDataModule: flat dijet features for stage 1 of the two-stage
pipeline: (jet1, jet2) x (pt, eta, phi, m) + multiplicities -> (B, 10), or
as a 2-element set (B, 2, 5) with `set_data`; conditioning = mjj.

LHCOWholeEventDataModule: the raw event record as one point cloud (up to
560 particles, no jet clustering), conditioned on mjj.

As in the JAX package, the validation pt under pt_standardization is
normalised with sigma=5, as the training pt is. The files are read with
h5py (and the raw event record with pandas), imported only when a file is
read; `synthetic=True` needs neither.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from particle_fm_tpu_torch.data.base import ArrayDataModule, Split
from particle_fm_tpu_torch.data.synthetic import synthetic_lhco
from particle_fm_tpu_torch.data.utils import (
    get_mjj,
    mask_data,
    masked_mean_std,
    normalize_tensor,
)


def _split3(arr, val_fraction, test_fraction):
    n = len(arr)
    n_val = int(val_fraction * n)
    n_test = int(test_fraction * n)
    return np.split(arr, [n - (n_val + n_test), n - n_test])


@dataclass
class LHCODataModule(ArrayDataModule):
    data_dir: str = "data/"
    val_fraction: float = 0.15
    test_fraction: float = 0.15
    file_suffix_processed_data: str = ""
    relative_coords: bool = True
    # data
    jet_type: str = "x"  # "x" | "y" | "all" | "all_one_pc"
    num_particles: int = 279
    variable_jet_sizes: bool = True
    conditioning: bool = True
    multiplicity_conditioning: bool = False
    # preprocessing
    normalize: bool = True
    normalize_sigma: float = 5
    log_pt: bool = False
    pt_standardization: bool = False
    shuffle_data: bool = False
    seed: int = 0
    # sandbox
    synthetic: bool = False
    synthetic_num_events: int = 4000

    # populated in setup (beyond the base fields): SR twins
    tensor_train_sr: Optional[np.ndarray] = None
    mask_train_sr: Optional[np.ndarray] = None
    tensor_val_sr: Optional[np.ndarray] = None
    mask_val_sr: Optional[np.ndarray] = None
    tensor_test_sr: Optional[np.ndarray] = None
    mask_test_sr: Optional[np.ndarray] = None
    tensor_conditioning_train_sr: Optional[np.ndarray] = None
    tensor_conditioning_val_sr: Optional[np.ndarray] = None
    tensor_conditioning_test_sr: Optional[np.ndarray] = None
    mjj: Optional[np.ndarray] = None
    mjj_sr: Optional[np.ndarray] = None
    jet_data_raw: Optional[np.ndarray] = None
    particle_data_raw: Optional[np.ndarray] = None
    mask_raw: Optional[np.ndarray] = None

    def _load(self):
        if self.synthetic:
            jets, consts, mask = synthetic_lhco(
                self.synthetic_num_events, max(self.num_particles, 8), seed=self.seed
            )
            if self.relative_coords:
                # the generator emits absolute (pt, eta, phi); the `_rel`
                # file stores per-jet relative constituents (pt/jet_pt,
                # eta - jet_eta, wrap(phi - jet_phi))
                m = mask[..., 0:1]
                rel_pt = consts[..., 0:1] / np.maximum(jets[:, :, None, 0:1], 1e-9)
                rel_eta = consts[..., 1:2] - jets[:, :, None, 1:2]
                dphi = consts[..., 2:3] - jets[:, :, None, 2:3]
                dphi = np.where(dphi > np.pi, dphi - 2 * np.pi, dphi)
                dphi = np.where(dphi < -np.pi, dphi + 2 * np.pi, dphi)
                consts = (
                    np.concatenate([rel_pt, rel_eta, dphi], axis=-1) * m
                ).astype(np.float32)
            return jets, consts, mask
        suffix = "_rel" if self.relative_coords else ""
        path = os.path.join(
            self.data_dir,
            "lhco",
            "final_data",
            f"processed_data_background{suffix}{self.file_suffix_processed_data}.h5",
        )
        import h5py

        with h5py.File(path, "r") as f:
            jet_data = np.asarray(f["jet_data"])
            particle_data = np.asarray(f["constituents"])
            mask = np.asarray(f["mask"])
        return jet_data, particle_data, mask

    def setup(self) -> None:
        if self.train is not None:
            return
        jet_data, particle_data, mask = self._load()

        # mjj sideband/signal-region windows
        mjj = get_mjj(jet_data[:, 0], jet_data[:, 1])
        keep = ((mjj < 3300) & (mjj > 2300)) | ((mjj > 3700) & (mjj < 5000))
        keep_sr = (mjj > 3300) & (mjj < 3700)

        jd, pd_, mk = jet_data[keep], particle_data[keep], mask[keep]
        jd_sr, pd_sr, mk_sr = jet_data[keep_sr], particle_data[keep_sr], mask[keep_sr]
        self.mjj, self.mjj_sr = mjj[keep], mjj[keep_sr]

        if self.multiplicity_conditioning:
            jd = np.concatenate([jd, np.sum(mk, axis=-2)], axis=-1)
            jd_sr = np.concatenate([jd_sr, np.sum(mk_sr, axis=-2)], axis=-1)

        def select(jd, pd_, mk):
            if self.jet_type == "all_one_pc":
                pd2 = pd_.reshape(pd_.shape[0], -1, pd_.shape[-1])
                mk2 = mk.reshape(mk.shape[0], -1, mk.shape[-1])
                jd2 = jd.reshape(jd.shape[0], -1)
                return jd2, pd2, mk2
            if self.jet_type == "all":
                pd2 = pd_[:, :, : self.num_particles, :]
                mk2 = mk[:, :, : self.num_particles, :]
                jd2 = np.reshape(jd, (-1, jd.shape[-1]), order="F")
                pd2 = np.reshape(pd2, (-1,) + pd2.shape[-2:], order="F")
                mk2 = np.reshape(mk2, (-1,) + mk2.shape[-2:], order="F")
                return jd2, pd2, mk2
            idx = {"x": 0, "y": 1}[self.jet_type]
            return (
                jd[:, idx],
                pd_[:, idx, : self.num_particles, :],
                mk[:, idx, : self.num_particles, :],
            )

        jd, pd_, mk = select(jd, pd_, mk)
        jd_sr, pd_sr, mk_sr = select(jd_sr, pd_sr, mk_sr)
        self.jet_data_raw, self.particle_data_raw, self.mask_raw = (
            jd.copy(), pd_.copy(), mk.copy(),
        )

        # reorder (pt, eta, phi) -> (eta, phi, pt) to match JetNet conventions
        def prep(pd_, mk):
            pd2 = pd_[:, :, [1, 2, 0]]
            return np.concatenate([pd2, mk], axis=-1)

        pd_ = prep(pd_, mk)
        pd_sr = prep(pd_sr, mk_sr)

        if self.shuffle_data:
            rs = np.random.RandomState(self.seed)
            perm = rs.permutation(len(pd_))
            pd_ = pd_[perm]
            if jd is not None and len(jd) == len(pd_):
                jd = jd[perm]
            perm_sr = rs.permutation(len(pd_sr))
            pd_sr = pd_sr[perm_sr]
            if jd_sr is not None and len(jd_sr) == len(pd_sr):
                jd_sr = jd_sr[perm_sr]

        num_p = pd_.shape[1] if self.jet_type == "all_one_pc" else self.num_particles
        x, m, _, jd = mask_data(pd_, jd, num_p, self.variable_jet_sizes)
        x_sr, m_sr, _, jd_sr = mask_data(pd_sr, jd_sr, num_p, self.variable_jet_sizes)

        cond = jd.astype(np.float32) if self.conditioning else None
        cond_sr = jd_sr.astype(np.float32) if self.conditioning else None

        x_tr, x_va, x_te = _split3(x, self.val_fraction, self.test_fraction)
        m_tr, m_va, m_te = _split3(m, self.val_fraction, self.test_fraction)
        xs_tr, xs_va, xs_te = _split3(x_sr, self.val_fraction, self.test_fraction)
        ms_tr, ms_va, ms_te = _split3(m_sr, self.val_fraction, self.test_fraction)
        if cond is not None:
            c_tr, c_va, c_te = _split3(cond, self.val_fraction, self.test_fraction)
            cs_tr, cs_va, cs_te = _split3(cond_sr, self.val_fraction, self.test_fraction)
        else:
            c_tr = c_va = c_te = cs_tr = cs_va = cs_te = None

        # raw tensors for eval callbacks (physical units)
        self.tensor_train, self.mask_train = x_tr.copy(), m_tr
        self.tensor_val, self.mask_val = x_va.copy(), m_va
        self.tensor_test, self.mask_test = x_te.copy(), m_te
        self.tensor_train_sr, self.mask_train_sr = xs_tr.copy(), ms_tr
        self.tensor_val_sr, self.mask_val_sr = xs_va.copy(), ms_va
        self.tensor_test_sr, self.mask_test_sr = xs_te.copy(), ms_te

        def transform(x, m):
            """log-pt + sigma-scaled z-score with train-split masked stats."""
            out = x.copy()
            if self.log_pt:
                with np.errstate(invalid="ignore", divide="ignore"):
                    logged = np.log(1.0 - out[..., 2])
                out[..., 2] = np.where(m[..., 0] > 0, np.nan_to_num(logged), 0.0)
            return out

        if self.normalize:
            pt_tr = transform(x_tr, m_tr)
            means, stds = masked_mean_std(pt_tr, m_tr)
            self.means, self.stds = means, stds

            def norm(x, m):
                z = transform(x, m)
                if self.pt_standardization:
                    out = z.copy()
                    out[..., :2] = normalize_tensor(z[..., :2], means[:2], stds[:2], 10)
                    out[..., 2] = normalize_tensor(z[..., 2:3], means[2:3], stds[2:3], 5)[..., 0]
                else:
                    out = normalize_tensor(z, means, stds, self.normalize_sigma)
                return (out * m).astype(np.float32)

            x_tr, x_va = norm(x_tr, m_tr), norm(x_va, m_va)
            xs_tr, xs_va = norm(xs_tr, ms_tr), norm(xs_va, ms_va)

            if cond is not None:
                self.cond_means = c_tr.mean(axis=0)
                stds_c = c_tr.std(axis=0, ddof=1)
                self.cond_stds = np.where(stds_c == 0, 1.0, stds_c)

                def cnorm(c):
                    return normalize_tensor(
                        c, self.cond_means, self.cond_stds, self.normalize_sigma
                    ).astype(np.float32)

                c_tr, c_va, c_te = cnorm(c_tr), cnorm(c_va), cnorm(c_te)
                cs_tr, cs_va, cs_te = cnorm(cs_tr), cnorm(cs_va), cnorm(cs_te)

        self.tensor_conditioning_train = c_tr
        self.tensor_conditioning_val = c_va
        self.tensor_conditioning_test = c_te
        self.tensor_conditioning_train_sr = cs_tr
        self.tensor_conditioning_val_sr = cs_va
        self.tensor_conditioning_test_sr = cs_te

        self.train = Split(x_tr.astype(np.float32), m_tr, c_tr)
        self.val = Split(x_va.astype(np.float32), m_va, c_va)
        self.test = Split(x_te.astype(np.float32), m_te, c_te)


@dataclass
class LHCOWholeEventDataModule(ArrayDataModule):
    """Whole LHCO events as single point clouds conditioned on mjj.

    Loads the raw `events_anomalydetection_v2.h5` record (background rows,
    700 hadrons, truncated to `num_particles`), computes mjj from the
    clustered dijet file to cut the sideband / signal-region windows, and
    normalizes with masked train-split statistics. SR twins are exposed as
    `*_sr` tensors like LHCODataModule.
    """

    data_dir: str = "data/"
    val_fraction: float = 0.05
    test_fraction: float = 0.35
    num_particles: int = 560
    variable_jet_sizes: bool = True
    normalize: bool = True
    normalize_sigma: float = 5
    seed: int = 0
    synthetic: bool = False
    synthetic_num_events: int = 4000

    tensor_train_sr: Optional[np.ndarray] = None
    mask_train_sr: Optional[np.ndarray] = None
    tensor_val_sr: Optional[np.ndarray] = None
    mask_val_sr: Optional[np.ndarray] = None
    tensor_test_sr: Optional[np.ndarray] = None
    mask_test_sr: Optional[np.ndarray] = None
    tensor_conditioning_train_sr: Optional[np.ndarray] = None
    tensor_conditioning_val_sr: Optional[np.ndarray] = None
    tensor_conditioning_test_sr: Optional[np.ndarray] = None

    def _load(self):
        """Returns (particle_data (B, N, [pt,eta,phi]), mask (B, N, 1), mjj (B,))."""
        if self.synthetic:
            jets, consts, mask = synthetic_lhco(
                self.synthetic_num_events, max(self.num_particles // 2, 8), seed=self.seed
            )
            # merge the two jets' constituents into one event cloud
            pd_ = consts.reshape(consts.shape[0], -1, consts.shape[-1])
            mk = mask.reshape(mask.shape[0], -1, mask.shape[-1])
            mjj = get_mjj(jets[:, 0], jets[:, 1])
            return pd_, mk, mjj

        import pandas as pandas_mod

        raw_path = os.path.join(self.data_dir, "lhco", "events_anomalydetection_v2.h5")
        df = np.asarray(pandas_mod.read_hdf(raw_path))
        background = df[df[:, 2100] == 0]
        particle_data = background[:, :2100].reshape(-1, 700, 3)[:, : self.num_particles, :]
        mask = np.expand_dims((particle_data[..., 0] > 0).astype(np.float32), axis=-1)

        import h5py

        jet_path = os.path.join(
            self.data_dir, "lhco", "final_data", "processed_data_background_rel.h5"
        )
        with h5py.File(jet_path, "r") as f:
            jet_data = np.asarray(f["jet_data"])
        mjj = get_mjj(jet_data[:, 0], jet_data[:, 1])
        if len(mjj) != len(particle_data):
            raise ValueError(
                f"mjj from {jet_path} has {len(mjj)} events but the raw file "
                f"has {len(particle_data)} background events — the processed "
                "dijet file must cover the same events in the same order"
            )
        return particle_data, mask, mjj

    def setup(self) -> None:
        if self.train is not None:
            return
        particle_data, mask, mjj = self._load()

        keep = ((mjj < 3300) & (mjj > 2300)) | ((mjj > 3700) & (mjj < 5000))
        keep_sr = (mjj > 3300) & (mjj < 3700)
        pd_, mk = particle_data[keep], mask[keep]
        pd_sr, mk_sr = particle_data[keep_sr], mask[keep_sr]
        cond = mjj[keep].reshape(-1, 1).astype(np.float32)
        cond_sr = mjj[keep_sr].reshape(-1, 1).astype(np.float32)

        # reorder (pt, eta, phi) -> (eta, phi, pt) to match JetNet conventions
        def prep(pd_, mk):
            return np.concatenate([pd_[:, :, [1, 2, 0]], mk], axis=-1)

        # cond rides through mask_data so the fixed-size filter
        # (variable_jet_sizes=False) keeps events and mjj aligned
        x, m, _, cond = mask_data(
            prep(pd_, mk), cond, self.num_particles, self.variable_jet_sizes
        )
        x_sr, m_sr, _, cond_sr = mask_data(
            prep(pd_sr, mk_sr), cond_sr, self.num_particles, self.variable_jet_sizes
        )

        x_tr, x_va, x_te = _split3(x, self.val_fraction, self.test_fraction)
        m_tr, m_va, m_te = _split3(m, self.val_fraction, self.test_fraction)
        xs_tr, xs_va, xs_te = _split3(x_sr, self.val_fraction, self.test_fraction)
        ms_tr, ms_va, ms_te = _split3(m_sr, self.val_fraction, self.test_fraction)
        c_tr, c_va, c_te = _split3(cond, self.val_fraction, self.test_fraction)
        cs_tr, cs_va, cs_te = _split3(cond_sr, self.val_fraction, self.test_fraction)

        # raw tensors for eval callbacks (physical units)
        self.tensor_train, self.mask_train = x_tr.copy(), m_tr
        self.tensor_val, self.mask_val = x_va.copy(), m_va
        self.tensor_test, self.mask_test = x_te.copy(), m_te
        self.tensor_train_sr, self.mask_train_sr = xs_tr.copy(), ms_tr
        self.tensor_val_sr, self.mask_val_sr = xs_va.copy(), ms_va
        self.tensor_test_sr, self.mask_test_sr = xs_te.copy(), ms_te

        if self.normalize:
            means, stds = masked_mean_std(x_tr, m_tr)
            self.means, self.stds = means, stds

            def norm(x, m):
                z = normalize_tensor(x, means, stds, self.normalize_sigma)
                return (z * m).astype(np.float32)

            x_tr, x_va = norm(x_tr, m_tr), norm(x_va, m_va)
            xs_tr, xs_va = norm(xs_tr, ms_tr), norm(xs_va, ms_va)

            self.cond_means = c_tr.mean(axis=0)
            stds_c = c_tr.std(axis=0, ddof=1)
            self.cond_stds = np.where(stds_c == 0, 1.0, stds_c)

            def cnorm(c):
                return normalize_tensor(
                    c, self.cond_means, self.cond_stds, self.normalize_sigma
                ).astype(np.float32)

            c_tr, c_va, c_te = cnorm(c_tr), cnorm(c_va), cnorm(c_te)
            cs_tr, cs_va, cs_te = cnorm(cs_tr), cnorm(cs_va), cnorm(cs_te)

        self.tensor_conditioning_train = c_tr
        self.tensor_conditioning_val = c_va
        self.tensor_conditioning_test = c_te
        self.tensor_conditioning_train_sr = cs_tr
        self.tensor_conditioning_val_sr = cs_va
        self.tensor_conditioning_test_sr = cs_te

        self.train = Split(x_tr.astype(np.float32), m_tr, c_tr)
        self.val = Split(x_va.astype(np.float32), m_va, c_va)
        self.test = Split(x_te.astype(np.float32), m_te, c_te)


@dataclass
class LHCOJetFeatureDataModule(ArrayDataModule):
    """Flat dijet jet-feature vectors for stage 1 of the LHCO pipeline."""

    data_dir: str = "data/"
    val_fraction: float = 0.15
    test_fraction: float = 0.15
    normalize: bool = True
    normalize_sigma: float = 5
    set_data: bool = False
    seed: int = 0
    synthetic: bool = False
    synthetic_num_events: int = 4000
    # cap on the synthetic per-jet multiplicity; it must match the
    # constituent stage's num_particles (LHCODataModule's 279), since stage
    # 1's multiplicity feature drives the stage-2 generation masks
    synthetic_num_particles: int = 279

    tensor_train_sr: Optional[np.ndarray] = None
    tensor_val_sr: Optional[np.ndarray] = None
    tensor_test_sr: Optional[np.ndarray] = None
    tensor_conditioning_train_sr: Optional[np.ndarray] = None
    tensor_conditioning_val_sr: Optional[np.ndarray] = None
    tensor_conditioning_test_sr: Optional[np.ndarray] = None

    def _load(self):
        if self.synthetic:
            jets, _, mask = synthetic_lhco(
                self.synthetic_num_events,
                max(self.synthetic_num_particles, 8),
                seed=self.seed,
            )
            return jets, mask
        import h5py

        path = os.path.join(
            self.data_dir, "lhco", "final_data", "processed_data_background_rel.h5"
        )
        with h5py.File(path, "r") as f:
            return np.asarray(f["jet_data"]), np.asarray(f["mask"])

    def setup(self) -> None:
        if self.train is not None:
            return
        jet_data, mask = self._load()
        n_particles = np.sum(mask, axis=-2)
        mjj = get_mjj(jet_data[:, 0], jet_data[:, 1])

        keep = ((mjj < 3300) & (mjj > 2300)) | ((mjj > 3700) & (mjj < 5000))
        keep_sr = (mjj > 3300) & (mjj < 3700)
        cond = mjj[keep].reshape(-1, 1).astype(np.float32)
        cond_sr = mjj[keep_sr].reshape(-1, 1).astype(np.float32)

        jn = np.concatenate([jet_data, n_particles], axis=-1)
        data = jn[keep]
        data_sr = jn[keep_sr]
        if not self.set_data:
            data = data.reshape(len(data), -1)
            data_sr = data_sr.reshape(len(data_sr), -1)

        d_tr, d_va, d_te = _split3(data, self.val_fraction, self.test_fraction)
        s_tr, s_va, s_te = _split3(data_sr, self.val_fraction, self.test_fraction)
        c_tr, c_va, c_te = _split3(cond, self.val_fraction, self.test_fraction)
        cs_tr, cs_va, cs_te = _split3(cond_sr, self.val_fraction, self.test_fraction)

        self.tensor_train, self.tensor_val, self.tensor_test = (
            d_tr.copy(), d_va.copy(), d_te.copy(),
        )
        self.tensor_train_sr, self.tensor_val_sr, self.tensor_test_sr = (
            s_tr.copy(), s_va.copy(), s_te.copy(),
        )

        if self.normalize:
            axis = (0, 1) if self.set_data else 0
            means = d_tr.mean(axis=axis)
            stds = d_tr.std(axis=axis)
            self.means, self.stds = means, np.where(stds == 0, 1.0, stds)
            self.cond_means = c_tr.mean(axis=0)
            stds_c = c_tr.std(axis=0, ddof=1)
            self.cond_stds = np.where(stds_c == 0, 1.0, stds_c)

            def norm(d):
                return normalize_tensor(d, self.means, self.stds, self.normalize_sigma).astype(
                    np.float32
                )

            def cnorm(c):
                return normalize_tensor(
                    c, self.cond_means, self.cond_stds, self.normalize_sigma
                ).astype(np.float32)

            d_tr, d_va = norm(d_tr), norm(d_va)
            s_tr, s_va = norm(s_tr), norm(s_va)
            c_tr, c_va, c_te = cnorm(c_tr), cnorm(c_va), cnorm(c_te)
            cs_tr, cs_va, cs_te = cnorm(cs_tr), cnorm(cs_va), cnorm(cs_te)

        self.tensor_conditioning_train = c_tr
        self.tensor_conditioning_val = c_va
        self.tensor_conditioning_test = c_te
        self.tensor_conditioning_train_sr = cs_tr
        self.tensor_conditioning_val_sr = cs_va
        self.tensor_conditioning_test_sr = cs_te

        self.train = Split(d_tr.astype(np.float32), None, c_tr)
        self.val = Split(d_va.astype(np.float32), None, c_va)
        self.test = Split(d_te.astype(np.float32), None, c_te)
        self.variable_jet_sizes = False

    def _batches(self, split, rng, drop_last):
        """Flat data: mask is None per batch."""
        n = len(split)
        idx = np.arange(n)
        if rng is not None:
            rng.shuffle(idx)
        stop = n - (n % self.batch_size) if drop_last else n
        if stop == 0 and n > 0:
            stop = n  # split smaller than batch_size: one short batch (see base)
        for s in range(0, stop, self.batch_size):
            sel = idx[s : s + self.batch_size]
            cond = split.cond[sel] if split.cond is not None else None
            yield split.x[sel], None, cond
