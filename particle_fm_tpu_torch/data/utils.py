"""Data preprocessing and jet kinematics (host-side numpy); the functions of
particle_fm_tpu/data/utils.py that data/jetnet.py, the metrics, the
substructure, the plots and the LHCO chain use, with the p4 helpers they
rest on.
"""

from __future__ import annotations

import numpy as np


def p4s_from_ptyphims(ptyphim: np.ndarray) -> np.ndarray:
    """(..., [pt, y, phi, (m)]) -> (..., [E, px, py, pz]).

    Rapidity convention (energyflow-compatible): E = Et*cosh(y), pz = Et*sinh(y)
    with Et = sqrt(pt^2 + m^2); massless if no 4th component.
    """
    pt = ptyphim[..., 0]
    y = ptyphim[..., 1]
    phi = ptyphim[..., 2]
    m = ptyphim[..., 3] if ptyphim.shape[-1] > 3 else np.zeros_like(pt)
    et = np.sqrt(pt**2 + m**2)
    return np.stack(
        [et * np.cosh(y), pt * np.cos(phi), pt * np.sin(phi), et * np.sinh(y)], axis=-1
    )


def m2s_from_p4s(p4s: np.ndarray) -> np.ndarray:
    return p4s[..., 0] ** 2 - p4s[..., 1] ** 2 - p4s[..., 2] ** 2 - p4s[..., 3] ** 2


def ms_from_p4s(p4s: np.ndarray) -> np.ndarray:
    m2 = m2s_from_p4s(p4s)
    return np.sign(m2) * np.sqrt(np.abs(m2))


def pts_from_p4s(p4s: np.ndarray) -> np.ndarray:
    return np.sqrt(p4s[..., 1] ** 2 + p4s[..., 2] ** 2)


def ys_from_p4s(p4s: np.ndarray) -> np.ndarray:
    """Rapidity y = 0.5*ln((E+pz)/(E-pz))."""
    e, pz = p4s[..., 0], p4s[..., 3]
    return 0.5 * np.log(np.maximum(e + pz, 1e-30) / np.maximum(e - pz, 1e-30))


def etas_from_p4s(p4s: np.ndarray) -> np.ndarray:
    """Pseudorapidity from the 3-momentum."""
    px, py, pz = p4s[..., 1], p4s[..., 2], p4s[..., 3]
    p = np.sqrt(px**2 + py**2 + pz**2)
    return 0.5 * np.log(np.maximum(p + pz, 1e-30) / np.maximum(p - pz, 1e-30))


def phis_from_p4s(p4s: np.ndarray, phi_ref: float = 0.0) -> np.ndarray:
    """Azimuth in (phi_ref - pi, phi_ref + pi]."""
    phi = np.arctan2(p4s[..., 2], p4s[..., 1])
    return phi - 2 * np.pi * np.round((phi - phi_ref) / (2 * np.pi))


def ptyphims_from_p4s(p4s: np.ndarray, phi_ref: float = 0.0) -> np.ndarray:
    """(..., [E,px,py,pz]) -> (..., [pt, y, phi, m])."""
    return np.stack(
        [
            pts_from_p4s(p4s),
            ys_from_p4s(p4s),
            phis_from_p4s(p4s, phi_ref),
            ms_from_p4s(p4s),
        ],
        axis=-1,
    )


def one_hot_encode(
    x: np.ndarray, categories: list | None = None, num_other_features: int = 4
) -> np.ndarray:
    """One-hot encode the type in column 0, keep the remaining features.

    Parity: data/components/utils.py:8-26 (the encoded value is positional in
    `categories`, not the value itself)."""
    cats = np.asarray(categories if categories is not None else np.unique(x[..., 0]))
    type_col = x[..., 0].reshape(-1)
    onehot = (type_col[:, None] == cats[None, :]).astype(x.dtype)
    other = x[..., 1:].reshape(-1, num_other_features)
    return np.concatenate([onehot, other], axis=-1).reshape(*x.shape[:-1], -1)


def jet_etas(jets_ary: np.ndarray) -> np.ndarray:
    """Per-jet pseudorapidity of the summed constituent p4s. Input (B,N,[pt,y,phi])."""
    return etas_from_p4s(p4s_from_ptyphims(jets_ary).sum(axis=1))


def jet_phis(jets_ary: np.ndarray) -> np.ndarray:
    return phis_from_p4s(p4s_from_ptyphims(jets_ary).sum(axis=1), phi_ref=0)


def center_jets(data: np.ndarray) -> np.ndarray:
    """Shift constituent (eta, phi) so the jet axis sits at the origin.

    data: (B, N, [eta, phi, pt]) -> same layout, centered. Only particles with
    pt > 0 are shifted (padding untouched). Parity: utils.py:32-50."""
    data = np.array(data[:, :, [2, 0, 1]])  # -> (pt, eta, phi)
    etas = jet_etas(data)[:, None]
    phis = jet_phis(data)[:, None]
    mask = data[..., 0] > 0
    data[..., 1] -= np.where(mask, etas, 0.0)
    data[..., 2] -= np.where(mask, phis, 0.0)
    return data[:, :, [1, 2, 0]]


def mask_data(
    particle_data: np.ndarray,
    jet_data: np.ndarray,
    num_particles: int,
    variable_jet_sizes: bool = True,
):
    """Split (B, N, feats+mask) into (x, mask); optionally keep only jets with
    exactly `num_particles` constituents (fixed-size mode). Parity: utils.py:108-158."""
    if not variable_jet_sizes:
        keep = particle_data[:, :, 3].sum(axis=1) == num_particles
        particle_data = particle_data[keep]
        if jet_data is not None:
            jet_data = jet_data[keep]
    else:
        particle_data = particle_data[:, :num_particles, :]
    x = particle_data[:, :, :3].astype(np.float32)
    mask = particle_data[:, :, 3:].astype(np.float32)
    mask = (mask > 0).astype(np.float32)
    return x, mask, particle_data, jet_data


def masked_mean_std(x: np.ndarray, mask: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-feature mean/std over real particles only (ddof=0, like np.ma)."""
    w = mask.reshape(-1, 1)
    flat = x.reshape(-1, x.shape[-1])
    c = w.sum()
    mean = (flat * w).sum(axis=0) / c
    var = (np.square(flat - mean) * w).sum(axis=0) / c
    return mean, np.sqrt(var)


def normalize_tensor(x: np.ndarray, mean, std, sigma: float = 5) -> np.ndarray:
    """(x - mean) / (std / sigma), per feature. Parity: utils.py:164-180."""
    mean = np.asarray(mean)
    std = np.asarray(std)
    return (x - mean) / (std / sigma)


def inverse_normalize_tensor(x: np.ndarray, mean, std, sigma: float = 5) -> np.ndarray:
    mean = np.asarray(mean)
    std = np.asarray(std)
    return x * (std / sigma) + mean


def calculate_jet_features(particle_data: np.ndarray) -> np.ndarray:
    """(B, N, [eta, phi, pt, (mask)]) -> per-jet (pt, y, phi, m). Parity: utils.py:261-276."""
    pd = particle_data[..., [2, 0, 1]]
    sum_p4 = np.sum(p4s_from_ptyphims(pd), axis=-2)
    return ptyphims_from_p4s(sum_p4, phi_ref=0)


def get_mjj(jet_x: np.ndarray, jet_y: np.ndarray) -> np.ndarray:
    """Dijet invariant mass from two jets' (pt, y, phi[, m]). Parity: utils.py:279-292."""
    return ms_from_p4s(p4s_from_ptyphims(jet_x) + p4s_from_ptyphims(jet_y))


def get_jet_data(consts: np.ndarray) -> np.ndarray:
    """(.., N, [pt, y, phi]) constituents -> jet (pt, y, phi, m)."""
    sum_p4 = np.sum(p4s_from_ptyphims(consts[..., :3]), axis=-2)
    return ptyphims_from_p4s(sum_p4, phi_ref=0)


def get_nonrel_consts(jets: np.ndarray, particles: np.ndarray) -> np.ndarray:
    """Relative (ptrel, etarel, phirel) constituents of jets (B, [pt, eta,
    phi, ...]) -> absolute (pt, eta, phi), phi wrapped into [-pi, pi];
    particles with pt 0 keep eta and phi 0."""
    pt = jets[..., 0:1]
    eta = jets[..., 1:2]
    phi = jets[..., 2:3]
    mask = (particles[..., 0] > 0).astype(particles.dtype)[..., None]
    nr_eta = particles[..., 1:2] + eta[:, None, :]
    nr_phi = particles[..., 2:3] + phi[:, None, :]
    nr_phi = np.where(nr_phi > np.pi, nr_phi - 2 * np.pi, nr_phi)
    nr_phi = np.where(nr_phi < -np.pi, nr_phi + 2 * np.pi, nr_phi)
    nr_pt = particles[..., 0:1] * pt[:, None, :]
    return np.concatenate([nr_pt, nr_eta * mask, nr_phi * mask], axis=-1)


def get_pt_of_selected_particles(particle_data, selected_particles=(1, 3, 10)):
    """pT of the k-th hardest particle of each jet, for each k: (K, B)."""
    sorted_pt = np.sort(particle_data[:, :, 2])[:, ::-1]
    return np.array([sorted_pt[:, k - 1] for k in selected_particles])


def import_h5py():
    """h5py, or an ImportError that names it: reading and writing h5 files
    needs it, and the port has no other route to them."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("h5py is not installed: reading or writing h5 files needs it "
                          "(hand the datamodule in-memory arrays instead)") from e
    return h5py
