"""Jet substructure observables: N-subjettiness, energy correlators, D2;
counterpart of particle_fm_tpu/eval/substructure.py.

The clustering runs in the port's C++ clusterer (native/binding.py):
exclusive-kt WTA axes for tau_N, each tau_N from its own exclusive-kt-to-N
clustering, and the kt splitting scales. The energy-correlator sums run with
torch on `device` (CUDA unless the caller asks for the CPU), float32, in
chunks of jets.

Conventions (matching the reference's fastjet config):
  tau_N = sum_i pt_i * min_k(dR(i, axis_k)) / (R0 * sum_i pt_i),
  axes from exclusive kt (WTA scheme), R0 = 0.8 default;
  e2 = sum_{i<j} z_i z_j theta_ij^beta, e3 analogous (beta = 1), with dPhi
  wrapped into [-pi, pi) (the EFPs of eval/efp.py do not wrap it),
  D2 = e3 / e2^3.
"""

from __future__ import annotations

import numpy as np
import torch

from particle_fm_tpu_torch.data.utils import get_jet_data
from particle_fm_tpu_torch.native.binding import exclusive_kt_axes, kt_split_scales
from particle_fm_tpu_torch.utils.device import resolve_device

CHUNK = 1024  # jets per correlator pass: three (B, N, N) float32 tensors


def ecfs(pt: np.ndarray, eta: np.ndarray, phi: np.ndarray, mask: np.ndarray,
         beta: float = 1.0, device: str | torch.device = "cuda") -> tuple[np.ndarray, np.ndarray]:
    """e2, e3 (float64 arrays of (B,)) of padded clouds (B, N), in float32 on
    `device`. e3 takes the pairwise path of the JAX package: D = theta^T
    diag(z) theta (D_jk = sum_i z_i theta_ij theta_ik) is one batched matmul,
    so no intermediate is larger than (B, N, N)."""
    dev = resolve_device(device)
    e2 = np.zeros(len(pt), np.float64)
    e3 = np.zeros(len(pt), np.float64)
    for lo in range(0, len(pt), CHUNK):
        p_, h_, f_, m_ = (torch.as_tensor(np.asarray(a[lo:lo + CHUNK], np.float32), device=dev)
                          for a in (pt, eta, phi, mask))
        z = p_ * m_
        z = z / torch.clamp(z.sum(dim=1, keepdim=True), min=1e-30)
        deta = h_[:, :, None] - h_[:, None, :]
        dphi = torch.remainder(f_[:, :, None] - f_[:, None, :] + torch.pi, 2 * torch.pi) - torch.pi
        theta = torch.sqrt(deta**2 + dphi**2)
        if beta != 1.0:
            theta = theta**beta
        zz = z[:, :, None] * z[:, None, :]
        e2[lo:lo + CHUNK] = (0.5 * (theta * zz).sum(dim=(1, 2))).cpu().numpy()
        d_jk = torch.bmm(theta.transpose(1, 2) * z[:, None, :], theta)
        e3[lo:lo + CHUNK] = ((1.0 / 6.0) * (d_jk * theta * zz).sum(dim=(1, 2))).cpu().numpy()
    return e2, e3


def _tau(pt, eta, phi, mask, axes, n_found, n_axes, R0):
    """tau_N from WTA axes (host numpy; O(B*N*n_axes))."""
    d_eta = eta[:, :, None] - axes[:, None, :, 0]
    d_phi = phi[:, :, None] - axes[:, None, :, 1]
    d_phi = np.mod(d_phi + np.pi, 2 * np.pi) - np.pi
    dr = np.sqrt(d_eta**2 + d_phi**2)
    # mask out axes beyond n_found
    ax_ok = np.arange(axes.shape[1])[None, :] < n_found[:, None]
    dr = np.where(ax_ok[:, None, :], dr, np.inf)
    min_dr = dr[:, :, :n_axes].min(axis=-1)
    w = pt * mask
    denom = R0 * np.maximum(w.sum(axis=1), 1e-30)
    tau = (w * np.where(np.isfinite(min_dr), min_dr, 0.0)).sum(axis=1) / denom
    return tau


def nsubjettiness(pt, eta, phi, mask, R0: float = 0.8) -> tuple[np.ndarray, ...]:
    """tau1, tau2, tau3 on the host, each from its OWN exclusive-kt-to-N
    clustering (reference rclst.exclusive_jets(N), jet_substructure.py:248-258):
    the exclusive-2 axes are generally not a subset of the exclusive-3 axes."""
    taus = []
    for n_axes in (1, 2, 3):
        axes, found = exclusive_kt_axes(pt, eta, phi, R=R0, n_axes=n_axes)
        taus.append(_tau(pt, eta, phi, mask, axes, found, n_axes, R0))
    return tuple(taus)


def compute_substructure(
    particles: np.ndarray,
    mask: np.ndarray | None = None,
    R0: float = 0.8,
    beta: float = 1.0,
    device: str | torch.device = "cuda",
) -> dict:
    """Substructure for (B, N, [eta, phi, pt]) clouds (relative coords fine).

    Returns dict with jet kinematics (pt, mass), tau1/2/3, tau21, tau32,
    e2, e3, d2, d12, d23. Padded entries must have pt == 0 (or pass mask)."""
    particles = np.asarray(particles, np.float64)
    eta, phi, pt = particles[..., 0], particles[..., 1], particles[..., 2]
    if mask is None:
        mask = (pt > 0).astype(np.float64)
    else:
        mask = np.asarray(mask, np.float64)
        if mask.ndim == 3:
            mask = mask[..., 0]
    pt = pt * mask

    # jet kinematics from the p4 sum — consts as (pt, y, phi)
    jets = get_jet_data(np.stack([pt, eta, phi], axis=-1))
    tau1, tau2, tau3 = nsubjettiness(pt, eta, phi, mask, R0)
    e2, e3 = ecfs(pt, eta, phi, mask, beta=beta, device=device)
    with np.errstate(divide="ignore", invalid="ignore"):
        d2 = np.where(e2 > 0, e3 / np.maximum(e2, 1e-30) ** 3, 0.0)
        tau21 = np.where(tau1 > 0, tau2 / np.maximum(tau1, 1e-30), 0.0)
        tau32 = np.where(tau2 > 0, tau3 / np.maximum(tau2, 1e-30), 0.0)

    # kt splitting scales d12/d23 (reference jet_substructure.py:86-181)
    splits = kt_split_scales(pt, eta, phi, R=R0, n_scales=2)

    return {
        "jet_pt": jets[:, 0],
        "jet_mass": jets[:, 3],
        "tau1": tau1,
        "tau2": tau2,
        "tau3": tau3,
        "tau21": tau21,
        "tau32": tau32,
        "e2": e2,
        "e3": e3,
        "d2": d2,
        "d12": splits[:, 0],
        "d23": splits[:, 1],
    }


def dump_hlvs(particles: np.ndarray, path: str, mask: np.ndarray | None = None,
              R0: float = 0.8, device: str | torch.device = "cuda") -> dict:
    """Compute high-level variables and write them to an h5 file.

    Parity: utils/jet_substructure.py:400-557 (dump_hlvs -> h5)."""
    import h5py

    hlvs = compute_substructure(particles, mask=mask, R0=R0, device=device)
    with h5py.File(path, "w") as f:
        for k, v in hlvs.items():
            f.create_dataset(k, data=v)
    return hlvs
