"""LHCO event-level utilities: anti-kt clustering of whole-event clouds into
their two leading jets; counterpart of particle_fm_tpu/eval/lhco_utils.py,
on the port's own clusterer (`native/binding.py::cluster_events`).
"""

from __future__ import annotations

import numpy as np

from particle_fm_tpu_torch.native.binding import cluster_events


def cluster_data(
    events: np.ndarray,
    num_particles: int = 279,
    R: float = 1.0,
    min_pt: float = 0.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cluster whole-event clouds into the two leading anti-kt jets.

    events: (B, N, [pt, eta, phi]) zero-padded.
    Returns (jet_data (B, 2, [pt, y, phi, m]),
             consts (B, 2, num_particles, [pt, eta, phi]) pt-sorted, padded,
             mask (B, 2, num_particles, 1)).
    """
    events = np.asarray(events, np.float64)
    pt, eta, phi = events[..., 0], events[..., 1], events[..., 2]
    jets, _, const_jet = cluster_events(pt, eta, phi, R=R, p=-1.0, min_pt=min_pt, max_jets=2)

    b = pt.shape[0]
    consts = np.zeros((b, 2, num_particles, 3), np.float64)
    mask = np.zeros((b, 2, num_particles, 1), np.float64)
    for e in range(b):
        for j in range(2):
            sel = np.where(const_jet[e] == j)[0]
            if len(sel) == 0:
                continue
            order = sel[np.argsort(-pt[e, sel])][:num_particles]
            k = len(order)
            consts[e, j, :k, 0] = pt[e, order]
            consts[e, j, :k, 1] = eta[e, order]
            consts[e, j, :k, 2] = phi[e, order]
            mask[e, j, :k, 0] = 1.0
    return jets[:, :2], consts, mask
