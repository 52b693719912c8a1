"""Synthetic JetNet-like jets; `synthetic_jetnet` of
particle_fm_tpu/data/synthetic.py, array for array.

It gives (particle_features (B, N, [etarel, phirel, ptrel, mask]),
jet_features (B, [type, pt, eta, mass, num_particles])) with plausible
correlations (pt-ordered constituents, the mass label realised from the
constituents), not physics-accurate distributions, for training without
downloaded files.
"""

from __future__ import annotations

import numpy as np

JET_TYPES = {"g": 0, "q": 1, "t": 2, "w": 3, "z": 4}


def synthetic_jetnet(
    jet_types: list[str],
    num_jets: int = 10000,
    num_particles: int = 30,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Generate a JetNet-like dataset for the given jet types."""
    rs = np.random.RandomState(seed)
    per_type = num_jets // len(jet_types)
    parts, jets = [], []
    for jt in jet_types:
        label = JET_TYPES[jt]
        n = per_type
        # multiplicity: most jets near full, a tail of sparse ones; a real
        # JetNet file is truncated at num_particles so a sizable fraction sits
        # exactly at the cap — mirror that so fixed-size mode
        # (variable_jet_sizes=False, which keeps only full jets) has data
        mult = np.clip(
            (num_particles * rs.beta(5.0 if jt in "twz" else 3.0, 1.5, size=n)).astype(int),
            3,
            num_particles,
        )
        mult = np.where(rs.rand(n) < 0.3, num_particles, mult)
        ar = np.arange(num_particles)[None, :]
        mask = (ar < mult[:, None]).astype(np.float32)

        # pt_rel: pt-ordered, exponential falloff, normalized to sum <= 1
        raw = rs.exponential(1.0, size=(n, num_particles)) * mask
        raw = -np.sort(-raw, axis=1)
        ptrel = raw / np.maximum(raw.sum(axis=1, keepdims=True), 1e-9)

        # angular spread: heavier jets have wider, two-prong-ish structure
        width = 0.25 if jt in "twz" else 0.12
        etarel = rs.normal(0, width, size=(n, num_particles)).astype(np.float32)
        phirel = rs.normal(0, width, size=(n, num_particles)).astype(np.float32)
        if jt in "twz":  # crude prong structure
            prong = rs.choice([-1, 1], size=(n, num_particles))
            etarel += 0.2 * prong
            phirel += 0.1 * prong

        etarel *= mask
        phirel *= mask
        ptrel = (ptrel * mask).astype(np.float32)
        particle = np.stack([etarel, phirel, ptrel, mask], axis=-1)

        jet_pt = rs.uniform(800, 1600, size=n).astype(np.float32)
        jet_eta = rs.normal(0, 1.5, size=n).astype(np.float32)
        # The mass label is the REALIZED constituent-level mass (relative
        # invariant mass of the cloud x jet pt), not an independent draw —
        # otherwise (pt, mass)-conditioned training has nothing to learn and
        # conditional-fidelity metrics (scripts/guidance_sweep.py) are
        # meaningless. Matches real JetNet, where jet features are computed
        # from the constituents.
        px = (ptrel * np.cos(phirel)).sum(axis=1)
        py = (ptrel * np.sin(phirel)).sum(axis=1)
        pz = (ptrel * np.sinh(etarel)).sum(axis=1)
        e = (ptrel * np.cosh(etarel)).sum(axis=1)
        m_rel = np.sqrt(np.maximum(e**2 - px**2 - py**2 - pz**2, 0.0))
        jet_mass = (m_rel * jet_pt).astype(np.float32)
        jet = np.stack(
            [
                np.full(n, label, np.float32),
                jet_pt,
                jet_eta,
                jet_mass,
                mult.astype(np.float32),
            ],
            axis=-1,
        )
        parts.append(particle)
        jets.append(jet)

    particle_data = np.concatenate(parts, axis=0)
    jet_data = np.concatenate(jets, axis=0)
    perm = rs.permutation(len(particle_data))
    return particle_data[perm], jet_data[perm]
