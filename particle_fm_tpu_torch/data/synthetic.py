"""Synthetic datasets for training without downloaded files; the
generators of particle_fm_tpu/data/synthetic.py, array for array (the same
numpy draws from the same seed).

- `synthetic_jetnet`: (particle_features (B, N, [etarel, phirel, ptrel,
  mask]), jet_features (B, [type, pt, eta, mass, num_particles])).
- `synthetic_lhco`: clustered dijets (jet_data, constituents, mask).
- `synthetic_calo`: CaloChallenge-like hit clouds (x, mask, incident energy).

Plausible correlations (pt-ordered constituents, mass labels realised from
the constituents, showers deepening with energy), not physics-accurate
distributions.
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


def synthetic_lhco(
    num_events: int = 5000, num_particles: int = 279, seed: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """LHCO-like clustered dijets: (jet_data (B, 2, [pt,eta,phi,m]),
    constituents (B, 2, N, [pt,eta,phi]), mask (B, 2, N, 1)).

    mjj spans the reference's sideband+signal windows (2300-5000 GeV)."""
    rs = np.random.RandomState(seed)
    n = num_events
    mjj = rs.uniform(2300, 5000, size=n)
    pt1 = mjj / 2 * rs.uniform(0.85, 1.0, size=n)
    pt2 = mjj / 2 * rs.uniform(0.7, 0.95, size=n)
    jets = np.zeros((n, 2, 4), np.float32)
    jets[:, 0] = np.stack([pt1, rs.normal(0, 1, n), rs.uniform(-np.pi, np.pi, n),
                           np.zeros(n)], axis=-1)
    jets[:, 1] = np.stack([pt2, rs.normal(0, 1, n), rs.uniform(-np.pi, np.pi, n),
                           np.zeros(n)], axis=-1)

    mult = np.clip(rs.poisson(60, size=(n, 2)), 3, num_particles)
    ar = np.arange(num_particles)[None, None, :]
    mask = (ar < mult[..., None]).astype(np.float32)[..., None]
    raw = rs.exponential(1.0, size=(n, 2, num_particles)) * mask[..., 0]
    raw = -np.sort(-raw, axis=-1)
    ptrel = raw / np.maximum(raw.sum(axis=-1, keepdims=True), 1e-9)
    pt = ptrel * jets[:, :, 0:1]
    eta = jets[:, :, 1:2] + rs.normal(0, 0.3, size=(n, 2, num_particles)) * mask[..., 0]
    phi = jets[:, :, 2:3] + rs.normal(0, 0.3, size=(n, 2, num_particles)) * mask[..., 0]
    consts = np.stack([pt, eta, phi], axis=-1).astype(np.float32) * mask
    # jet mass label = realized invariant mass of the (massless) constituents
    # — a label drawn independently of the cloud would make the stage-2
    # conditional model unlearnable (same rationale as synthetic_jetnet)
    px = (pt * np.cos(phi) * mask[..., 0]).sum(-1)
    py = (pt * np.sin(phi) * mask[..., 0]).sum(-1)
    pz = (pt * np.sinh(eta) * mask[..., 0]).sum(-1)
    e = (pt * np.cosh(eta) * mask[..., 0]).sum(-1)
    jets[:, :, 3] = np.sqrt(np.maximum(e**2 - px**2 - py**2 - pz**2, 0.0))
    return jets, consts, mask


def synthetic_calo(
    num_showers: int = 4000, max_hits: int = 200, seed: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CaloChallenge-like variable-length hit clouds: (x (B, N, [E,z,alpha,r]),
    mask (B, N, 1), cond (B, 1) incident energy in MeV).

    Matches the real datasets' value domains so the reference eval protocol
    (callbacks/calo_challenge/calo_challenge_eval.py's fixed histogram axes)
    is non-degenerate end to end:
      - E: MeV, log-uniform 1 GeV..1 TeV incident energy split exponentially
        over hits, so the energies populate the Regular(100, 0, 6500 MeV)
        axis and do not collapse into bin 0
      - z/alpha/r: INTEGER voxel indices (0..44 / 0..15 / 0..8) like the
        CaloChallenge voxelization; stored as float32
      - learnable structure: the z shower profile deepens with ln(E_inc);
        each shower has a random alpha center with hits concentrated around
        it (marginally uniform, so the distribution is alpha-symmetric and
        the alpha-rotation augmentation is meaningful); r falls
        exponentially from the shower axis
    """
    rs = np.random.RandomState(seed)
    e_inc = (10.0 ** rs.uniform(3.0, 6.0, size=(num_showers, 1))).astype(np.float32)
    mult = np.clip((max_hits * (e_inc[:, 0] / 1e6) ** 0.5).astype(int), 5, max_hits)
    ar = np.arange(max_hits)[None, :]
    mask = (ar < mult[:, None]).astype(np.float32)[..., None]
    e = rs.exponential(1.0, size=(num_showers, max_hits)).astype(np.float32)
    e = e / e.sum(axis=1, keepdims=True) * e_inc
    # depth profile: gamma-shaped, shifting deeper with incident energy
    depth_scale = 2.0 + 0.8 * (np.log10(e_inc) - 3.0)  # (B, 1) in [2, 4.4]
    z = np.floor(rs.gamma(3.0, 1.0, size=(num_showers, max_hits)) * depth_scale)
    z = np.clip(z, 0, 44).astype(np.float32)
    # per-shower alpha center + wrapped-normal spread (width ~1.5 bins)
    alpha0 = rs.randint(0, 16, size=(num_showers, 1))
    dalpha = np.rint(rs.normal(0.0, 1.5, size=(num_showers, max_hits)))
    alpha = np.mod(alpha0 + dalpha, 16).astype(np.float32)
    r = np.clip(np.floor(rs.exponential(2.0, size=(num_showers, max_hits))), 0, 8)
    x = np.stack([e, z, alpha, r.astype(np.float32)], axis=-1) * mask
    return x, mask, e_inc
