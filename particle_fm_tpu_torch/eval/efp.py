"""Energy-flow polynomials (EFPs) on the device; counterpart of
particle_fm_tpu/eval/efp.py.

    EFP_G = sum_{i1..in} z_{i1} ... z_{in} * prod_{(a,b) in edges(G)} theta_{ia ib}

with the hadronic measure z_i = pT_i / sum_j pT_j over the real particles
and theta_ij = (dEta_ij^2 + dPhi_ij^2)^{beta/2}, dPhi NOT wrapped into
(-pi, pi], as the JAX package computes it (the energy correlators of
eval/substructure.py wrap it; each keeps its own convention). The graphs are
all connected multigraphs with n vertices and d edges (`enumerate_multigraphs`,
copied): 5 at n = d = 4.

The JAX package lets opt_einsum plan each graph's contraction under a memory
cap. The port has no opt_einsum, and `torch.einsum` alone contracts left to
right, which for a 4-cycle builds (B, N, N, N) intermediates (135 GB at
B = 10,000, N = 150). So each graph is contracted by variable elimination in a
fixed order: the vertex with the fewest neighbours first (ties by index);
eliminating a vertex with two neighbours is one `bmm` of two (B, N, N)
factors, with one neighbour a batched matrix-vector product, with none a
sum. No intermediate is larger than (B, N, N), and the jets run in chunks,
float32, on `device` (CUDA unless the caller asks for the CPU).
"""

from __future__ import annotations

import itertools
from functools import lru_cache, reduce

import numpy as np
import torch

from particle_fm_tpu_torch.utils.device import resolve_device

CHUNK = 1024  # jets per contraction: theta is 92 MB at N = 150


@lru_cache(maxsize=None)
def enumerate_multigraphs(n: int, d: int) -> tuple[tuple[tuple[int, int], ...], ...]:
    """All connected multigraphs with exactly n vertices and d edges, up to
    isomorphism, every vertex touched by >= 1 edge. Returned as sorted edge
    tuples."""
    pairs = list(itertools.combinations(range(n), 2))
    seen = set()
    result = []
    for combo in itertools.combinations_with_replacement(pairs, d):
        verts = set()
        for a, b in combo:
            verts.add(a)
            verts.add(b)
        if len(verts) != n:
            continue
        # connectivity via union-find
        parent = list(range(n))

        def find(v):
            while parent[v] != v:
                parent[v] = parent[parent[v]]
                v = parent[v]
            return v

        for a, b in combo:
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb
        if len({find(v) for v in range(n)}) != 1:
            continue
        # canonical form over all vertex permutations
        canon = min(
            tuple(sorted(tuple(sorted((p[a], p[b]))) for a, b in combo))
            for p in itertools.permutations(range(n))
        )
        if canon not in seen:
            seen.add(canon)
            result.append(canon)
    return tuple(result)


def _product(tensors):
    return reduce(torch.mul, tensors)


def contract_graph(edges: tuple[tuple[int, int], ...], n: int, z: torch.Tensor,
                   theta: torch.Tensor) -> torch.Tensor:
    """One graph's EFP of a chunk, (B,), from z (B, N) and the symmetric
    theta (B, N, N), by variable elimination (module docstring). A pair
    factor is kept under its sorted vertex pair (a, b), indexed [a, b]."""
    pairs: dict[tuple[int, int], torch.Tensor] = {}
    for edge in edges:
        pairs[edge] = pairs[edge] * theta if edge in pairs else theta
    unary = {v: [z] for v in range(n)}
    scalars = []

    def oriented(edge, factor, first):
        """The factor indexed [first, other]."""
        return factor if edge[0] == first else factor.transpose(1, 2)

    def neighbours(v):
        return {u for e in pairs if v in e for u in e if u != v}

    while unary:
        v = min(unary, key=lambda u: (len(neighbours(u)), u))
        w = _product(unary.pop(v))
        touching = {e: pairs.pop(e) for e in [e for e in pairs if v in e]}
        others = sorted({u for e in touching for u in e if u != v})
        if not others:
            scalars.append(w.sum(dim=1))
        elif len(others) == 1:
            m = _product([oriented(e, f, v) for e, f in touching.items()])  # [v, u]
            unary[others[0]].append(torch.bmm(w.unsqueeze(1), m).squeeze(1))
        elif len(others) == 2:
            a, b = others
            left = _product([oriented(e, f, a) for e, f in touching.items() if a in e])
            right = _product([oriented(e, f, v) for e, f in touching.items() if b in e])
            new = torch.bmm(left * w.unsqueeze(1), right)  # [a, b]
            pairs[(a, b)] = pairs[(a, b)] * new if (a, b) in pairs else new
        else:
            raise ValueError(f"graph {edges} needs an intermediate larger than (B, N, N)")
    return _product(scalars)


def efps(jets: np.ndarray, n: int = 4, d: int = 4, beta: float = 1.0,
         device: str | torch.device = "cuda") -> np.ndarray:
    """EFPs for a batch of particle clouds on `device`.

    jets: (B, N, >=3) with features (etarel, phirel, ptrel); zero rows are
    padding: they contribute z=0 and drop out exactly. Returns (B, n_graphs)
    float32."""
    dev = resolve_device(device)
    jets = np.asarray(jets, np.float64).astype(np.float32)
    graphs = enumerate_multigraphs(n, d)
    out = np.zeros((len(jets), len(graphs)), np.float32)
    for lo in range(0, len(jets), CHUNK):
        x = torch.from_numpy(jets[lo:lo + CHUNK, :, :3]).to(dev)
        eta, phi, pt = x.unbind(-1)
        mask = (eta.abs() + phi.abs() + pt.abs() != 0).to(torch.float32)
        z = pt * mask
        z = z / torch.clamp(z.sum(dim=1, keepdim=True), min=1e-30)
        theta2 = (eta[:, :, None] - eta[:, None, :]) ** 2 + (phi[:, :, None] - phi[:, None, :]) ** 2
        theta = theta2 ** (beta / 2.0) if beta != 2.0 else theta2
        vals = torch.stack([contract_graph(g, n, z, theta) for g in graphs], dim=-1)
        out[lo:lo + CHUNK] = vals.cpu().numpy()
    return out
