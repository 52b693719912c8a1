"""Minibatch optimal-transport pairing for OT-CFM; counterpart of
particle_fm_tpu/losses/ot.py.

Inside each set, noise particles are paired with data particles by a
permutation:

  - "sinkhorn" (default): log-domain Sinkhorn with uniform marginals on the
    device, hardened into a true permutation by `greedy_perm_from_plan`.
  - "exact": the Hungarian assignment, scipy's `linear_sum_assignment` per
    set on the host (the JAX package reaches the same function through
    `jax.pure_callback`).

The cost of a set is its squared distances divided by their maximum. Each
set uses its own permuted mask (see the JAX module's docstring for how this
departs from the reference).
"""

from __future__ import annotations

import numpy as np
import torch


def pairwise_sq_dists(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Batched squared euclidean cost: (B, N, F) x (B, M, F) -> (B, N, M)."""
    sq0 = torch.sum(x0**2, dim=-1)[..., :, None]
    sq1 = torch.sum(x1**2, dim=-1)[..., None, :]
    cross = torch.einsum("bnf,bmf->bnm", x0, x1)
    return torch.clamp_min(sq0 + sq1 - 2.0 * cross, 0.0)


def sinkhorn_plan(cost: torch.Tensor, reg: float = 0.01, n_iters: int = 50) -> torch.Tensor:
    """Log-domain Sinkhorn with uniform marginals: cost (B, N, M) -> plan (B, N, M)."""
    b, n, m = cost.shape
    # -log(n) rounded as JAX's float32 log of the integer rounds it
    log_a = torch.full((b, n), float(-np.log(np.float32(n))), dtype=cost.dtype, device=cost.device)
    log_b = torch.full((b, m), float(-np.log(np.float32(m))), dtype=cost.dtype, device=cost.device)
    log_k = -cost / reg
    f = torch.zeros((b, n), dtype=cost.dtype, device=cost.device)
    g = torch.zeros((b, m), dtype=cost.dtype, device=cost.device)
    for _ in range(n_iters):
        f = log_a - torch.logsumexp(log_k + g[:, None, :], dim=2)
        g = log_b - torch.logsumexp(log_k + f[:, :, None], dim=1)
    return torch.exp(log_k + f[:, :, None] + g[:, None, :])


def greedy_perm_from_plan(plan: torch.Tensor) -> torch.Tensor:
    """Harden a square (B, N, N) plan into a permutation (B, N) of int64.

    N rounds pick the largest entry left in each set and strike out its row
    and column. Ties go to the first index, as argmax's do in both packages.
    Where the per-row argmax is already a permutation, the rounds return it
    (the JAX package's `lax.cond` fast path gives the same result), so the
    rounds always run and no host read decides between the two."""
    b, n, m = plan.shape
    if n != m:
        raise ValueError(
            f"greedy_perm_from_plan needs a square plan (got N={n}, M={m}): "
            "a permutation between unequal-size sets does not exist"
        )
    p = plan.clone()
    rows = torch.arange(b, device=plan.device)
    out = torch.zeros((b, n), dtype=torch.int64, device=plan.device)
    for _ in range(n):
        flat = torch.argmax(p.reshape(b, n * m), dim=-1)
        i, j = flat // m, flat % m
        out[rows, i] = j
        p[rows, i, :] = -torch.inf
        p[rows, :, j] = -torch.inf
    return out


def _hungarian_host(cost: np.ndarray) -> np.ndarray:
    from scipy.optimize import linear_sum_assignment

    out = np.empty(cost.shape[:2], dtype=np.int64)
    for k in range(cost.shape[0]):
        _, col = linear_sum_assignment(cost[k])
        out[k] = col
    return out


def ot_pair_indices(x0: torch.Tensor, x1: torch.Tensor, method: str = "sinkhorn",
                    reg: float = 0.01, n_iters: int = 50) -> torch.Tensor:
    """For each set, the permutation j(i) pairing x0[:, i] with x1[:, j(i)]:
    indices (B, N) into x1's particle axis."""
    cost = pairwise_sq_dists(x0, x1)
    cost = cost / torch.clamp_min(torch.amax(cost, dim=(1, 2), keepdim=True), 1e-12)
    if method == "sinkhorn":
        return greedy_perm_from_plan(sinkhorn_plan(cost, reg=reg, n_iters=n_iters))
    if method == "exact":
        idx = _hungarian_host(cost.detach().cpu().numpy())
        return torch.from_numpy(idx).to(x0.device)
    raise ValueError(f"unknown OT pairing method: {method}")


def gather_particles(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather particles along axis 1: x (B, N, F), idx (B, N) -> (B, N, F)."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))
