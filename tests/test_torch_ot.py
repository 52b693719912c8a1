"""PyTorch port, the minibatch-OT pairing of OT-CFM (losses/ot.py) held
against the JAX package on the CPU: the normalised squared-distance cost,
the log-domain Sinkhorn plan on the same cost, the hardening of a plan into a
permutation by the greedy rounds (which return the row argmax where it
already is one, as the JAX package's fast path does; first index on ties) and the exact Hungarian pairing.

Tolerances: cost atol 1e-5 (values up to ~30); Sinkhorn plan atol 1e-6;
permutations equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.losses import ot as jot
from particle_fm_tpu_torch.losses import ot as pot
from tests.torch_port_helpers import t


def _sets(b, n, seed):
    rs = np.random.RandomState(seed)
    return rs.randn(b, n, 3).astype(np.float32), (rs.randn(b, n, 3) * 2 + 1).astype(np.float32)


@pytest.mark.parametrize("n", [4, 16])
def test_pairwise_sq_dists_matches_jax(n):
    x0, x1 = _sets(3, n, n)
    ref = np.asarray(jot.pairwise_sq_dists(jnp.asarray(x0), jnp.asarray(x1)))
    out = pot.pairwise_sq_dists(t(x0), t(x1)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    assert (out >= 0).all()


@pytest.mark.parametrize("reg,n_iters", [(0.01, 50), (0.1, 20), (0.05, 1)])
@pytest.mark.parametrize("n", [5, 16])
def test_sinkhorn_plan_matches_jax(reg, n_iters, n):
    x0, x1 = _sets(4, n, 3)
    cost = np.asarray(jot.pairwise_sq_dists(jnp.asarray(x0), jnp.asarray(x1)))
    cost = cost / cost.max(axis=(1, 2), keepdims=True)
    ref = np.asarray(jot.sinkhorn_plan(jnp.asarray(cost), reg=reg, n_iters=n_iters))
    out = pot.sinkhorn_plan(t(cost), reg=reg, n_iters=n_iters).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    np.testing.assert_allclose(out.sum(axis=1), 1.0 / n, atol=1e-5)  # column marginals


def _is_perm(p):
    return all(sorted(row) == list(range(len(row))) for row in p)


def test_greedy_takes_the_row_argmax_when_it_is_a_permutation():
    rs = np.random.RandomState(0)
    perm = np.stack([rs.permutation(8) for _ in range(3)])
    plan = rs.rand(3, 8, 8).astype(np.float32) * 0.1
    plan[np.arange(3)[:, None], np.arange(8)[None], perm] += 1.0
    out = pot.greedy_perm_from_plan(t(plan)).numpy()
    np.testing.assert_array_equal(out, perm)
    np.testing.assert_array_equal(out, np.asarray(jot.greedy_perm_from_plan(jnp.asarray(plan))))


@pytest.mark.parametrize("case", ["random", "collide", "ties"])
def test_greedy_rounds_match_jax(case):
    rs = np.random.RandomState(1)
    if case == "random":
        plan = rs.rand(4, 9, 9).astype(np.float32)
    elif case == "collide":  # every row prefers data particle 0
        plan = rs.rand(4, 9, 9).astype(np.float32)
        plan[..., 0] += 2.0
    else:  # all equal: the first index wins every round
        plan = np.ones((2, 6, 6), np.float32)
    ref = np.asarray(jot.greedy_perm_from_plan(jnp.asarray(plan)))
    out = pot.greedy_perm_from_plan(t(plan)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert _is_perm(out)
    with pytest.raises(ValueError, match="square"):
        pot.greedy_perm_from_plan(torch.ones(1, 3, 4))


@pytest.mark.parametrize("method", ["sinkhorn", "exact"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pair_indices_match_jax(method, seed):
    x0, x1 = _sets(6, 16, seed)
    ref = np.asarray(jot.ot_pair_indices(jnp.asarray(x0), jnp.asarray(x1), method=method))
    out = pot.ot_pair_indices(t(x0), t(x1), method=method).numpy()
    np.testing.assert_array_equal(out, ref)
    assert _is_perm(out)
    gathered = pot.gather_particles(t(x1), torch.from_numpy(out)).numpy()
    np.testing.assert_array_equal(
        gathered, np.asarray(jot.gather_particles(jnp.asarray(x1), jnp.asarray(ref))))


def test_exact_pairing_is_optimal_and_unknown_method_raises():
    x0, x1 = _sets(3, 7, 5)
    exact = pot.ot_pair_indices(t(x0), t(x1), method="exact")
    sink = pot.ot_pair_indices(t(x0), t(x1), method="sinkhorn")
    cost = pot.pairwise_sq_dists(t(x0), t(x1))
    total = lambda p: torch.gather(cost, 2, p[..., None]).sum(dim=(1, 2))
    assert (total(exact) <= total(sink) + 1e-5).all()
    with pytest.raises(ValueError, match="unknown"):
        pot.ot_pair_indices(t(x0), t(x1), method="emd")


def test_family_modules_import_without_jax():
    """The modules of the other loss families and solvers load neither JAX
    nor the JAX package."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys, particle_fm_tpu_torch, particle_fm_tpu_torch.losses.diffusion, "
        "particle_fm_tpu_torch.losses.ot, particle_fm_tpu_torch.samplers.sde, "
        "particle_fm_tpu_torch.samplers.ode, particle_fm_tpu_torch.models.flow_matching\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax', 'optax'))"
        " or m == 'particle_fm_tpu' or m.startswith('particle_fm_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                   check=True, timeout=120)
