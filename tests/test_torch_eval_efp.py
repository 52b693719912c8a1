"""PyTorch port, energy-flow polynomials (particle_fm_tpu_torch/eval/efp.py)
held against the JAX package's `efps` on 64 ragged jets of 30 particles:
within 1e-4 of each EFP's largest magnitude (float32, another order of
contraction). Also: the same graphs, invariance under padding, particle
permutation and chunking, the unwrapped dphi convention, and the CUDA
default of the entry point.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from particle_fm_tpu.eval import efp as jefp
from particle_fm_tpu_torch.eval import efp as pefp

RTOL_OF_LARGEST = 1e-4


def ragged_jets(b=64, n=30, seed=0, phi_shift=0.0):
    rs = np.random.RandomState(seed)
    count = rs.randint(2, n + 1, size=(b, 1))
    mask = (np.arange(n)[None, :] < count)[..., None]
    x = np.stack([rs.normal(0, 0.3, (b, n)), rs.normal(phi_shift, 0.3, (b, n)),
                  rs.exponential(0.05, (b, n))], -1).astype(np.float32)
    return x * mask


def assert_close_of_largest(got, want):
    assert got.shape == want.shape
    err = np.abs(got - want).max(axis=0) / np.abs(want).max(axis=0)
    assert (err <= RTOL_OF_LARGEST).all(), err


@pytest.mark.parametrize("n,d", [(2, 1), (3, 3), (4, 4)])
def test_graphs_match_jax(n, d):
    assert pefp.enumerate_multigraphs(n, d) == jefp.enumerate_multigraphs(n, d)


@pytest.mark.parametrize("phi_shift", [0.0, 3.0])  # 3.0: dphi beyond pi, not wrapped
def test_efps_match_jax(phi_shift):
    x = ragged_jets(phi_shift=phi_shift)
    want = jefp.efps(x)
    got = pefp.efps(x, device="cpu")
    assert got.shape == (64, 5) and got.dtype == np.float32
    assert_close_of_largest(got, want)


@pytest.mark.parametrize("n,d,beta", [(3, 3, 1.0), (4, 3, 2.0)])
def test_other_graph_sets_match_jax(n, d, beta):
    x = ragged_jets(b=16, n=12, seed=3)
    assert_close_of_largest(pefp.efps(x, n=n, d=d, beta=beta, device="cpu"),
                            jefp.efps(x, n=n, d=d, beta=beta))


def test_padding_permutation_and_chunks_change_nothing(monkeypatch):
    x = ragged_jets(b=32, n=20, seed=1)
    base = pefp.efps(x, device="cpu")
    padded = np.concatenate([x, np.zeros((32, 7, 3), np.float32)], axis=1)
    assert_close_of_largest(pefp.efps(padded, device="cpu"), base)
    perm = np.random.RandomState(2).permutation(20)
    assert_close_of_largest(pefp.efps(x[:, perm], device="cpu"), base)
    monkeypatch.setattr(pefp, "CHUNK", 5)
    np.testing.assert_array_equal(pefp.efps(x, device="cpu"), base)
    extra = np.concatenate([x, np.ones((32, 20, 2), np.float32)], axis=-1)  # only 3 features read
    np.testing.assert_array_equal(pefp.efps(extra, device="cpu"), base)


def test_contraction_stays_within_pairs():
    """Every graph is contracted with factors of at most two vertices: the
    elimination raises otherwise, so five graphs of four vertices pass."""
    z = torch.rand(2, 6)
    theta = torch.rand(2, 6, 6)
    theta = theta + theta.transpose(1, 2)
    for g in pefp.enumerate_multigraphs(4, 4):
        letters = "ijkl"
        spec = ",".join(f"b{letters[a]}{letters[b]}" for a, b in g) + ",bi,bj,bk,bl->b"
        want = torch.einsum(spec, *([theta] * len(g)), z, z, z, z)
        torch.testing.assert_close(pefp.contract_graph(g, 4, z, theta), want, rtol=1e-5, atol=0)
    k4 = tuple((a, b) for a in range(4) for b in range(a + 1, 4))  # treewidth 3
    with pytest.raises(ValueError, match="larger than"):
        pefp.contract_graph(k4, 4, z, theta)


def test_efps_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pefp.efps(ragged_jets(b=2))
