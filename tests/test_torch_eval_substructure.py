"""PyTorch port, jet substructure (particle_fm_tpu_torch/eval/substructure.py)
and its clusterer (native/cluster.cpp through native/binding.py) held against
the JAX package on seeded ragged jets of up to 40 particles and on synthetic
JetNet-150 jets (N = 150, as the eval path clusters). The port's C++ computes what the JAX
package's computes, step for step, so tau1-3, tau21, tau32, d12, d23 and the
jet kinematics agree to 1e-12, as do the binding's three functions, split
over threads or not; the energy correlators run in float32 with torch: e2
and e3 rtol 1e-4, d2 rtol 1e-3. Also: the library is built into build/, a
failed build raises, `dump_hlvs` writes every observable, and the
correlators default to CUDA.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from particle_fm_tpu.eval.substructure import compute_substructure as jax_substructure
from particle_fm_tpu.native import binding as jbinding
from particle_fm_tpu_torch.data.synthetic import synthetic_jetnet
from particle_fm_tpu_torch.eval import substructure as psub
from particle_fm_tpu_torch.native import binding as pbinding

EXACT = ("jet_pt", "jet_mass", "tau1", "tau2", "tau3", "tau21", "tau32", "d12", "d23")


def ragged_jets(b=48, n=40, seed=0):
    rs = np.random.RandomState(seed)
    count = rs.randint(1, n + 1, size=(b, 1))
    count[:3, 0] = (1, 2, 3)  # fewer particles than axes
    mask = (np.arange(n)[None, :] < count)[..., None]
    prong = rs.choice([-1.0, 1.0], size=(b, n))
    x = np.stack([rs.normal(0, 0.15, (b, n)) + 0.2 * prong,
                  rs.normal(0, 0.15, (b, n)) + 0.1 * prong,
                  rs.exponential(0.05, (b, n))], -1)
    x[4, :, 1] += 3.0  # phi across the branch cut
    return (x * mask).astype(np.float32)


def jetnet150(b=24, seed=5):
    """Synthetic JetNet-150 top jets (etarel, phirel, ptrel), zero-padded."""
    parts, _ = synthetic_jetnet(["t"], num_jets=b, num_particles=150, seed=seed)
    return np.ascontiguousarray(parts[..., :3])


JETS = {"ragged40": ragged_jets, "jetnet150": jetnet150}


@pytest.fixture(scope="module", params=sorted(JETS))
def both(request):
    x = JETS[request.param]()
    return jax_substructure(x), psub.compute_substructure(x, device="cpu")


@pytest.mark.parametrize("key", EXACT)
def test_clustered_observables_match_jax(both, key):
    want, got = both
    np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-12)


@pytest.mark.parametrize("key,rtol", [("e2", 1e-4), ("e3", 1e-4), ("d2", 1e-3)])
def test_correlators_match_jax(both, key, rtol):
    want, got = both
    assert got[key].dtype == np.float64
    np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=0)


def pt_eta_phi(jets):
    x = (ragged_jets(b=200, n=30, seed=1) if jets == "ragged30" else jetnet150(b=48, seed=6))
    x = x.astype(np.float64)
    return x[..., 2], x[..., 0], x[..., 1]


@pytest.mark.parametrize("jets", ["ragged30", "jetnet150"])
@pytest.mark.parametrize("threads", [1, "many"])
def test_binding_matches_jax(monkeypatch, threads, jets):
    if threads == "many":
        monkeypatch.setattr(pbinding, "MIN_EVENTS_PER_THREAD", 16)
    else:
        monkeypatch.setattr(pbinding.os, "sched_getaffinity", lambda _: {0})
    pt, eta, phi = pt_eta_phi(jets)
    for got, want in (
        (pbinding.cluster_events(pt, eta, phi, R=0.4, p=-1.0, max_jets=4),
         jbinding.cluster_events(pt, eta, phi, R=0.4, p=-1.0, max_jets=4)),
        (pbinding.cluster_events(pt, eta, phi, R=0.8, p=0.0, min_pt=0.05),
         jbinding.cluster_events(pt, eta, phi, R=0.8, p=0.0, min_pt=0.05)),
        (pbinding.exclusive_kt_axes(pt, eta, phi, R=0.8, n_axes=3),
         jbinding.exclusive_kt_axes(pt, eta, phi, R=0.8, n_axes=3)),
        ((pbinding.kt_split_scales(pt, eta, phi, R=0.8, n_scales=3),),
         (jbinding.kt_split_scales(pt, eta, phi, R=0.8, n_scales=3),)),
    ):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_library_is_built_into_build_dir():
    path = pbinding.build()
    assert path.parent.name == "native" and path.parent.parent.name == "build"
    assert path.exists() and not list(pbinding.SOURCE.parent.glob("*.so"))


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(pbinding, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(pbinding, "CXXFLAGS", pbinding.CXXFLAGS + ["-fno-such-option"])
    with pytest.raises(RuntimeError, match="failed"):
        pbinding.build()
    assert not list(tmp_path.iterdir())


def test_dump_hlvs_writes_every_observable(tmp_path):
    h5py = pytest.importorskip("h5py")
    x = ragged_jets(b=8, seed=2)
    path = tmp_path / "hlvs.h5"
    hlvs = psub.dump_hlvs(x, str(path), device="cpu")
    with h5py.File(path, "r") as f:
        assert set(f) == set(hlvs)
        for k, v in hlvs.items():
            np.testing.assert_array_equal(f[k][()], v)


def test_mask_argument_and_chunks(monkeypatch):
    x = ragged_jets(b=20, seed=3)
    mask = (x[..., 2] > 0).astype(np.float32)[..., None]
    base = psub.compute_substructure(x, device="cpu")
    with_mask = psub.compute_substructure(x, mask=mask, device="cpu")
    for k in base:
        np.testing.assert_array_equal(with_mask[k], base[k])
    pt, eta, phi = (x[..., i].astype(np.float64) for i in (2, 0, 1))
    monkeypatch.setattr(psub, "CHUNK", 3)
    for a, b in zip(psub.ecfs(pt, eta, phi, mask[..., 0], device="cpu"),
                    (base["e2"], base["e3"])):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_correlators_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        psub.compute_substructure(ragged_jets(b=8))
