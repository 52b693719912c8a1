"""PyTorch port, the evaluation metrics (particle_fm_tpu_torch/eval/metrics.py),
the jet kinematics they rest on (data/utils.py) and the logging schedules
(training/logging_scheduler.py), held against the JAX package's on the same
seeded numpy arrays with both bootstrap generators (`_rng`) pinned to one
seed: equal to atol 1e-12 (the code is the same numpy and scipy). `w1efp`'s
bootstrap is held with both packages' `efps` replaced by one function; the
EFPs themselves are held in tests/test_torch_eval_efp.py.
"""

from __future__ import annotations

import numpy as np
import pytest

from particle_fm_tpu.data import utils as jutils
from particle_fm_tpu.eval import metrics as jm
from particle_fm_tpu.training import logging_scheduler as jsched
from particle_fm_tpu_torch.data import utils as putils
from particle_fm_tpu_torch.eval import metrics as pm
from particle_fm_tpu_torch.training import logging_scheduler as psched

ATOL = 1e-12


def jets(b=48, n=20, seed=0):
    """(etarel, phirel, ptrel) clouds with 3..n real particles, and masks."""
    rs = np.random.RandomState(seed)
    count = rs.randint(3, n + 1, size=(b, 1))
    mask = (np.arange(n)[None, :] < count).astype(np.float32)[..., None]
    x = np.stack([rs.normal(0, 0.2, (b, n)), rs.normal(0, 0.2, (b, n)),
                  rs.exponential(0.05, (b, n))], -1).astype(np.float32) * mask
    return x, mask


def pinned(monkeypatch, seed=3):
    monkeypatch.setattr(jm, "_rng", np.random.default_rng(seed))
    monkeypatch.setattr(pm, "_rng", np.random.default_rng(seed))


def assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=ATOL, err_msg=k)
        return
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_allclose(y, x, rtol=0, atol=ATOL)
        return
    np.testing.assert_allclose(b, a, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["m2s_from_p4s", "ms_from_p4s", "pts_from_p4s", "ys_from_p4s",
                                  "ptyphims_from_p4s"])
def test_p4_helpers_match_jax(name):
    rs = np.random.RandomState(1)
    p4 = jutils.p4s_from_ptyphims(np.stack([rs.exponential(1, 50), rs.normal(0, 1, 50),
                                            rs.uniform(-3, 3, 50), rs.exponential(0.1, 50)], -1))
    assert_same(getattr(jutils, name)(p4), getattr(putils, name)(p4))


@pytest.mark.parametrize("name", ["calculate_jet_features", "get_jet_data",
                                  "inverse_normalize_tensor", "get_mjj"])
def test_jet_features_match_jax(name):
    x, _ = jets(seed=2)
    if name == "inverse_normalize_tensor":
        args = (x, [0.1, -0.2, 0.03], [0.5, 0.4, 0.02], 5)
    elif name == "get_mjj":
        f = jutils.calculate_jet_features(x)
        args = (f[:24], f[24:])
    elif name == "get_jet_data":
        args = (x[..., [2, 0, 1]],)
    else:
        args = (x,)
    assert_same(getattr(jutils, name)(*args), getattr(putils, name)(*args))


def test_jet_masses_match_jax():
    x, _ = jets(seed=4)
    assert_same(jm.jet_masses_from_rel(x), pm.jet_masses_from_rel(x))


@pytest.mark.parametrize("func", ["wasserstein_distance_batched", "w1m", "w1p", "w1p_masked",
                                  "calculate_wasserstein_metrics_jets"])
def test_bootstrapped_w1_matches_jax(monkeypatch, func):
    a, ma = jets(seed=5)
    b, mb = jets(b=40, seed=6)
    pinned(monkeypatch)
    if func == "wasserstein_distance_batched":
        args, kw = (a[..., 2].ravel(), b[..., 2].ravel(), 100, 7), {}
    elif func == "calculate_wasserstein_metrics_jets":
        args = (jutils.calculate_jet_features(a), jutils.calculate_jet_features(b))
        kw = dict(num_eval_samples=30, num_batches=6)
    elif func == "w1p_masked":
        func, args, kw = "w1p", (a, b, ma, mb, 30, 6), {}
    else:
        args, kw = (a, b), dict(num_eval_samples=30, num_batches=6)
    want = getattr(jm, func)(*args, **kw)
    got = getattr(pm, func)(*args, **kw)
    assert_same(want, got)


@pytest.mark.parametrize("calculate_efps,use_masks", [(False, False), (False, True), (True, False)])
def test_all_wasserstein_metrics_match_jax(monkeypatch, calculate_efps, use_masks):
    a, ma = jets(seed=7)
    b, mb = jets(b=40, seed=8)
    # one EFP function on both sides: the bootstrap is held here, the EFPs
    # in tests/test_torch_eval_efp.py
    from particle_fm_tpu.eval.efp import efps as jax_efps

    monkeypatch.setattr(jm, "efps", lambda x: jax_efps(x))
    monkeypatch.setattr(pm, "efps", lambda x, device: jax_efps(x))
    pinned(monkeypatch)
    kw = dict(num_eval_samples=30, num_batches=5, calculate_efps=calculate_efps,
              use_masks=use_masks)
    want = jm.calculate_all_wasserstein_metrics(a, b, ma, mb, **kw)
    got = pm.calculate_all_wasserstein_metrics(a, b, ma, mb, device="cpu", **kw)
    assert_same(want, got)
    assert (got["w1efp_mean"] > 0) == calculate_efps


def features(seed, n=400, d=5):
    rs = np.random.RandomState(seed)
    return rs.randn(n, d) @ rs.randn(d, d) * 0.3 + rs.randn(d)


@pytest.mark.parametrize("func", ["fpd", "fpd_infinite", "kpd"])
def test_fpd_kpd_match_jax(func):
    r, g = features(9), features(10)
    kw = {"fpd_infinite": dict(min_samples=50, max_samples=400, num_batches=4),
          "kpd": dict(num_batches=4, batch_size=200)}.get(func, {})
    assert_same(getattr(jm, func)(r, g, **kw), getattr(pm, func)(r, g, **kw))


def test_kld_matches_jax():
    rs = np.random.RandomState(11)
    p, q = rs.rand(30), rs.rand(30)
    p[3] = 0
    assert_same(jm.kl_divergence(p, q, rescale=True), pm.kl_divergence(p, q, rescale=True))
    t, a = rs.randn(2000), rs.randn(1500) * 1.1 + 0.1
    assert_same(jm.histedges_equalN(t, 20), pm.histedges_equalN(t, 20))
    assert_same(jm.calc_reverse_kld(t, a, nbins=20, return_pi_qi_bins=True),
                pm.calc_reverse_kld(t, a, nbins=20, return_pi_qi_bins=True))
    assert_same(jm.calc_reverse_kld(t, a, nbins=20, clip_approx=True),
                pm.calc_reverse_kld(t, a, nbins=20, clip_approx=True))


@pytest.mark.parametrize("func", ["reversed_kl_divergence_batched_bootstrapping",
                                  "reversed_kl_divergence_batched"])
def test_batched_reverse_kld_matches_jax(func):
    a, ma = jets(seed=12)
    b, mb = jets(b=40, seed=13)
    kw = dict(mask_target=ma[..., 0] > 0, mask_approx=mb[..., 0] > 0, num_batches=4, nbins=15)
    if func.endswith("bootstrapping"):
        kw["num_eval_samples"] = 30
        a_, b_ = a[..., 2], b[..., 2]
    else:
        a_, b_ = a[:40, :, 2], b[..., 2]
        kw["mask_target"] = kw["mask_target"][:40]
    assert_same(getattr(jm, func)(a_, b_, **kw), getattr(pm, func)(a_, b_, **kw))


@pytest.mark.parametrize("schedule", [1, 7, *jsched.SCHEDULES])
def test_logging_schedules_match_jax(schedule):
    epochs = range(0, 10_050)
    assert [psched.should_log(schedule, e) for e in epochs] == [
        jsched.should_log(schedule, e) for e in epochs]
    assert psched.SCHEDULES.keys() == jsched.SCHEDULES.keys()
