"""PyTorch port, the evaluation of the LHCO and CaloChallenge datasets held
against the JAX package on the CPU.

- `eval/lhco_utils.py::cluster_data` on whole synthetic events equals the
  JAX package's (jets, constituents, masks), on the port's own clusterer.
- `WholeEventEvalCallback`, `CaloEvalCallback` and `JetNetEvalCallback` on
  the LHCO `test_sr` split (asking for more sets than the split holds, so
  that its masks and conditioning are tiled), each on its own package's
  datamodule (equal arrays, tests/test_torch_data_*.py), with generation
  pinned: `generate_data` is replaced on each side by one function that
  records what it is asked for and returns the same sets. Both sides ask
  for the same conditioning and masks; with the bootstrap generator seeded
  alike their metrics (the same names) agree within 1e-6 relative, and
  `CaloEvalCallback` fills histograms with identical bins and counts.
"""

from __future__ import annotations

import os

from types import SimpleNamespace

import numpy as np
import pytest

from particle_fm_tpu.data import calo as jcalo
from particle_fm_tpu.data import calo_scalers as jsc
from particle_fm_tpu.data import lhco as jlhco
from particle_fm_tpu.eval import callbacks as jcb
from particle_fm_tpu.eval import lhco_utils as jlu
from particle_fm_tpu.eval import metrics as jmetrics
from particle_fm_tpu_torch.data import calo as pcalo
from particle_fm_tpu_torch.data import calo_scalers as psc
from particle_fm_tpu_torch.data import lhco as plhco
from particle_fm_tpu_torch.eval import callbacks as pcb
from particle_fm_tpu_torch.eval import lhco_utils as plu
from particle_fm_tpu_torch.eval import metrics as pmetrics

RTOL = 1e-6
W1 = {"num_eval_samples": 200, "num_batches": 5}


def pair(jmod, pmod, cls, **kw):
    out = []
    for mod in (jmod, pmod):
        dm = getattr(mod, cls)(synthetic=True, batch_size=32, **kw)
        dm.setup()
        out.append(dm)
    return out


def trainers(jdm, pdm):
    jax_side = SimpleNamespace(datamodule=jdm, model=None, epoch=1, testing=True, log_dir=None,
                               artifacts_dir=None,
                               state=SimpleNamespace(variables=lambda ema=False: {}))
    port_side = SimpleNamespace(datamodule=pdm, model=None, epoch=1, testing=True, log_dir=None,
                                artifacts_dir=None, device="cpu",
                                state=SimpleNamespace(ema_network=lambda: None, net=None))
    return jax_side, port_side


def pin_generation(monkeypatch, pool: np.ndarray) -> dict:
    """Both packages' callbacks generate `pool`'s first sets times the mask
    they pass; returns what each side asked for."""
    asked = {}

    def fake(side):
        def generate_data(model, net, num_jet_samples, cond=None, mask=None, **kw):
            asked[side] = (num_jet_samples, cond, mask)
            gen = pool[:num_jet_samples].copy()
            if mask is not None:
                gen = gen * mask
            return gen, 0.25
        return generate_data

    monkeypatch.setattr(jcb, "generate_data", fake("jax"))
    monkeypatch.setattr(pcb, "generate_data", fake("port"))
    return asked


def run_both(monkeypatch, jcall, pcall) -> tuple[dict, dict]:
    monkeypatch.setattr(jmetrics, "_rng", np.random.default_rng(7))
    want = jcall()
    monkeypatch.setattr(pmetrics, "_rng", np.random.default_rng(7))
    got = pcall()
    return got, want


def assert_metrics(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=0, err_msg=key)


def assert_asked_alike(asked: dict) -> None:
    (jn, jc, jm), (pn, pc, pm) = asked["jax"], asked["port"]
    assert jn == pn
    for a, b in ((jc, pc), (jm, pm)):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(b, a)


@pytest.fixture(scope="module")
def whole_events():
    return pair(jlhco, plhco, "LHCOWholeEventDataModule", num_particles=120,
                synthetic_num_events=300)


def test_cluster_data_matches_jax(whole_events):
    _, pdm = whole_events
    events = pdm.tensor_test[..., [2, 0, 1]]  # (eta, phi, pt) -> (pt, eta, phi)
    got = plu.cluster_data(events, num_particles=40, R=1.0)
    want = jlu.cluster_data(events, num_particles=40, R=1.0)
    assert got[2].sum() > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    pt, real = got[1][..., 0], got[2][..., 1:, 0] > 0
    assert np.all(np.diff(pt, axis=-1)[real] <= 0)  # each jet's constituents by falling pt


def test_whole_event_callback_matches_jax(monkeypatch, whole_events):
    jdm, pdm = whole_events
    kw = dict(num_jet_samples=-1, generation_batch_size=64, cluster_num_particles=40,
              w1_kwargs=W1, split="test")
    jt, pt = trainers(jdm, pdm)
    pool = np.flip(pdm.tensor_test, axis=0).copy()  # other events as the "generated" ones
    asked = pin_generation(monkeypatch, pool)
    got, want = run_both(monkeypatch, lambda: jcb.WholeEventEvalCallback(**kw)(jt),
                         lambda: pcb.WholeEventEvalCallback(**kw)(pt))
    assert_asked_alike(asked)
    assert "w1_mjj_mean" in got and "w1m_mean_x" in got and "w1mass_jet_mean_y" in got
    assert_metrics(got, want)


def test_jetnet_callback_on_the_lhco_signal_region_matches_jax(monkeypatch):
    jdm, pdm = pair(jlhco, plhco, "LHCODataModule", jet_type="x", num_particles=48,
                    synthetic_num_events=300, multiplicity_conditioning=True)
    n = 2 * len(pdm.tensor_test_sr) + 3  # more than the split: its masks and cond are tiled
    kw = dict(num_jet_samples=n, generation_batch_size=64, w1_kwargs=W1, split="test_sr")
    jt, pt = trainers(jdm, pdm)
    pool = pcb._tile_to(pdm.tensor_train, n)
    asked = pin_generation(monkeypatch, pool)
    got, want = run_both(monkeypatch, lambda: jcb.JetNetEvalCallback(**kw)(jt),
                         lambda: pcb.JetNetEvalCallback(**kw)(pt))
    assert_asked_alike(asked)
    np.testing.assert_array_equal(asked["port"][2], pcb._tile_to(pdm.mask_test_sr, n))
    assert {"w1m_mean", "w1p_mean", "generation_time"} <= set(got)
    assert_metrics(got, want)


def test_calo_callback_matches_jax(monkeypatch):
    dms = []
    for mod, scalers in ((jcalo, jsc), (pcalo, psc)):
        dm = mod.CaloChallengeDataModule(synthetic=True, scaler=scalers.default_calo_scaler(),
                                         synthetic_num_showers=300, max_hits=96,
                                         bucket_multiple=16, batch_size=32)
        dm.setup()
        dms.append(dm)
    jdm, pdm = dms
    n = len(pdm.tensor_test)
    kw = dict(num_showers=n, generation_batch_size=16)
    jt, pt = trainers(jdm, pdm)
    rs = np.random.RandomState(2)
    pool = pdm.tensor_train[:n] + 0.3 * rs.randn(n, *pdm.tensor_train.shape[1:]).astype(
        np.float32)
    asked = pin_generation(monkeypatch, pool)
    hists = {"jax": [], "port": []}

    def recorded(module, side):
        inner = module._hist_cdf_w1

        def wrapper(real, gen, edges, weights_real=None, weights_gen=None):
            hists[side].append((np.asarray(edges),
                                np.histogram(real, bins=edges, weights=weights_real)[0],
                                np.histogram(gen, bins=edges, weights=weights_gen)[0]))
            return inner(real, gen, edges, weights_real, weights_gen)
        monkeypatch.setattr(module, "_hist_cdf_w1", wrapper)

    recorded(jcb, "jax")
    recorded(pcb, "port")
    got, want = run_both(monkeypatch, lambda: jcb.CaloEvalCallback(**kw)(jt),
                         lambda: pcb.CaloEvalCallback(**kw)(pt))
    assert_asked_alike(asked)
    assert {"features_E", "features_z_weighted", "weighted_z", "w1p_mean",
            "w1_response"} <= set(got)
    assert_metrics(got, want)
    assert len(hists["port"]) == len(hists["jax"]) == 8
    for (e1, r1, g1), (e2, r2, g2) in zip(hists["port"], hists["jax"]):
        np.testing.assert_array_equal(e1, e2)
        np.testing.assert_allclose(r1, r2, rtol=RTOL, atol=0)
        np.testing.assert_allclose(g1, g2, rtol=RTOL, atol=0)
    assert sum(h[1].sum() for h in hists["port"]) > 0


def test_calo_callback_plots_raise(monkeypatch, tmp_path):
    """The plots are ported and raise no more: with make_plots the callback
    gives the JAX callback's metrics and writes its two shower grids."""
    dms = []
    for mod, scalers in ((jcalo, jsc), (pcalo, psc)):
        dm = mod.CaloChallengeDataModule(synthetic=True, scaler=scalers.default_calo_scaler(),
                                         synthetic_num_showers=120, max_hits=48,
                                         bucket_multiple=16, batch_size=32)
        dm.setup()
        dms.append(dm)
    jdm, pdm = dms
    n = len(pdm.tensor_test)
    jt, pt = trainers(jdm, pdm)
    jt.artifacts_dir, pt.artifacts_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    pin_generation(monkeypatch, pdm.tensor_train[:n] * 1.1)
    kw = dict(num_showers=n, generation_batch_size=16, make_plots=True)
    got, want = run_both(monkeypatch, lambda: jcb.CaloEvalCallback(**kw)(jt),
                         lambda: pcb.CaloEvalCallback(**kw)(pt))
    assert_metrics(got, want)
    images = [sorted(os.listdir(tmp_path / side / "callback_images")) for side in ("port", "jax")]
    assert images[0] == images[1] == ["showers_gen_epoch1.png", "showers_real_epoch1.png"]
