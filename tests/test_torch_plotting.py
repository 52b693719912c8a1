"""PyTorch port, the plots (particle_fm_tpu_torch/eval/plotting.py) held
against the JAX package's eval/plotting.py: every function draws the same
data on the same inputs. Each figure is read back artist by artist (the
histogram polygons, stairs, lines and scatter offsets, sizes and colours,
the axis labels and scales) and held within 1e-6 of the JAX figure's; then
each one writes its file. The EFP panels are drawn from the JAX EFPs on
both sides (the EFPs themselves differ in float32 rounding, within 1e-4 of
the largest: tests/test_torch_eval_efp.py). The callbacks with
`make_plots=True` call the same plotting functions as the JAX callbacks.
"""

from __future__ import annotations

import os
import types

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.collections import PathCollection  # noqa: E402
from matplotlib.patches import Polygon, StepPatch  # noqa: E402

from particle_fm_tpu.eval import plotting as jplot  # noqa: E402
from particle_fm_tpu_torch.eval import plotting as pplot  # noqa: E402

TOL = 1e-6


def drawn(fig) -> list:
    """What a figure draws, axis by axis: labels, scales and every artist's data."""
    out = []
    for ax in fig.axes:
        out.append(("axis", ax.get_xlabel(), ax.get_ylabel(), ax.get_xscale(), ax.get_yscale(),
                    ax.axison))
        for p in ax.patches:
            if isinstance(p, StepPatch):
                data = p.get_data()
                out += [np.asarray(data.values), np.asarray(data.edges)]
            elif isinstance(p, Polygon):
                out.append(np.asarray(p.get_xy()))
        for line in ax.lines:
            out.append(np.asarray(line.get_xydata()))
        for c in ax.collections:
            if isinstance(c, PathCollection):
                out += [np.asarray(c.get_offsets()), np.asarray(c.get_sizes())]
                if c.get_array() is not None:
                    out.append(np.asarray(c.get_array()))
    plt.close(fig)
    return out


def assert_same_drawing(got, want):
    got, want = drawn(got), drawn(want)
    assert len(got) == len(want) and len(got) > 1
    for a, b in zip(got, want):
        if isinstance(b, tuple):
            assert a == b
        else:
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, equal_nan=True)


def jets(b=40, n=12, seed=0):
    rs = np.random.RandomState(seed)
    counts = rs.randint(3, n + 1, b)
    mask = (np.arange(n)[None] < counts[:, None])[..., None]
    x = np.concatenate([rs.randn(b, n, 2) * 0.1, rs.rand(b, n, 1) * 0.2], axis=-1) * mask
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    return jets(seed=0), jets(seed=1)


CASES = {
    "plot_data": lambda m, r, g: m.plot_data(r, g),
    "plot_data efps": lambda m, r, g: m.plot_data(r, g, plot_efps=True, suffix="x",
                                                   **({"device": "cpu"} if m is pplot else {})),
    "plot_substructure": lambda m, r, g: m.plot_substructure(
        *[{k: np.abs(a[:, i, j]) for k, (i, j) in
           {"tau21": (0, 0), "tau32": (1, 1), "d2": (2, 2), "jet_mass": (3, 0)}.items()}
          for a in (r, g)]),
    "plot_loss_curves": lambda m, r, g: m.plot_loss_curves(
        [{"epoch": i, "train_loss": float(r[i, 0, 0]), "val_loss": float(g[i, 0, 1])}
         for i in range(6)] + [{"epoch": 6, "train_loss": 0.5}]),
    "plot_single_jets": lambda m, r, g: m.plot_single_jets(r, n_jets=7, seed=3),
    "plot_data_per_type": lambda m, r, g: m.plot_data_per_type(
        r, g, np.eye(3)[np.arange(40) % 3], type_names=["q", "t", "w"])[1],
    "plot_calo_showers": lambda m, r, g: m.plot_calo_showers(
        np.abs(r[..., [2, 0, 1, 1]]) * 10, (np.abs(r).sum(-1) > 0)[..., None], n_showers=5),
    "plot_generation_timing": lambda m, r, g: m.plot_generation_timing(
        [("epic", [30, 150], [1e-3, 4e-3]), ("droid", [30, 150], [2e-3, 9e-3])], xscale_log=True),
    "plot_feature_ratios": lambda m, r, g: m.plot_feature_ratios(
        r[:, 0, :], g[:, 0, :], labels=["a", "b", "c"]),
    "plot_feature_ratios one": lambda m, r, g: m.plot_feature_ratios(r[:, 0, :1], g[:, 0, :1]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_figure_draws_what_jax_draws(pair, case, tmp_path, monkeypatch):
    real, gen = pair
    if "efps" in case:  # the same EFPs on both sides (tests/test_torch_eval_efp.py holds them)
        from particle_fm_tpu.eval import efp as jefp
        from particle_fm_tpu_torch.eval import efp as pefp

        monkeypatch.setattr(pefp, "efps", lambda data, device: jefp.efps(data))
    assert_same_drawing(CASES[case](pplot, real, gen), CASES[case](jplot, real, gen))


def test_save_paths_are_written(pair, tmp_path):
    real, gen = pair
    plt.close("all")
    paths = {
        "data": pplot.plot_data(real, gen, str(tmp_path / "a" / "d.png")),
        "made": pplot.create_and_plot_data(real, gen, str(tmp_path / "b"), plot_name="m"),
        "loss": pplot.plot_loss_curves([{"epoch": 0, "train_loss": 1.0}],
                                       str(tmp_path / "l.png")),
        "jets": pplot.plot_single_jets(real, save_path=str(tmp_path / "j.png")),
        "calo": pplot.plot_calo_showers(np.abs(real[..., [2, 0, 1, 1]]),
                                        save_path=str(tmp_path / "c.png")),
        "timing": pplot.plot_generation_timing([("a", [1, 2], [1.0, 2.0])],
                                               str(tmp_path / "t.png")),
        "ratios": pplot.plot_feature_ratios(real[:, 0], gen[:, 0], str(tmp_path / "r.png")),
        "sub": pplot.plot_substructure(*[{k: a[:, 0, 0] for k in ("tau21", "tau32", "d2",
                                                                  "jet_mass")} for a in (real, gen)],
                                       str(tmp_path / "s.png")),
        "per type": pplot.plot_data_per_type(real, gen, np.eye(3)[np.arange(40) % 3],
                                             save_dir=str(tmp_path))[2],
    }
    assert paths["made"] == str(tmp_path / "b" / "m.png")
    assert paths["per type"] == str(tmp_path / "comparison_2.png")
    for name, p in paths.items():
        assert os.path.getsize(p) > 0, name
    assert not plt.get_fignums()  # every saved figure was closed


def test_prepare_data_for_plotting_matches_jax(pair):
    """Jet features and multiplicities within 1e-6; the EFPs, float32 in
    another order of contraction, within 1e-4 of each one's largest, as in
    tests/test_torch_eval_efp.py."""
    real, _ = pair
    got = pplot.prepare_data_for_plotting(real, calculate_efps=True, device="cpu")
    want = jplot.prepare_data_for_plotting(real, calculate_efps=True)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    assert got[2].shape == want[2].shape
    assert (np.abs(got[2] - want[2]).max(axis=0) / np.abs(want[2]).max(axis=0) <= 1e-4).all()
    assert pplot.FEATURE_LABELS == jplot.FEATURE_LABELS and pplot.JET_LABELS == jplot.JET_LABELS


def test_measure_generation_timing_generates_each_size():
    from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel

    runs = []
    for n in (4, 8):
        model = FlowMatchingModel(features=3, num_particles=n, hidden_dim=8, latent=2, layers=1,
                                  frequencies=2)
        runs.append((n, model, model.init(device="cpu")))
    sizes, per_jet = pplot.measure_generation_timing(runs, jets_to_generate=6, batch_size=2,
                                                     ode_steps=2)
    assert sizes == [4, 8] and len(per_jet) == 2 and all(s > 0 for s in per_jet)


def test_calo_callback_plots_as_jax(tmp_path, monkeypatch):
    """CaloEvalCallback(make_plots=True) hands the plotting functions the
    JAX callback's arrays and file names (tests/test_torch_eval_datasets.py
    holds its metrics; FinalEvalCallback's plots: test_torch_eval_callbacks.py)."""
    from particle_fm_tpu.eval import callbacks as jcb
    from particle_fm_tpu_torch.eval import callbacks as pcb

    calls = {"port": [], "jax": []}
    for side, mod in (("port", pplot), ("jax", jplot)):
        monkeypatch.setattr(mod, "plot_calo_showers", (lambda s: lambda x, mask, save_path: calls[
            s].append((np.array(x), np.array(mask), os.path.relpath(save_path, tmp_path / s))))(
            side))
    x = np.abs(jets(b=6, n=10))[..., [2, 0, 1, 1]] * 3
    mask = (x.sum(-1) > 0)[..., None].astype(np.float32)
    dm = types.SimpleNamespace(tensor_test=x, mask_test=mask, tensor_conditioning_test=None,
                               means=None, stds=None)
    for side, mod in (("port", pcb), ("jax", jcb)):
        monkeypatch.setattr(mod, "generate_data", lambda *a, **k: (x[::-1].copy(), 0.1))
        tr = types.SimpleNamespace(datamodule=dm, epoch=3, testing=True, log_dir=None,
                                   artifacts_dir=str(tmp_path / side), device=torch.device("cpu"),
                                   model=None, state=types.SimpleNamespace(
                                       ema_network=lambda: None, variables=lambda ema: {}))
        mod.CaloEvalCallback(make_plots=True, num_showers=6)(tr)
    assert len(calls["port"]) == len(calls["jax"]) == 2
    for got, want in zip(calls["port"], calls["jax"]):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    assert calls["port"][0][2] == os.path.join("callback_images", "showers_gen_epoch3.png")
