"""PyTorch port, the sampling scripts held against the JAX scripts on the CPU:
scripts/torch_guidance_sweep.py (scripts/guidance_sweep.py),
scripts/torch_generate_jets_jetclass.py (scripts/generate_jets_jetclass.py)
and scripts/torch_timing_plots.py (scripts/timing_plots.py).

Both sides read the same run: the run loaders are replaced by one narrow
model (sincos time: the JAX drivers sample under jit, where XLA's cosine
table is one ulp off the one the port loads, ROADMAP Queue 3 item 1) whose
seeded JAX weights are carried into the port (utils/from_jax.py)
and each package's own synthetic datamodule of the same config (their
arrays equal). Each batch's noise is the JAX driver's (`generate_data`
batch i, pinned into the port's `draw_noise`), and the W1 bootstraps of both
metrics modules draw from generators seeded alike.

Tolerances: the sampled sets within 1e-4; the JetClass h5 arrays within 1e-4
(the samples) or equal (masks, conditioning, the `names` attributes); the
guidance sweep's `floor_real_mae` equal, and per w the W1M, the W1P and the
MAE of m_rel within the largest gap of the quantity they are 1-Lipschitz in
(jet mass, particle feature, m_rel) between the two samples, r within
2 |gap of m_rel| / |centred m_rel| (both norms over the sample); the timing
study's sizes and model configurations equal (times are not compared).
"""

from __future__ import annotations

import sys

import h5py
import jax
import numpy as np
import pytest
import yaml

from particle_fm_tpu.config.core import compose as jax_compose
from particle_fm_tpu.config.core import instantiate as jax_instantiate
from particle_fm_tpu.eval import generation as jgen
from particle_fm_tpu.eval import metrics as jmetrics
from particle_fm_tpu_torch.config.core import compose, instantiate
from particle_fm_tpu_torch.eval import generation as pgen
from particle_fm_tpu_torch.eval import metrics as pmetrics
from particle_fm_tpu_torch.models import flow_matching as pfm
from particle_fm_tpu_torch.serving import chunk_seed
from particle_fm_tpu_torch.train import CONFIG_DIR
from tests.torch_port_helpers import jax_noise_of_batch, model_pair, t

TOL = 1e-4


def run_pair(overrides: list[str], fill: float = 0.3):
    """(jax (cfg, dm, model, variables), port (cfg, dm, model, net)) of one
    composed config: each package's datamodule, the JAX weights carried."""
    cfg = compose(CONFIG_DIR, "train", overrides=overrides)
    jcfg = jax_compose(CONFIG_DIR, "train", overrides=overrides)
    jdm, pdm = jax_instantiate(jcfg["data"]), instantiate(cfg["data"])
    jdm.setup()
    pdm.setup()
    for name in ("tensor_test", "mask_test", "tensor_conditioning_test"):
        np.testing.assert_array_equal(getattr(pdm, name), getattr(jdm, name))
    model_cfg = {k: v for k, v in cfg["model"].items()
                 if k not in ("_target_", "optimizer", "scheduler")}
    jm, variables, pm, net = model_pair(model_cfg, fill=fill)
    return (jcfg, jdm, jm, variables), (cfg, pdm, pm, net)


def pin(monkeypatch, jax_run, port_run, seed: int):
    """Both scripts' run loaders return the pair; the port's batches draw the
    JAX driver's noise (seed `seed`); both generate_data calls are recorded."""
    from particle_fm_tpu.utils import run_io as jrun_io
    from particle_fm_tpu_torch.utils import run_io as prun_io
    from scripts import generate_data_lhco

    monkeypatch.setattr(jrun_io, "load_run", lambda *a, **k: jax_run)
    monkeypatch.setattr(generate_data_lhco, "load_run", lambda *a, **k: jax_run)
    monkeypatch.setattr(prun_io, "load_run", lambda *a, **k: port_run)
    batches = {chunk_seed(seed, i): i for i in range(64)}
    monkeypatch.setattr(pfm, "draw_noise", lambda g, shape, device: t(
        jax_noise_of_batch(seed, batches[g.initial_seed()], shape)).to(device))
    samples = {"jax": [], "port": [], "jax_w": [], "port_w": []}
    for side, module in (("jax", jgen), ("port", pgen)):
        inner = module.generate_data

        def recorded(*a, _inner=inner, _side=side, **k):
            out = _inner(*a, **k)
            samples[_side].append(out[0])
            samples[f"{_side}_w"].append(k.get("guidance_scale"))
            return out
        monkeypatch.setattr(module, "generate_data", recorded)
    return samples


def run_jax_script(monkeypatch, module, argv: list[str]):
    monkeypatch.setattr(sys, "argv", [module.__file__] + argv)
    return module.main()


CFG_RUN = ["experiment=jetnet/fm_cfg_tops30", "data.synthetic=true",
           "data.synthetic_num_jets=300", "model.hidden_dim=16", "model.layers=2",
           "model.latent=4", "model.num_particles=12", "model.t_emb=sincos"]


def test_guidance_sweep_matches_jax(tmp_path, monkeypatch):
    from scripts import guidance_sweep as jscript
    from scripts import torch_guidance_sweep as pscript

    jax_run, port_run = run_pair(CFG_RUN)
    samples = pin(monkeypatch, jax_run, port_run, pscript.SEED)
    argv = ["--run_dir", str(tmp_path), "--ws", "0", "1", "2", "--n", "40", "--ode_steps", "4",
            "--batch_size", "16"]
    monkeypatch.setattr(jmetrics, "_rng", np.random.default_rng(5))
    run_jax_script(monkeypatch, jscript, argv)
    want = yaml.safe_load(open(tmp_path / "guidance_sweep.yaml"))
    monkeypatch.setattr(pmetrics, "_rng", np.random.default_rng(5))
    got = pscript.main(argv + ["--device", "cpu"])
    assert yaml.safe_load(open(tmp_path / "guidance_sweep.yaml")) == got

    assert len(samples["jax"]) == len(samples["port"]) == 3
    assert got.keys() == want.keys() and got["ws"].keys() == want["ws"].keys() == {0.0, 1.0, 2.0}
    assert got["floor_real_mae"] == want["floor_real_mae"]
    for (w, row), gen_j, gen_p in zip(got["ws"].items(), samples["jax"], samples["port"]):
        np.testing.assert_allclose(gen_p, gen_j, atol=TOL)
        ref = want["ws"][w]
        assert row.keys() == ref.keys()
        m_p, m_j = pmetrics.jet_masses_from_rel(gen_p), pmetrics.jet_masses_from_rel(gen_j)
        gap_m = np.abs(m_p - m_j).max()
        mass = lambda g: pmetrics.jet_masses_from_rel(g)  # noqa: E731
        assert abs(row["cond_mae_mrel"] - ref["cond_mae_mrel"]) <= gap_m + 1e-7
        assert abs(row["w1m"] - ref["w1m"]) <= np.abs(mass(gen_p) - mass(gen_j)).max() + 1e-7
        assert abs(row["w1p"] - ref["w1p"]) <= np.abs(gen_p - gen_j).max() + 1e-7
        centred = m_j - m_j.mean()
        r_tol = 2 * np.linalg.norm((m_p - m_j) - (m_p - m_j).mean()) / np.linalg.norm(centred)
        assert abs(row["cond_pearson_r"] - ref["cond_pearson_r"]) <= r_tol + 1e-7
    # w = 1 samples the unguided drift, as in JAX
    assert samples["port_w"] == samples["jax_w"] == [0.0, None, 2.0]


JETCLASS_RUN = ["experiment=jetclass/jetclass_cond", "model.num_particles=12",
                "model.hidden_dim=16", "model.layers=2", "model.latent=4", "model.t_emb=sincos"]


@pytest.fixture(scope="module")
def jetclass_files(tmp_path_factory):
    """The JetClass splits as h5 files (13 particle features, all 10 types):
    the JAX datamodule reads files only."""
    from particle_fm_tpu_torch.data import jetclass as pjc

    d = tmp_path_factory.mktemp("jetclass")
    out = []
    for seed, (split, n) in enumerate((("train", 120), ("val", 60), ("test", 60))):
        path = str(d / f"{split}.h5")
        pjc.write_jetclass_h5(path, pjc.synthetic_jetclass_arrays(
            n, 12, num_types=10, seed=seed, additional_features=True))
        out.append(f"data.filename_dict.{split}={path}")
    return out


@pytest.mark.parametrize("gen_cond", [False, True], ids=["truth", "gen_conditioning"])
def test_jetclass_generation_matches_jax(tmp_path, monkeypatch, jetclass_files, gen_cond):
    from scripts import generate_jets_jetclass as jscript
    from scripts import torch_generate_jets_jetclass as pscript

    jax_run, port_run = run_pair(JETCLASS_RUN + jetclass_files, fill=0.1)
    if gen_cond:  # the generated-conditioning file's arrays, alike on both sides
        for dm in (jax_run[1], port_run[1]):
            dm.tensor_conditioning_gen = dm.tensor_conditioning_val[:30].copy()
            dm.mask_gen = dm.mask_val[:30].copy()
    pin(monkeypatch, jax_run, port_run, 0)
    extra = ["--use_gen_conditioning"] if gen_cond else []
    argv = ["--run_dir", str(tmp_path), "--n_samples", "40", "--ode_steps", "3",
            "--batch_size", "16"] + extra
    run_jax_script(monkeypatch, jscript, argv + ["--out", str(tmp_path / "jax.h5")])
    pscript.main(argv + ["--out", str(tmp_path / "port.h5"), "--device", "cpu"])
    with h5py.File(tmp_path / "jax.h5") as fj, h5py.File(tmp_path / "port.h5") as fp:
        assert sorted(fp) == sorted(fj) == ["conditioning", "part_features", "part_mask"]
        assert len(fp["part_features"]) == (30 if gen_cond else 40)
        np.testing.assert_allclose(fp["part_features"][:], fj["part_features"][:], atol=TOL)
        for key in ("part_mask", "conditioning"):
            np.testing.assert_array_equal(fp[key][:], fj[key][:])
        for key in fj:
            assert dict(fp[key].attrs).keys() == dict(fj[key].attrs).keys()
            for name, value in fj[key].attrs.items():
                np.testing.assert_array_equal(fp[key].attrs[name], value)
    for dm in (jax_run[1], port_run[1]):
        dm.tensor_conditioning_gen = None
    with pytest.raises(ValueError, match="generated-conditioning"):
        pscript.main(argv + ["--use_gen_conditioning", "--device", "cpu"])


def test_timing_study_builds_and_plots_as_jax(tmp_path, monkeypatch):
    from particle_fm_tpu.eval import plotting as jplot
    from particle_fm_tpu.models.flow_matching import FlowMatchingModel as JaxModel
    from scripts import timing_plots as jscript
    from scripts import torch_timing_plots as pscript

    built = []

    def fake_measure(entries, **kw):  # the JAX script's models, not its timings
        built.extend((n, m) for n, m, _ in entries)
        return [n for n, _, _ in entries], [1e-3] * len(entries)

    init = JaxModel.init
    monkeypatch.setattr(JaxModel, "init",
                        lambda self, rng: jax.eval_shape(lambda r: init(self, r), rng))
    monkeypatch.setattr(jplot, "measure_generation_timing", fake_measure)
    argv = ["--sizes", "4", "6", "--jets", "4", "--batch_size", "2", "--ode_steps", "2",
            "--hidden_dim", "8", "--layers", "1"]
    want = run_jax_script(monkeypatch, jscript, argv + ["--out", str(tmp_path / "jax.png")])
    got = pscript.main(argv + ["--out", str(tmp_path / "port.png"), "--device", "cpu"])
    assert got[0] == want[0] == [4, 6] and all(s > 0 for s in got[1])
    assert (tmp_path / "port.png").stat().st_size > 0
    entries = pscript.build_entries([4, 6], hidden_dim=8, layers=1, device="cpu")
    for (n, pm, net), (m, jm) in zip(entries, built):
        assert n == m and pm.num_particles == n
        for field in ("model", "features", "hidden_dim", "latent", "layers", "frequencies",
                      "t_emb", "loss_type", "global_cond_dim", "local_cond_dim"):
            assert getattr(pm, field) == getattr(jm, field), field
    with pytest.raises(ValueError, match="unconditioned EPiC"):
        from particle_fm_tpu_torch.utils import run_io as prun_io

        monkeypatch.setattr(prun_io, "load_run", lambda *a, **k: (None, None, entries[0][1]
                                                                   .__class__(global_cond_dim=2),
                                                                   entries[0][2]))
        pscript.build_entries([4], run_dir=str(tmp_path), device="cpu")
