"""PyTorch port, the served artifact (particle_fm_tpu_torch/serving.py:
`export_sampler`, `save_exported`, `load_exported`) on the CPU, at a narrow
flagship (EPiC, 2 layers, midpoint `ode_steps=2`: one step, two evaluations):

- the loaded artifact gives what `make_serve_fn` gives for the same seeds,
  bit for bit (`torch.equal`), with and without cond, mask and guidance;
- given the same noise it holds against the JAX package's sampler
  (`make_serve_fn`/`serve_batches`, run op by op as
  tests/test_torch_port_serving.py runs it), atol 1e-4 in physical units;
- its meta.yaml has the JAX package's keys with the same values (platforms
  "cpu" on both), and `noise`;
- a fresh process loads and runs it with no module of the port's models,
  nets, config or training imported;
- em and the DOPRI5 solvers raise at export; a CUDA artifact raises where no
  card is present.

On the card: tests/test_torch_export_cuda.py.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from particle_fm_tpu import serving as jserving
from particle_fm_tpu_torch import serving as pserving
from tests.torch_port_helpers import YAML_FLAGSHIP, cloud, jax_noise, model_pair, t

ROOT = Path(__file__).resolve().parent.parent
BS, N = 3, 16
MEANS = np.array([0.1, -0.2, 0.3], np.float32)
STDS = np.array([1.5, 0.5, 2.0], np.float32)


@pytest.fixture(scope="module")
def pair():
    return model_pair(YAML_FLAGSHIP, fill=True)


@pytest.fixture(scope="module")
def uncond():
    from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel

    pm = FlowMatchingModel(**dict(YAML_FLAGSHIP, global_cond_dim=0, local_cond_dim=0))
    return pm, pm.init(seed=1, device="cpu")


def _export(pm, net, out_dir, cond=True, mask=True, guidance=None, solver="midpoint", steps=2):
    return pserving.export_sampler(
        pm, net, batch_size=BS, num_points=N, features=3, cond_dim=2 if cond else 0,
        use_mask=mask, ode_solver=solver, ode_steps=steps, means=MEANS, stds=STDS,
        guidance_scale=guidance, device="cpu", out_dir=str(out_dir))


@pytest.fixture(scope="module")
def artifact(pair, tmp_path_factory):
    """(directory, meta) of the conditional, masked artifact without guidance."""
    out = tmp_path_factory.mktemp("artifact")
    return out, _export(*pair[2:], out)[1]


@pytest.mark.parametrize("cond,mask,guidance", [
    (True, True, None), (False, True, None), (True, False, None), (True, True, 2.0)],
    ids=["cond_mask", "mask", "cond", "cond_mask_guidance"])
def test_artifact_is_make_serve_fn_bit_for_bit(pair, uncond, artifact, tmp_path, cond, mask,
                                               guidance):
    pm, net = pair[2:] if cond else uncond
    before = {k: v.clone() for k, v in net.state_dict().items()}
    if cond and mask and guidance is None:
        tmp_path, meta = artifact
    else:
        _, meta = _export(pm, net, tmp_path, cond, mask, guidance)
    assert all(torch.equal(before[k], v) for k, v in net.state_dict().items())
    fn, loaded_meta = pserving.load_exported(str(tmp_path))
    assert loaded_meta == meta
    live = pserving.make_serve_fn(pm, net, batch_size=BS, ode_solver="midpoint", ode_steps=2,
                                  has_cond=cond, has_mask=mask, means=MEANS, stds=STDS,
                                  guidance_scale=guidance)
    _, m, c, _ = cloud(b=5, n=N, seed=1)
    for seed in (0, 7, 2**40 + 3):
        args = [seed] + ([c[:BS]] if cond else []) + ([m[:BS]] if mask else [])
        got, want = fn(*args), live(*args)
        assert got.shape == (BS, N, 3) and torch.equal(got, want), seed
    kw = dict(cond=c if cond else None, mask=m if mask else None, seed=11)
    np.testing.assert_array_equal(pserving.serve_batches(fn, meta, 5, **kw),
                                  pserving.serve_batches(live, live.meta, 5, **kw))


def test_artifact_matches_jax_given_the_same_noise(pair, artifact, monkeypatch):
    jm, variables, _, _ = pair
    _, mask, cond, _ = cloud(b=5, n=N, seed=5)
    proto = dict(batch_size=BS, ode_solver="midpoint", ode_steps=2, has_cond=True,
                 has_mask=True, means=MEANS, stds=STDS, normalize_sigma=5.0)
    jfn = jserving.make_serve_fn(jm, variables, **proto)
    meta = {"batch_size": BS, "cond_dim": 2, "use_mask": True, "seed_scheme": "hash_v1"}
    with jax.disable_jit():
        ref = jserving.serve_batches(lambda s, c, m: jfn(jnp.uint32(s), c, m), meta, 5,
                                     cond=cond, mask=mask, seed=3)
    fn, pmeta = pserving.load_exported(str(artifact[0]))
    seeds = []

    def noise_from_jax(seed, shape, device):
        seeds.append(seed)
        return t(jax_noise(seed, shape)).to(device)

    monkeypatch.setattr(pserving, "prior_noise", noise_from_jax)
    out = pserving.serve_batches(fn, pmeta, 5, cond=cond, mask=mask, seed=3)
    assert out.shape == ref.shape == (5, N, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    assert (out[mask[..., 0] == 0] == 0).all()
    assert seeds == [pserving.chunk_seed(3, i) for i in range(2)]


def test_meta_has_the_jax_keys(pair, artifact):
    jm, variables, _, _ = pair
    tmp_path, pmeta = artifact
    _, jmeta = jserving.export_sampler(
        jm, variables, batch_size=BS, num_points=N, features=3, cond_dim=2, use_mask=True,
        ode_solver="midpoint", ode_steps=2, means=MEANS, stds=STDS)
    assert set(pmeta) - set(jmeta) == {"noise"}
    assert {k: pmeta[k] for k in jmeta} == jmeta
    assert pmeta["noise"]["shape"] == [BS, N, 3]
    with open(tmp_path / pserving.META_NAME) as f:
        assert yaml.safe_load(f) == pmeta
    assert (tmp_path / pserving.ARTIFACT_NAME).stat().st_size > 0


def test_artifact_loads_without_model_code(pair, artifact, tmp_path):
    _, _, pm, net = pair
    _, mask, cond, _ = cloud(b=BS, n=N, seed=2)
    live = pserving.make_serve_fn(pm, net, batch_size=BS, ode_solver="midpoint", ode_steps=2,
                                  has_cond=True, has_mask=True, means=MEANS, stds=STDS)
    np.save(tmp_path / "want.npy", live(5, cond, mask).numpy())
    np.savez(tmp_path / "req.npz", cond=cond, mask=mask)
    code = (
        "import sys, numpy as np, torch\n"
        "from particle_fm_tpu_torch import serving\n"
        f"fn, meta = serving.load_exported({str(artifact[0])!r})\n"
        f"d = np.load({str(tmp_path / 'req.npz')!r})\n"
        "x = fn(5, d['cond'], d['mask']).numpy()\n"
        "bad = [m for m in sys.modules if m.startswith(tuple('particle_fm_tpu_torch.' + p for p in "
        "('models', 'nets', 'config', 'training')))]\n"
        "assert not bad, bad\n"
        f"assert np.array_equal(x, np.load({str(tmp_path / 'want.npy')!r}))\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(ROOT)})


@pytest.mark.parametrize("solver", ["em", "dopri5", "dopri5_zuko", "dopri5_per_sample"])
def test_solvers_that_do_not_export_raise(pair, tmp_path, solver):
    _, _, pm, net = pair
    with pytest.raises(ValueError, match="does not export"):
        _export(pm, net, tmp_path, solver=solver)


def test_cuda_artifact_raises_without_a_card(artifact, tmp_path, monkeypatch):
    src, meta = artifact
    shutil.copy(src / pserving.ARTIFACT_NAME, tmp_path)
    with open(tmp_path / pserving.META_NAME, "w") as f:
        yaml.safe_dump(dict(meta, platforms=["cuda"]), f)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="does not run on the CPU"):
        pserving.load_exported(str(tmp_path))
