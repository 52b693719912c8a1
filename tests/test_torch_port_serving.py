"""PyTorch port, serving (particle_fm_tpu_torch/serving.py) held against the
JAX package's `make_serve_fn`/`serve_batches`, with means/stds and a padded
last batch, given the same noise: the port's noise draw is replaced by the
JAX draw for the same per-batch seed. The JAX sampler runs op by op (see
tests/test_torch_port_sampler.py). Tolerance: atol 1e-4 in physical units.

Also the package's isolation from JAX and the CUDA default of its entry
points.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu import serving as jserving
from particle_fm_tpu_torch import serving as pserving
from particle_fm_tpu_torch.models import flow_matching as pfm
from tests.torch_port_helpers import YAML_FLAGSHIP, cloud, jax_noise, model_pair, t

ROOT = Path(__file__).resolve().parent.parent


def test_serve_batches_matches_jax(monkeypatch):
    jm, variables, pm, net = model_pair(YAML_FLAGSHIP)
    n_req, bs = 5, 2
    _, mask, cond, _ = cloud(b=n_req, seed=5)
    means = np.array([0.1, -0.2, 0.3], np.float32)
    stds = np.array([1.5, 0.5, 2.0], np.float32)
    proto = dict(batch_size=bs, ode_solver="midpoint", ode_steps=3, has_cond=True,
                 has_mask=True, means=means, stds=stds, normalize_sigma=5.0)

    jfn = jserving.make_serve_fn(jm, variables, **proto)
    meta = {"batch_size": bs, "cond_dim": 2, "use_mask": True, "seed_scheme": "hash_v1"}
    with jax.disable_jit():
        ref = jserving.serve_batches(lambda s, c, m: jfn(jnp.uint32(s), c, m), meta, n_req,
                                     cond=cond, mask=mask, seed=3)

    seeds = []

    def noise_from_jax(generator, shape, device):
        seeds.append(generator.initial_seed())
        return t(jax_noise(generator.initial_seed(), shape)).to(device)

    monkeypatch.setattr(pfm, "draw_noise", noise_from_jax)
    pfn = pserving.make_serve_fn(pm, net, **proto)
    assert {k: pfn.meta[k] for k in meta} == meta
    out = pserving.serve_batches(pfn, pfn.meta, n_req, cond=cond, mask=mask, seed=3)

    assert out.shape == ref.shape == (n_req, 16, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    assert (out[mask[..., 0] == 0] == 0).all()
    assert seeds == [pserving.chunk_seed(3, i) for i in range(3)]


def test_chunk_seeds_match_jax_scheme():
    seen = []
    meta = {"batch_size": 1, "seed_scheme": "hash_v1"}
    jserving.serve_batches(lambda s: seen.append(int(s)) or np.zeros((1, 1)), meta, 3, seed=9)
    assert seen == [pserving.chunk_seed(9, i) for i in range(3)]
    for scheme in ("add_v0", "nope"):  # the legacy scheme has no artifact to serve here
        with pytest.raises(ValueError):
            pserving.chunk_seed(0, 0, scheme)


def test_guidance_needs_cond():
    _, _, pm, net = model_pair(YAML_FLAGSHIP)
    with pytest.raises(ValueError, match="guidance"):
        pserving.make_serve_fn(pm, net, batch_size=2, guidance_scale=2.0)


def test_package_imports_without_jax():
    code = (
        "import sys, particle_fm_tpu_torch, particle_fm_tpu_torch.serving, "
        "particle_fm_tpu_torch.models.flow_matching, particle_fm_tpu_torch.utils.from_jax\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax', 'optax'))"
        " or m == 'particle_fm_tpu' or m.startswith('particle_fm_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_package_source_names_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|particle_fm_tpu)(\.|\s|$)", re.M)
    for path in (ROOT / "particle_fm_tpu_torch").rglob("*.py"):
        assert not pattern.search(path.read_text()), path


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pm = pfm.FlowMatchingModel(hidden_dim=8, latent=4, layers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pm.init()
    assert next(pm.init(device="cpu").parameters()).device.type == "cpu"
