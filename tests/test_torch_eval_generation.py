"""PyTorch port, the batched generation driver
(particle_fm_tpu_torch/eval/generation.py::generate_data) held against the
JAX package's on a narrow flagship with carried JAX weights, given the same
noise: batch i of the port draws from a generator seeded with
`serving.chunk_seed(seed, i)`, and the test replaces that draw by the noise
the JAX driver draws for batch i (its key stream `random.split` of
PRNGKey(seed), then the sampler's own split). The JAX sampler runs op by op.
Covered: a ragged last batch padded with copies of its first row, masks
(in order and shuffled), fixed-size sets without a mask, the sigma-scaled
inverse z-score, the LHCO `pt_standardization` split (sigma 10 and 5),
`log_pt` and a scaler. Tolerance: atol 1e-4 in physical units.

The JAX driver writes into the array it copied from the device, which this
JAX returns read-only (`pt_standardization` and the scaler then raise), so
the test hands the JAX driver a numpy whose `asarray` copies.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from particle_fm_tpu.eval import generation as jgen
from particle_fm_tpu_torch.eval import generation as pgen
from particle_fm_tpu_torch.models import flow_matching as pfm
from particle_fm_tpu_torch.serving import chunk_seed
from tests.torch_port_helpers import (
    YAML_FLAGSHIP,
    WritableNumpy,
    cloud,
    jax_noise_of_batch,
    model_pair,
    t,
)

SEED = 4


class Affine:
    """A scaler with sklearn's inverse_transform (rows of features)."""

    def inverse_transform(self, x):
        return x * np.array([2.0, 0.5, 3.0]) - np.array([0.1, 0.2, -0.3])


CASES = {
    "ragged last batch, masks": dict(variable_set_sizes=True),
    "shuffled masks": dict(variable_set_sizes=True, shuffle_mask=True),
    "fixed size, no mask": dict(variable_set_sizes=False, num_points=16),
    "pt_standardization": dict(variable_set_sizes=True, pt_standardization=True),
    "log_pt": dict(variable_set_sizes=True, log_pt=True),
    "scaler": dict(variable_set_sizes=True, scaler=Affine(), normalized_data=False),
}


@pytest.fixture(scope="module")
def models():
    return model_pair(YAML_FLAGSHIP)


@pytest.mark.parametrize("case", CASES)
def test_generate_data_matches_jax(models, monkeypatch, case):
    jm, variables, pm, net = models
    n, bs = 5, 2
    _, mask, cond, _ = cloud(b=n, seed=8)
    kw = dict(dict(batch_size=bs, cond=cond, normalized_data=True, normalize_sigma=5.0,
                   means=np.array([0.05, -0.1, 0.2], np.float32),
                   stds=np.array([1.5, 0.5, 0.1], np.float32), ode_solver="midpoint",
                   ode_steps=3, seed=SEED), **CASES[case])
    if kw["variable_set_sizes"]:
        kw["mask"] = mask
    monkeypatch.setattr(jgen, "np", WritableNumpy())
    with jax.disable_jit():
        want, want_time = jgen.generate_data(jm, variables, n, **kw)

    batches = {chunk_seed(SEED, i): i for i in range(3)}
    drawn = []

    def noise_from_jax(generator, shape, device):
        i = batches[generator.initial_seed()]
        drawn.append(i)
        return t(jax_noise_of_batch(SEED, i, shape)).to(device)

    monkeypatch.setattr(pfm, "draw_noise", noise_from_jax)
    got, got_time = pgen.generate_data(pm, net, n, device="cpu", **kw)
    assert drawn == [0, 1, 2]
    assert got.shape == want.shape == (n, 16, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)
    if kw["variable_set_sizes"] and not kw.get("shuffle_mask"):
        assert (got[mask[..., 0] == 0] == 0).all()
    assert got_time > 0.0 and want_time > 0.0


def test_generation_raises_for_what_it_cannot_do(models, monkeypatch):
    _, _, pm, net = models
    with pytest.raises(ValueError, match="use mask"):
        pgen.generate_data(pm, net, 2, variable_set_sizes=True, device="cpu")
    with pytest.raises(ValueError, match="same length"):
        pgen.generate_data(pm, net, 3, mask=np.ones((2, 16, 1), np.float32), device="cpu")
    with pytest.raises(ValueError, match="network is on"):
        pgen.generate_data(pm, net, 2, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pgen.generate_data(pm, net, 2)


def test_generation_is_seeded_and_leaves_the_network_unfolded(models):
    _, _, pm, net = models
    before = [p.detach().clone() for p in net.parameters()]
    _, mask, cond, _ = cloud(b=3, seed=9)
    kw = dict(batch_size=2, cond=cond, mask=mask, variable_set_sizes=True, ode_steps=3,
              device="cpu")
    a, _ = pgen.generate_data(pm, net, 3, seed=1, **kw)
    b, _ = pgen.generate_data(pm, net, 3, seed=1, **kw)
    c, _ = pgen.generate_data(pm, net, 3, seed=2, **kw)
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c)
    assert not pfm.is_folded(net)
    for p, q in zip(net.parameters(), before):
        assert torch.equal(p, q)
