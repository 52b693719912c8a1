"""PyTorch port in bfloat16, `make_serve_fn`/`serve_batches` of the EPiC
flagship and the PC-Droid transformer held against the JAX package's
serving in bfloat16, with means/stds and a padded last batch, the JAX draw
for each per-batch seed: noise, cond, mask and the output float32.

The gate is the inequality |port_bf16 - jax_bf16| < |jax_bf16 - jax_f32|
(Frobenius norms over the batch; `bf16_gaps` in tests/torch_port_helpers.py):
the port in bfloat16 is closer to JAX in bfloat16 than JAX's own bfloat16 is
to its float32. A limit in bfloat16 ulps of the largest |x| would pass
whatever the port did, since the noise dominates x.
On samples the noise cancels in both differences, so the inequality is
the one on sample - noise. The JAX samplers run op by op
(`jax.disable_jit`): under jit XLA may keep excess precision inside fusions,
and its bfloat16 results are then another computation. The samplers run
with the sincos time embedding: the cosine one's frequencies reach e^31,
where cos rounds differently in the two frameworks at t = 1 (ROADMAP Queue
3). `sample` and serving fold the EPiC layers into the fused layer, which
in bfloat16 rounds where the Pallas kernel rounds (four times a layer),
while the JAX sampler runs the linen layers, which round after every Dense:
two bfloat16 computations of one function. That route is held to
`FOLDED_GAP` (1.5) times JAX's own bfloat16 gap, the unfolded module path
under the same solver to the strict inequality. Each test prints what it
measured.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_fm_tpu import serving as jserving
from particle_fm_tpu_torch import serving as pserving
from particle_fm_tpu_torch.models import flow_matching as pfm
from tests.torch_port_helpers import (FOLDED_GAP, YAML_FLAGSHIP, bf16_gaps, bf16_triple, cloud,
                                      droid_configs, jax_noise, t)


@pytest.mark.parametrize("name", ["epic_yaml", "transformer"])
def test_serve_batches_bf16_closer_to_jax_bf16_than_jax_is_to_f32(monkeypatch, name):
    cfg = YAML_FLAGSHIP if name == "epic_yaml" else droid_configs()["transformer"][0]
    jm, jm16, variables, pm16, net16 = bf16_triple(dict(cfg, t_emb="sincos", frequencies=6))
    n_req, bs = 3, 2
    _, mask, cond, _ = cloud(b=n_req, seed=5)
    proto = dict(batch_size=bs, ode_solver="midpoint", ode_steps=5, has_cond=True,
                 has_mask=True, means=np.array([0.1, -0.2, 0.3], np.float32),
                 stds=np.array([1.5, 0.5, 2.0], np.float32), normalize_sigma=5.0)
    meta = {"batch_size": bs, "cond_dim": 2, "use_mask": True, "seed_scheme": "hash_v1"}
    refs = []
    for m in (jm, jm16):
        jfn = jserving.make_serve_fn(m, variables, **proto)
        with jax.disable_jit():
            refs.append(jserving.serve_batches(lambda s, c, k: jfn(jnp.uint32(s), c, k), meta,
                                               n_req, cond=cond, mask=mask, seed=3))
    monkeypatch.setattr(pfm, "draw_noise", lambda generator, shape, device: t(
        jax_noise(generator.initial_seed(), shape)).to(device))
    pfn = pserving.make_serve_fn(pm16, net16, **proto)
    out = pserving.serve_batches(pfn, pfn.meta, n_req, cond=cond, mask=mask, seed=3)
    assert out.dtype == np.float32 and out.shape == (n_req, 16, 3)
    assert (out[mask[..., 0] == 0] == 0).all()
    ours, theirs = bf16_gaps(out, refs[1], refs[0], f"{name} serve_batches")
    assert ours < (FOLDED_GAP if name == "epic_yaml" else 1.0) * theirs
