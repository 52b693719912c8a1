"""PyTorch port in bfloat16, the EPiC models' `sample` (4 midpoint steps)
held against the JAX package's bfloat16 `sample` on the same parameters and
noise: the flagship as configs/model/flow_matching.yaml and as
__graft_entry__.py lay it out, and jetclass_cond's EPiC.

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
import torch

from particle_fm_tpu_torch.samplers.ode import odeint_fixed
from tests.torch_port_helpers import (FOLDED_GAP, bf16_gaps, bf16_triple, cloud, jax_noise, t)

STEPS = 5  # ode_steps: 4 midpoint steps, 8 evaluations


def sample_against_jax(name: str, cfg: dict, folded: bool, fill=True):
    """`integrate` of the port's bfloat16 model from the JAX noise against
    JAX's bfloat16 and float32 `sample` (op by op); with `folded` (EPiC)
    also the unfolded module path under the same solver."""
    jm, jm16, variables, pm16, net16 = bf16_triple(dict(cfg, t_emb="sincos", frequencies=6),
                                                   fill=fill)
    _, mask, cond, _ = cloud(b=4, n=pm16.num_particles, feats=pm16.features,
                             cond_dim=pm16.global_cond_dim, seed=1)
    kw = dict(cond=jnp.asarray(cond), mask=jnp.asarray(mask), ode_steps=STEPS)
    with jax.disable_jit():
        ref32, ref16 = (np.asarray(m.sample(variables, jax.random.PRNGKey(3), **kw), np.float32)
                        for m in (jm, jm16))
    z = t(jax_noise(3, ref32.shape, mask))
    out = pm16.integrate(net16, z, t(cond), t(mask), "midpoint", STEPS)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    ours, theirs = bf16_gaps(out.numpy(), ref16, ref32, f"{name} sample (integrate)")
    assert ours < (FOLDED_GAP if folded else 1.0) * theirs
    if folded:
        with torch.no_grad():
            module = odeint_fixed(lambda tq, xq: net16(tq, xq, cond=t(cond), mask=t(mask)), z,
                                  1.0, 0.0, STEPS, "midpoint")
        ours, theirs = bf16_gaps(module.numpy(), ref16, ref32, f"{name} sample (module path)")
        assert ours < theirs


@pytest.mark.parametrize("name", ["epic_yaml", "epic_graft", "jetclass_cond"])
def test_epic_sample_bf16_closer_to_jax_bf16_than_jax_is_to_f32(name):
    from tests.torch_port_helpers import GRAFT_FLAGSHIP, JETCLASS_COND_SMALL, YAML_FLAGSHIP

    cfg = {"epic_yaml": YAML_FLAGSHIP, "epic_graft": GRAFT_FLAGSHIP,
           "jetclass_cond": JETCLASS_COND_SMALL}[name]
    sample_against_jax(name, cfg, folded=True)
