"""PyTorch port, path C's bfloat16 statistics on the CPU: a narrow MDMA
(configs/model/flow_matching_mdma.yaml's architecture, the class token and 2
heads, 64 hits) sampled from the same numpy noise in float32 and bfloat16,
by the JAX package (op by op) and by the port, and per feature the mean and
std of the real hits in bfloat16 against float32, over the float32 std (the
statistic `chip_smoke.py` holds to BF16_STATS_LIMIT at NFE 100).

On the card path C read 0.0265 of the float32 std in the mean where the
other paths read 0.005 or less. Here the port's bfloat16 gap and JAX's are
the same to a few percent (JAX 0.0137, port 0.0136 in the largest mean
term): the gap is what bfloat16 does to this model, a property of the
type, not a fault of the port. The test holds the port's gap within 1.25
times JAX's plus 1e-3, and JAX's own gap above 1e-3, so that a port whose
bfloat16 path drifted from JAX's (or fell back to float32) fails.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.torch_port_helpers import MDMA_SMALL, bf16_triple, cloud, jax_noise, model_pair, t

HITS = 64
SETS = 16
STEPS = 11  # 20 network evaluations, midpoint
FILL = 0.2  # parameter scale: large enough that bfloat16 moves the samples measurably


def _stats(a16, a32, real):
    r16, r32 = a16[real], a32[real]
    std32 = r32.std(axis=0)
    return (np.abs(r16.mean(axis=0) - r32.mean(axis=0)) / std32,
            np.abs(r16.std(axis=0) - std32) / std32)


def test_path_c_bf16_statistics_match_jax_bf16():
    cfg = dict(MDMA_SMALL, num_particles=HITS, t_emb="sincos", frequencies=6,
               net_config=dict(MDMA_SMALL["net_config"], num_heads=2))
    jm, jm16, variables, pm16, net16 = bf16_triple(cfg, fill=FILL)
    _, _, pm32, net32 = model_pair(cfg, fill=FILL)
    _, mask, cond, _ = cloud(b=SETS, n=HITS, feats=cfg["features"], cond_dim=1, seed=2)
    mask[:, 5:] *= np.random.RandomState(3).rand(SETS, HITS - 5, 1) < 0.7  # ragged showers
    kw = dict(cond=jnp.asarray(cond), mask=jnp.asarray(mask), ode_steps=STEPS)
    with jax.disable_jit():
        j32, j16 = (np.asarray(m.sample(variables, jax.random.PRNGKey(3), **kw), np.float32)
                    for m in (jm, jm16))
    z = t(jax_noise(3, j32.shape, mask))
    with torch.no_grad():
        p32, p16 = (m.integrate(n, z, t(cond), t(mask), "midpoint", STEPS).numpy()
                    for m, n in ((pm32, net32), (pm16, net16)))
    real = mask[..., 0] > 0
    jax_mean, jax_std = _stats(j16, j32, real)
    port_mean, port_std = _stats(p16, p32, real)
    print(f"bf16 vs f32 over the f32 std, per feature: JAX mean {jax_mean} std {jax_std}; "
          f"port mean {port_mean} std {port_std}")
    np.testing.assert_allclose(p32, j32, atol=1e-4)  # the float32 paths agree
    assert jax_mean.max() > 1e-3  # bfloat16 moves this model measurably
    assert port_mean.max() <= 1.25 * jax_mean.max() + 1e-3
    assert port_std.max() <= 1.25 * jax_std.max() + 1e-3
