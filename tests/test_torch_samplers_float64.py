"""PyTorch port, the per-set adaptive DOPRI5 (samplers/ode.py::
odeint_dopri5_per_sample) in float64 on the CPU: a float64 state and field
stay float64 through every stage of every step (the times handed to the
field included), and the steps each set takes and its result are those of
the JAX package's loop run in float64 (`jax.enable_x64`) on that set alone,
what its vmap computes lane by lane.

In float64 the JAX loop starts t and dt in the state's dtype (its
coefficients stay the float32 arrays made at import, promoted); a time
handed to the field in float32, as the port's loop did before, moves the
result by 1.5e-10 at rtol 1e-4. Tolerances: steps equal, results within
1e-12.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.samplers import ode as jode
from particle_fm_tpu_torch.samplers import ode as pode

RATES = np.array([1.0, 30.0, 90.0])


def _jax_field(tt, x):
    return jnp.asarray(RATES) * x + 0.3 * jnp.sin(3.0 * tt) * x[..., ::-1]


def _port_field(seen):
    def f(tt, x):
        seen.append((tt.dtype, x.dtype))
        tt = tt.reshape(tt.shape + (1,) * (x.ndim - tt.ndim))
        return torch.as_tensor(RATES) * x + 0.3 * torch.sin(3.0 * tt) * x.flip(-1)
    return f


@pytest.mark.parametrize("rtol", [1e-4, 1e-7])
def test_dopri5_per_sample_stays_float64_and_matches_jax_x64(rtol):
    x0 = np.random.RandomState(5).randn(4, 2, 3)
    x0[1] *= 1e-3  # an easy set: fewer steps
    seen = []
    out, st = pode.odeint_dopri5_per_sample(_port_field(seen), torch.from_numpy(x0), 1.0, 0.0,
                                            rtol=rtol, atol=rtol, return_stats=True)
    assert out.dtype == torch.float64
    assert seen and set(seen) == {(torch.float64, torch.float64)}
    with jax.enable_x64(True):
        ref = jax.vmap(lambda x: jode.odeint_dopri5(_jax_field, x, 1.0, 0.0, rtol=rtol, atol=rtol,
                                                    warn_on_truncation=False))(jnp.asarray(x0))
        steps = [int(jode.odeint_dopri5(_jax_field, jnp.asarray(x0[i]), 1.0, 0.0, rtol=rtol,
                                        atol=rtol, return_stats=True)[1]["steps"])
                 for i in range(len(x0))]
        assert ref.dtype == jnp.float64
        ref = np.asarray(ref)
    assert st["steps"].tolist() == steps and len(set(steps)) > 1
    assert bool(st["reached"].all())
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12)
