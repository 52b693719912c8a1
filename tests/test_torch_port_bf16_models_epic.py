"""PyTorch port in bfloat16, whole models: the vector field of the EPiC
architectures (the flagship as configs/model/flow_matching.yaml and as
__graft_entry__.py lay it out, jetclass_cond's EPiC) held against the JAX
package in bfloat16 on the same numpy inputs and parameters, on the
unfolded module path. (tests/test_torch_port_bf16_models.py: the
transformers and MDMA.)

The gate is the inequality |port_bf16 - jax_bf16| < |jax_bf16 - jax_f32|
(Frobenius norms over the batch; `bf16_gaps` in tests/torch_port_helpers.py):
the port in bfloat16 is closer to JAX in bfloat16 than JAX's own bfloat16 is
to its float32. A limit in bfloat16 ulps of the largest |x| would pass
whatever the port did, since the noise dominates x. Each test prints what
it measured.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import (GRAFT_FLAGSHIP, JETCLASS_COND_SMALL, YAML_FLAGSHIP,
                                      bf16_gaps, bf16_triple, cloud, t)

ARCHS = {"epic_yaml": YAML_FLAGSHIP, "epic_graft": GRAFT_FLAGSHIP,
         "jetclass_cond": JETCLASS_COND_SMALL}


@pytest.mark.parametrize("name", list(ARCHS))
def test_epic_vector_field_bf16_closer_to_jax_bf16_than_jax_is_to_f32(name):
    jm, jm16, variables, pm16, net16 = bf16_triple(ARCHS[name])
    x, mask, cond, tt = cloud(b=4, n=pm16.num_particles, feats=pm16.features,
                              cond_dim=pm16.global_cond_dim, seed=1)
    jargs = (jnp.asarray(tt), jnp.asarray(x), jnp.asarray(cond), jnp.asarray(mask))
    ref32 = np.asarray(jm.vector_field(variables, *jargs), np.float32)
    ref16 = np.asarray(jm16.vector_field(variables, *jargs).astype(jnp.float32))
    with torch.no_grad():
        out = pm16.vector_field(net16, t(tt), t(x), t(cond), t(mask))
    assert out.dtype == torch.float32  # it ends in a product with the float32 mask, as in JAX
    ours, theirs = bf16_gaps(out.float().numpy(), ref16, ref32, f"{name} vector field")
    assert np.abs(ref32).max() > 0.1 and ours < theirs
