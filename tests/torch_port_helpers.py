"""Shared set-up of the tests that hold the PyTorch port against the JAX package.

Inputs are made from seeded numpy and handed to both sides; JAX parameters
are carried into the port with particle_fm_tpu_torch/utils/from_jax.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from particle_fm_tpu.models.flow_matching import FlowMatchingModel as JaxModel
from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel as PortModel
from particle_fm_tpu_torch.utils.from_jax import load_flax_params

# small stand-ins of the two flagship variants: the yaml flagship
# (configs/model/flow_matching.yaml: cosine time, t-cats on, time not added to
# the input) and __graft_entry__.py's (t-cats off, time added to the input)
SMALL = dict(features=3, num_particles=16, hidden_dim=32, latent=8, layers=2,
             frequencies=16, t_emb="cosine", loss_type="FM-OT",
             global_cond_dim=2, local_cond_dim=2)
YAML_FLAGSHIP = dict(SMALL, t_global_cat=True, t_local_cat=True, add_time_to_input=False)
GRAFT_FLAGSHIP = dict(SMALL, t_global_cat=False, t_local_cat=False, add_time_to_input=True)


def cloud(b=4, n=16, feats=3, cond_dim=2, seed=0):
    """Ragged numpy batch: x (B,N,F) masked, mask (B,N,1), cond (B,C), t (B,)."""
    rs = np.random.RandomState(seed)
    n_valid = rs.randint(3, n + 1, size=(b, 1))
    n_valid[0] = n  # one full set
    mask = (np.arange(n)[None, :] < n_valid).astype(np.float32)[..., None]
    x = rs.randn(b, n, feats).astype(np.float32) * mask
    cond = rs.randn(b, cond_dim).astype(np.float32)
    t = rs.rand(b).astype(np.float32)
    return x, mask, cond, t


def jax_cos_table(outp_dim: int) -> np.ndarray:
    """The cosine frequency table as the JAX package computes it outside jit."""
    return np.array(jnp.exp(jnp.arange(outp_dim, dtype=jnp.float32)))


def model_pair(cfg: dict, seed: int = 0):
    """(jax model, jax variables, port model, port network) with the JAX
    parameters carried across and the JAX cosine table in the port's buffer."""
    jm = JaxModel(**cfg)
    variables = jm.init(jax.random.PRNGKey(seed))
    pm = PortModel(**cfg)
    net = pm.init(seed=seed, device="cpu")
    load_flax_params(net, jax.device_get(variables["params"]))
    for flow in net.flows:
        if flow.t_emb == "cosine":
            flow.cos_freqs.copy_(torch.from_numpy(jax_cos_table(flow.cos_freqs.shape[0])))
    return jm, variables, pm, net


def jax_noise(seed: int, shape, mask=None) -> np.ndarray:
    """The noise FlowMatchingModel.sample draws from PRNGKey(seed): split,
    normal, mask."""
    rng_z, _ = jax.random.split(jax.random.PRNGKey(seed))
    z = np.asarray(jax.random.normal(rng_z, shape))
    return z if mask is None else z * mask


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())
