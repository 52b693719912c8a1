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
# narrow stand-in of configs/experiment/jetclass/jetclass_cond.yaml on
# flow_matching.yaml: 13 features, cond 12 wide on the global MLPs only
JETCLASS_COND_SMALL = dict(YAML_FLAGSHIP, features=13, global_cond_dim=12, local_cond_dim=0)

# narrow stand-ins of configs/model/fm_droid_transformer.yaml and
# fm_droid_crossattention.yaml, zero-initialised layers included
_EMBD = dict(act_h="lrlu", nrm="layer")
_MHA = dict(num_heads=4, init_zeros=True, do_layer_norm=True)
_DENSE = dict(_EMBD, output_init_zeros=True)
_DROID = dict(features=3, num_particles=16, frequencies=16, t_emb="cosine", loss_type="FM-OT",
              add_time_to_input=True, global_cond_dim=2)


def droid_net_config(core: str, mha: dict | None = None, **core_cfg) -> dict:
    """net_config of a narrow droid model; `core` is te_config or cae_config."""
    return dict(
        node_embd_config=_EMBD, ctxt_embd_config=dict(_EMBD, outp_dim=12),
        outp_embd_config=dict(_EMBD, output_init_zeros=True),
        **{core: dict(model_dim=32, num_layers=2, mha_config=dict(_MHA, **(mha or {})),
                      dense_config=_DENSE, **core_cfg)},
    )


def droid_configs(jax_mha: dict | None = None, port_mha: dict | None = None, **overrides):
    """{name: (jax config, port config)} of the two droid models; the two
    sides may differ in `mha_config` (which attention each one runs)."""
    out = {}
    for name, model, core, extra in (
        ("transformer", "droid_fulltransformer", "te_config", {}),
        ("crossattention", "droid_fullcrossattention", "cae_config", {"num_tokens": 3}),
    ):
        base = dict(_DROID, model=model, **overrides)
        out[name] = (dict(base, net_config=droid_net_config(core, jax_mha, **extra)),
                     dict(base, net_config=droid_net_config(core, port_mha, **extra)))
    return out


# narrow stand-in of configs/experiment/calo/mdma_calo.yaml on
# configs/model/flow_matching_mdma.yaml
MDMA_SMALL = dict(model="mdma", features=4, num_particles=16, global_cond_dim=1, frequencies=16,
                  t_emb="cosine", add_time_to_input=False, loss_type="CFM",
                  net_config=dict(latent=8, hidden_dim=32, layers=2, num_heads=4, t_local_cat=True,
                                  t_global_cat=True, global_cond_dim=1))


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


def filled(params, seed: int = 0, scale: float = 0.3):
    """A flax parameter tree of the same structure with every leaf drawn from
    numpy: no leaf keeps a zero or one from its initialiser."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (rs.randn(*a.shape) * scale).astype(np.float32), jax.device_get(params))


def model_pair(cfg: dict, seed: int = 0, port_cfg: dict | None = None, fill: bool = False,
               norm_stats: dict | None = None):
    """(jax model, jax variables, port model, port network) with the JAX
    parameters carried across and the JAX cosine table in the port's buffer.
    `fill` replaces every JAX parameter by a seeded numpy draw first (True:
    of scale 0.3; a number: of that scale);
    `norm_stats` is the statistics collection of a model with normalisers."""
    jm = JaxModel(**cfg)
    variables = jm.init(jax.random.PRNGKey(seed))
    if fill:
        variables = {"params": filled(variables["params"], seed, 0.3 if fill is True else fill)}
    if norm_stats is not None:
        variables["norm_stats"] = norm_stats
    pm = PortModel(**(port_cfg or cfg))
    net = pm.init(seed=seed, device="cpu")
    load_flax_params(net, jax.device_get(variables["params"]), norm_stats)
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
