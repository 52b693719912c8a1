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


def jax_noise_of_batch(seed: int, i: int, shape) -> np.ndarray:
    """The noise the JAX `generate_data` draws for batch i: the i-th key of
    `random.split` from PRNGKey(seed), then the sampler's own split."""
    rng = jax.random.PRNGKey(seed)
    for _ in range(i + 1):
        rng, sub = jax.random.split(rng)
    rng_z, _ = jax.random.split(sub)
    return np.asarray(jax.random.normal(rng_z, shape))


class WritableNumpy:
    """numpy, with an `asarray` that returns a writable copy (the JAX
    `generate_data` writes into the array it copied from the device)."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def asarray(a, *args, **kwargs):
        return np.array(a, *args, **kwargs)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def draws(b: int, shape, n_normals: int, steps: int, seed: int = 0):
    """Numpy draws for `steps` loss calls: (ts, zs), one t of (b,) and
    `n_normals` noise arrays of `shape` per call."""
    rs = np.random.RandomState(seed)
    ts, zs = [], []
    for _ in range(steps):
        ts.append(rs.rand(b).astype(np.float32))
        zs.extend(rs.randn(*shape).astype(np.float32) for _ in range(n_normals))
    return ts, zs


def pin_draws(monkeypatch, ts=None, zs=None, **draw_kw):
    """Make both packages' losses replay the same t and noise arrays, call
    after call (`_sample_t`/`_normal` of both loss modules); with `draw_kw`,
    the arrays come from `draws(**draw_kw)`. Returns (ts, zs)."""
    from particle_fm_tpu.losses import flow_matching as jloss
    from particle_fm_tpu_torch.losses import flow_matching as ploss

    if draw_kw:
        ts, zs = draws(**draw_kw)

    def replay(arrays, to):
        queue = iter(arrays)

        def draw(_rng, size, _where):
            a = next(queue)
            assert tuple(np.shape(a)) == tuple(size if isinstance(size, tuple) else (size,)), size
            return to(a, _where)
        return draw

    monkeypatch.setattr(jloss, "_sample_t", replay(ts, lambda a, _: jnp.asarray(a)))
    monkeypatch.setattr(jloss, "_normal", replay(zs, lambda a, _: jnp.asarray(a)))
    monkeypatch.setattr(ploss, "_sample_t", replay(ts, lambda a, dev: t(a).to(dev)))
    monkeypatch.setattr(ploss, "_normal", replay(zs, lambda a, dev: t(a).to(dev)))
    return ts, zs


def grads_by_name(flax_tree) -> dict[str, np.ndarray]:
    """A params-shaped flax tree (gradients, Adam moments) under the port's
    parameter names and layouts."""
    from particle_fm_tpu_torch.utils.from_jax import state_dict_from_flax

    return {k: v.numpy() for k, v in state_dict_from_flax(jax.device_get(flax_tree)).items()}


def jax_sde_noise(seed: int, shape, n_steps: int) -> list[np.ndarray]:
    """The per-step noise FlowMatchingModel.sample's Euler-Maruyama draws
    from PRNGKey(seed): the second key of the sampler's split, then one
    `split` a step."""
    _, key = jax.random.split(jax.random.PRNGKey(seed))
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape)))
    return out


def pin_sde_noise(monkeypatch, arrays) -> None:
    """Make the port's Euler-Maruyama replay `arrays`, one a step."""
    from particle_fm_tpu_torch.samplers import sde as psde

    queue = iter(arrays)

    def draw(_gen, shape, device):
        a = next(queue)
        assert tuple(a.shape) == tuple(shape)
        return t(a).to(device)

    monkeypatch.setattr(psde, "_normal", draw)


def pin_self_cond(monkeypatch, use: np.ndarray) -> None:
    """Make both packages' self-conditioned losses hand the estimate to the
    sets of the boolean array `use` (B, 1, 1): the port's `_use_sc` and the
    JAX loss's `jax.random.bernoulli(rng, 0.5, (B, 1, 1))`."""
    from particle_fm_tpu_torch.models import flow_matching as pflow

    bernoulli = jax.random.bernoulli

    def jax_draw(key, p=0.5, shape=None):
        if p == 0.5 and tuple(shape or ()) == use.shape:
            return jnp.asarray(use)
        return bernoulli(key, p, shape)

    monkeypatch.setattr(jax.random, "bernoulli", jax_draw)
    monkeypatch.setattr(pflow, "_use_sc", lambda _g, shape, dev: torch.from_numpy(use).to(dev))
