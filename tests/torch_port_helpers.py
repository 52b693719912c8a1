"""Shared set-up of the tests that hold the PyTorch port against the JAX package.

Inputs are made from seeded numpy and handed to both sides; JAX parameters
are carried into the port with particle_fm_tpu_torch/utils/from_jax.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from particle_fm_tpu.models import classifiers as jcls
from particle_fm_tpu.models.flow_matching import FlowMatchingModel as JaxModel
from particle_fm_tpu.nets import particlenet as jpn
from particle_fm_tpu_torch.models import classifiers as pcls
from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel as PortModel
from particle_fm_tpu_torch.nets import common as pcommon
from particle_fm_tpu_torch.nets import particlenet as ppn
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


def pin_draws_on_demand(monkeypatch, seed: int = 0) -> None:
    """Make both packages' losses draw t and the noise from numpy, each side
    from its own RandomState(seed) in the order and at the shapes the calls
    ask: the same arrays wherever both sides make the same calls (batches of
    varying shapes, as the bucketed CaloChallenge batches are)."""
    from particle_fm_tpu.losses import flow_matching as jloss
    from particle_fm_tpu_torch.losses import flow_matching as ploss

    def sides(to):
        rs = np.random.RandomState(seed)

        def sample_t(_rng, size, where):
            return to(rs.rand(*(size if isinstance(size, tuple) else (size,)))
                      .astype(np.float32), where)

        def normal(_rng, size, where):
            return to(rs.randn(*size).astype(np.float32), where)
        return sample_t, normal

    jt, jn = sides(lambda a, _: jnp.asarray(a))
    pt_, pn = sides(lambda a, dev: t(a).to(dev))
    monkeypatch.setattr(jloss, "_sample_t", jt)
    monkeypatch.setattr(jloss, "_normal", jn)
    monkeypatch.setattr(ploss, "_sample_t", pt_)
    monkeypatch.setattr(ploss, "_normal", pn)


# ---------------------------------------------------------------- bfloat16

# the folded EPiC layer rounds where the Pallas kernel rounds, the JAX
# sampler's linen layers after every Dense: two bfloat16 computations of one
# function, held to this multiple of JAX's own bfloat16-to-float32 gap
# (independent roundings add up to about sqrt(2) of one)
FOLDED_GAP = 1.5


def frob(a) -> float:
    """Frobenius norm, in float64."""
    return float(np.sqrt(np.sum(np.square(np.asarray(a, np.float64)))))


def bf16_gaps(port, jax16, jax32, name: str) -> tuple[float, float]:
    """(|port - jax16|, |jax16 - jax32|) in the Frobenius norm, printed with
    the max errors: the port in bfloat16 against JAX in bfloat16, and JAX's
    bfloat16 against its float32."""
    port, jax16, jax32 = (np.asarray(a, np.float32) for a in (port, jax16, jax32))
    ours, theirs = frob(port - jax16), frob(jax16 - jax32)
    print(f"{name}: |port-jax_bf16| {ours:.4g} (max {np.abs(port - jax16).max():.3g}), "
          f"|jax_bf16-jax_f32| {theirs:.4g} (max {np.abs(jax16 - jax32).max():.3g})")
    return ours, theirs


def bf16_triple(cfg: dict, fill=True, port_cfg: dict | None = None):
    """(JAX float32 model, JAX bfloat16 model, variables, port bfloat16 model,
    its network) with the same seeded parameters (`model_pair`'s `fill`) and
    the JAX cosine table; the port's parameters stay float32. `port_cfg`
    as in `model_pair`."""
    jm, variables, _, net = model_pair(cfg, fill=fill, port_cfg=port_cfg)
    jm16 = JaxModel(**dict(cfg, dtype="bfloat16"))
    pm16 = PortModel(**dict(port_cfg or cfg, dtype="bfloat16"))
    net16 = pm16.init(device="cpu")
    net16.load_state_dict(net.state_dict())
    for mine, theirs in zip(net16.flows, net.flows):
        mine.cos_freqs.copy_(theirs.cos_freqs)
    assert pm16.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in net16.parameters())
    return jm, jm16, variables, pm16, net16


# ---------------------------------------------------------------- bfloat16 training


def pin_bernoullis(monkeypatch, keep: np.ndarray | None = None,
                   use: np.ndarray | None = None) -> None:
    """Make both packages' losses take the cond-dropout draw `keep` (B, 1)
    (which sets keep their cond) and the self-conditioning draw `use`
    (B, 1, 1) from these boolean arrays: JAX's `jax.random.bernoulli` by the
    shape asked, the port's `_keep` and `_use_sc`."""
    from particle_fm_tpu_torch.models import flow_matching as pflow

    bernoulli = jax.random.bernoulli

    def jax_draw(key, p=0.5, shape=None):
        for a in (keep, use):
            if a is not None and tuple(shape or ()) == a.shape:
                return jnp.asarray(a)
        return bernoulli(key, p, shape)

    monkeypatch.setattr(jax.random, "bernoulli", jax_draw)
    if keep is not None:
        monkeypatch.setattr(pflow, "_keep",
                            lambda _g, p, shape, dev: torch.from_numpy(keep).to(dev))
    if use is not None:
        monkeypatch.setattr(pflow, "_use_sc", lambda _g, shape, dev: torch.from_numpy(use).to(dev))


def jax_loss_and_grads(monkeypatch, jm, params, batch, draw_kw: dict):
    """(loss, {port name: gradient}) of the JAX model's training loss, op by
    op (`jax.disable_jit`: under jit XLA keeps excess bfloat16 precision),
    with t and the noises pinned to `draws(**draw_kw)`."""
    pin_draws(monkeypatch, **draw_kw)
    x, mask, cond = (None if a is None else jnp.asarray(a) for a in batch)
    with jax.disable_jit():
        loss, grads = jax.value_and_grad(
            lambda p: jm.loss({"params": p}, jax.random.PRNGKey(0), x, mask, cond,
                              train=True)[0])(params)
    return float(loss), grads_by_name(grads)


def port_loss_and_grads(monkeypatch, pm, net, batch, draw_kw: dict):
    """The same for the port's model, checking that the loss and every
    gradient are float32 (float32 master weights, whatever the compute type)."""
    pin_draws(monkeypatch, **draw_kw)
    loss = pm.loss(net, torch.Generator(), *(None if a is None else t(a) for a in batch),
                   train=True)
    names = [n for n, _ in net.named_parameters()]
    grads = torch.autograd.grad(loss, list(net.parameters()), allow_unused=True,
                                materialize_grads=True)
    assert loss.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert all(g.dtype == torch.float32 for g in grads)
    return float(loss.detach()), {n: g.numpy() for n, g in zip(names, grads)}


# a gradient or parameter tensor with at least this many entries is gated on its own
GATED_SIZE = 1000


def hold_bf16(name: str, port, jax16, jax32, min_size: int = GATED_SIZE) -> None:
    """The bfloat16 gate on (loss, {name: tensor}) triples: the port's
    bfloat16 closer to JAX's bfloat16 than that is to JAX's float32 —
    |port - jax_bf16| < |jax_bf16 - jax_f32| in Frobenius norms — for the
    loss, for all tensors as one vector, and for every tensor of at least
    `min_size` entries."""
    (pl, pt_), (l16, t16), (l32, t32) = port, jax16, jax32
    assert sorted(pt_) == sorted(t16) == sorted(t32)
    ours, theirs = bf16_gaps(pl, l16, l32, f"{name} loss")
    assert ours < theirs, f"{name} loss"
    names = sorted(pt_)
    flat = [np.concatenate([np.ravel(d[n]) for n in names]) for d in (pt_, t16, t32)]
    ours, theirs = bf16_gaps(*flat, f"{name} all tensors")
    assert ours < theirs, f"{name} all tensors"
    gated = [n for n in names if np.size(pt_[n]) >= min_size]
    assert gated
    for n in gated:
        ours, theirs = bf16_gaps(pt_[n], t16[n], t32[n], f"{name} {n}")
        assert ours < theirs, f"{name} {n}"


def flax_layer_norm_rounds_once(monkeypatch) -> None:
    """Hand flax's LayerNorm its input cast to float32 once. The forward is
    the same bit for bit; under autodiff the input's cotangent is then
    rounded to bfloat16 once, as torch's LayerNorm backward (and the port's)
    rounds it, where flax on a bfloat16 input rounds two nearly cancelling
    parts of it first (`nets/common.py::LayerNorm`;
    tests/test_torch_train_bf16_layers.py pins the difference)."""
    import flax.linen as nn

    call = nn.LayerNorm.__call__

    def upcast_call(self, x, *args, **kwargs):
        return call(self, x.astype(jnp.promote_types(x.dtype, jnp.float32)), *args, **kwargs)

    monkeypatch.setattr(nn.LayerNorm, "__call__", upcast_call)


def jax_reductions_in_float32(monkeypatch) -> None:
    """Make JAX's op-by-op `reduce_sum` of a bfloat16 array accumulate in
    float32 and round once, as torch's sum does. Run op by op on the CPU,
    XLA adds bfloat16 elements one at a time, rounding after each; autodiff
    reduces in bfloat16 wherever a forward broadcast (a bias, the per-set
    segments of `WNDenseSplit`) is transposed, and the error of the
    one-at-a-time sums is as large as the whole bfloat16 computation's
    (tests/test_torch_train_bf16_layers.py pins the difference)."""
    from jax._src.lax import lax as jlax

    impl = jlax.reduce_sum_p.impl

    def float32_sum(x, **params):
        if x.dtype == jnp.bfloat16:
            return impl(x.astype(jnp.float32), **params).astype(jnp.bfloat16)
        return impl(x, **params)

    monkeypatch.setattr(jlax.reduce_sum_p, "impl", float32_sum)


def jax_packed_route(monkeypatch) -> None:
    """Send the JAX transformers' attn_impl=packed self-attention through the
    Pallas packed kernel in interpret mode (its custom VJP recomputing
    `_ref_math`), as its dispatcher does on a TPU; on the CPU it takes the
    einsum path."""
    from particle_fm_tpu.nets import transformer as jtrans
    from particle_fm_tpu.ops.pallas.short_attention import packed_short_attention

    dispatch = jtrans.attention

    def attention(q, k, v, kv_mask=None, attn_bias=None, impl="auto", scores_dtype=None):
        if impl == "packed" and q.shape[1] == k.shape[1]:
            return packed_short_attention(q, k, v, kv_mask, attn_bias, interpret=True)
        return dispatch(q, k, v, kv_mask, attn_bias, impl, scores_dtype)

    monkeypatch.setattr(jtrans, "attention", attention)


def check_bf16_step(monkeypatch, cfg: dict, b: int = 6, n_normals: int = 1, fill=True,
                    port_cfg: dict | None = None, keep=None, use=None, seed: int = 7) -> None:
    """One training loss and its gradients: the port in bfloat16 against JAX
    in bfloat16 and float32 from the same parameters, batch and pinned draws
    (`pin_bernoullis` for `keep` and `use`), under `hold_bf16`. JAX rounds
    where torch rounds in two places where its op-by-op arithmetic on the
    CPU rounds more often: its bfloat16 sums accumulate in float32
    (`jax_reductions_in_float32`) and its LayerNorm rounds its input's
    gradient once (`flax_layer_norm_rounds_once`)."""
    jax_reductions_in_float32(monkeypatch)
    flax_layer_norm_rounds_once(monkeypatch)
    jm, jm16, variables, pm16, net16 = bf16_triple(cfg, fill=fill, port_cfg=port_cfg)
    x, mask, cond, _ = cloud(b=b, n=pm16.num_particles, feats=pm16.features,
                             cond_dim=max(pm16.global_cond_dim, 1), seed=seed)
    batch = (x, mask, cond if pm16.conditioned else None)
    draw_kw = dict(b=b, shape=x.shape, n_normals=n_normals, steps=1, seed=seed + 1)
    pin_bernoullis(monkeypatch, keep, use)
    j32 = jax_loss_and_grads(monkeypatch, jm, variables["params"], batch, draw_kw)
    j16 = jax_loss_and_grads(monkeypatch, jm16, variables["params"], batch, draw_kw)
    port = port_loss_and_grads(monkeypatch, pm16, net16, batch, draw_kw)
    assert np.isfinite(port[0]) and max(np.abs(g).max() for g in port[1].values()) > 0
    hold_bf16(f"{cfg.get('model', 'epic')} {cfg.get('loss_type')}", port, j16, j32)


# ---------------------------------------------------------------- classifiers


def write_gen_vs_real_h5(directory, flat: bool, n: int = 160, parts: int = 16) -> list[str]:
    """real.h5 and gen.h5 (datasets x and, for sets, mask), the generated
    ones shifted; the overrides that point configs/data/classifier.yaml at
    them."""
    import h5py

    rs = np.random.RandomState(0)
    for name, shift in (("real", 0.0), ("gen", 0.3)):
        with h5py.File(directory / f"{name}.h5", "w") as f:
            if flat:
                f["x"] = (rs.randn(n, 4) + shift).astype(np.float32)
                continue
            counts = rs.randint(3, parts + 1, size=(n, 1))
            mask = (np.arange(parts)[None, :] < counts).astype(np.float32)[..., None]
            f["x"] = ((rs.randn(n, parts, 3) + shift) * mask).astype(np.float32)
            f["mask"] = mask
    return [f"data.real_file={directory / 'real.h5'}", f"data.gen_file={directory / 'gen.h5'}"]


CLASSIFIER_RTOL = 1e-5
CLASSIFIER_GRAD_TOL = 1e-5

# narrow stand-ins of the shipped classifier configs
CLASSIFIER_EPIC17 = dict(arch="epic", n_classes=1, num_particles=10, features=17,
                         net_config=dict(hid_dim=16, latent_dim=4, equiv_layers=2))
CLASSIFIER_CONFIGS = {
    "epic": CLASSIFIER_EPIC17,
    "epic_sup_sets": dict(arch="epic", n_classes=1, num_particles=10, features=3,
                          net_config=dict(hid_dim=16, latent_dim=4, equiv_layers=2,
                                          num_sup_sets=2)),
    "epic_two_logits": dict(arch="epic", n_classes=2, num_particles=10, features=3,
                            net_config=dict(hid_dim=16, latent_dim=4, equiv_layers=1)),
    "transformer": dict(arch="transformer", n_classes=3, num_particles=10, features=3,
                        net_config=dict(te_config={"model_dim": 16, "num_layers": 1,
                                                   "mha_config": {"num_heads": 4}})),
    "part": dict(arch="part", n_classes=2, num_particles=10, features=7,
                 net_config=dict(embed_dims=[16, 32, 16], num_heads=2, num_layers=2,
                                 num_cls_layers=1, pair_embed_dims=[8, 8])),
    "particlenet": dict(arch="particlenet", n_classes=2, num_particles=10, features=7,
                        net_config=dict(point_indices=[0, 1], conv_params=[[4, [8, 8]],
                                                                           [4, [16, 16]]],
                                        fc_params=[[16, 0.1]], use_fusion=False)),
}


def classifier_batch(cfg, b=8, seed=0, labels="binary"):
    """Ragged numpy (x, mask, labels) for a classifier config: labels
    "binary" (one per super-set event), "onehot" or integer ("int")."""
    rs = np.random.RandomState(seed)
    n, f = cfg["num_particles"], cfg["features"]
    counts = rs.randint(3, n + 1, size=(b, 1))
    mask = (np.arange(n)[None, :] < counts).astype(np.float32)[..., None]
    x = rs.randn(b, n, f).astype(np.float32) * 0.5 * mask
    if labels == "binary":
        y = rs.randint(0, 2, (b, 1)).astype(np.float32)
        s = cfg.get("net_config", {}).get("num_sup_sets", 1)
        y = np.repeat(y[::s], s, axis=0)  # one label per event
    elif labels == "onehot":
        y = np.eye(cfg["n_classes"], dtype=np.float32)[rs.randint(0, cfg["n_classes"], b)]
    else:
        y = rs.randint(0, cfg["n_classes"], (b, 1)).astype(np.float32)
    return x, mask, y


def classifier_pair(cfg, seed=0, scale=0.3):
    """(JAX model, its filled params, port model, port network carrying them)."""
    jm = jcls.SetClassifierModel(**cfg)
    params = filled(jm.init(jax.random.PRNGKey(seed))["params"], seed, scale)
    pm = pcls.SetClassifierModel(**cfg)
    net = pm.init(seed=seed, device="cpu")
    load_flax_params(net, params)
    return jm, params, pm, net


def pin_knn(monkeypatch, jm, params, x, mask):
    """Record JAX's neighbour indices of one forward pass and hand them to
    every forward pass of the port, in the same order."""
    seen = []
    orig = jpn.knn_indices
    monkeypatch.setattr(jpn, "knn_indices",
                        lambda p, m, k: seen.append(orig(p, m, k)) or seen[-1])
    jm.logits({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    monkeypatch.setattr(jpn, "knn_indices", orig)
    calls = iter(range(10**6))
    monkeypatch.setattr(ppn, "knn_indices", lambda p, m, k: torch.from_numpy(
        np.asarray(seen[next(calls) % len(seen)]).astype(np.int64)))


def pin_dropout(monkeypatch, seed=0):
    """Both packages' dropout masks from one numpy stream: JAX's
    `jax.random.bernoulli` (flax's Dropout draws there) hands out fresh
    numpy masks and records them; the port's `dropout_keep` replays them
    in order."""
    rs = np.random.RandomState(seed)
    masks = []

    def jax_bernoulli(key, p=0.5, shape=None):
        masks.append(rs.rand(*shape) < p)
        return jnp.asarray(masks[-1])

    monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)
    replay = iter(range(10**6))

    def port_keep(generator, keep, shape, device):
        m = masks[next(replay)]
        assert m.shape == tuple(shape)
        return torch.from_numpy(m).to(device)

    monkeypatch.setattr(pcommon, "dropout_keep", port_keep)
    return masks


def jax_classifier_loss_grads(jm, params, batch, train=False):
    x, mask, y = (jnp.asarray(a) for a in batch)
    loss, grads = jax.value_and_grad(
        lambda p: jm.loss({"params": p}, jax.random.PRNGKey(1), x, mask, y, train=train)[0]
    )(params)
    return float(loss), grads_by_name(grads)


def port_classifier_loss_grads(pm, net, batch, train=False):
    loss = pm.loss(net, torch.Generator().manual_seed(0), *(t(a) for a in batch), train=train)
    names = [n for n, _ in net.named_parameters()]
    grads = torch.autograd.grad(loss, list(net.parameters()), allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), {n: g.numpy() for n, g in zip(names, grads)}


def hold_loss_grads(port, ref):
    """Loss rtol CLASSIFIER_RTOL, every gradient within CLASSIFIER_GRAD_TOL
    of the largest."""
    (pl, pg), (jl, jg) = port, ref
    np.testing.assert_allclose(pl, jl, rtol=CLASSIFIER_RTOL)
    assert sorted(pg) == sorted(jg)
    scale = max(np.abs(g).max() for g in jg.values())
    assert scale > 0
    for name in jg:
        np.testing.assert_allclose(pg[name], jg[name], rtol=CLASSIFIER_RTOL,
                                   atol=CLASSIFIER_GRAD_TOL * scale, err_msg=name)
