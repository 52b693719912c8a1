"""FlowMatchingModel; counterpart of particle_fm_tpu/models/flow_matching.py.

The port trains and samples all five loss families of the JAX package
(FM-OT, CFM, CFM-OT, PC-JeDi VP-diffusion, PC-Droid with its VE prior
`droid_t_max`) and reflow's loss, with self-conditioning and
classifier-free guidance, in float32. As in the JAX package the model is a
configuration bundle that takes every field of the shipped model configs:
`init` builds the network (a `CNFStack` module on the requested device),
`loss` is the masked training and validation loss on the unfolded network,
`sample` folds weight norm once, draws masked noise from a
`torch.Generator` and integrates from t=1 to 0 with any of the JAX
package's solvers (the fixed-step ones, `dopri5`/`dopri5_zuko`,
`dopri5_per_sample`, and for diffusion `em`/`ddim`), and `log_prob` is the
density by the augmented ODE. A field raises only where its value asks for
what the port lacks (a `dtype` other than float32 and bfloat16).
`dropout` builds the EPiC encoder's dropout, which the loss does not draw:
the JAX model's loss applies its network deterministic, and so does the
port's.

`dtype` is the networks' compute type, as in the JAX package: None or
"float32" computes in float32; "bfloat16" (or `torch.bfloat16`; from a
config `model.dtype=bfloat16`) keeps the parameters in float32 and computes
every Dense and LayerNorm, and the kernels, in bfloat16, while the time
embedding, the solver's state, the noise, cond and mask stay float32.
`sample`, `integrate`, serving and `loss` run in it. In training the loss
runs the unfolded bfloat16 network on the float32 parameters: t, the noises,
cond, the mask and the targets stay float32, the bfloat16 field meets the
float32 target by type promotion (the transformers end in a bfloat16 Dense,
EPiC and MDMA in a product with the float32 mask), and autograd through the
casts hands every parameter a float32 gradient, so that clipping, AdamW and
the EMA run in float32 as in the JAX package.

`integrate` takes the starting point `z` explicitly (the prior draw, scaled
by `droid_t_max` for droid and masked), so a test can hand it the noise the
JAX package drew; Euler-Maruyama draws its per-step noise from the
`generator` it is given, after `sample` has drawn z from it.

Data parallelism (parallel/dist.py): `loss(..., shard=...)` computes this
rank's share of the global batch's loss (every draw made for the global
batch and sliced, the normalisers' statistics and the mask count summed
over the ranks), and `sample(..., rank_split=True)` integrates this rank's
rows of the global noise and gathers every rank's, which equals sampling
the whole batch in one process. Under sequence parallelism (a shard with
`seq`, trainer.strategy=sp) the loss keeps this rank's part of every set's
particles (a mask of ones made first where none is given, the last ranks
padded with masked particles) and runs the network inside
`parallel/mesh.py::sequence_parallel`; the cond normaliser's statistics are
summed over the data group only, since every model rank holds the same
sets.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch
from torch import nn

from particle_fm_tpu_torch.losses.diffusion import VPDiffusionSchedule
from particle_fm_tpu_torch.losses.flow_matching import CRITERIA, get_loss_fn
from particle_fm_tpu_torch.models.cnf import CNFStack
from particle_fm_tpu_torch.nets.common import WNDense, check_compute_dtype
from particle_fm_tpu_torch.nets.epic import EPiCLayer
from particle_fm_tpu_torch.ops.attention import forward_mode_ad
from particle_fm_tpu_torch.parallel import dist
from particle_fm_tpu_torch.parallel.dist import BatchShard, local_draw
from particle_fm_tpu_torch.parallel.mesh import ROADMAP_ITEM, sequence_parallel
from particle_fm_tpu_torch.samplers.ode import (FIXED_SOLVERS, odeint_dopri5,
                                                odeint_dopri5_per_sample, odeint_fixed,
                                                odeint_fixed_sc)
from particle_fm_tpu_torch.samplers.sde import ddim_sampler, euler_maruyama_sampler
from particle_fm_tpu_torch.utils.device import resolve_device

SOLVERS = FIXED_SOLVERS + ("dopri5", "dopri5_zuko", "dopri5_per_sample", "em", "ddim")


_DTYPE_NAMES = {"float32": None, "bfloat16": torch.bfloat16}


def compute_dtype(dtype) -> torch.dtype | None:
    """A model's `dtype` (None, a name such as "bfloat16" or "jnp.bfloat16",
    or a torch dtype) as the networks' compute type: None for float32,
    else torch.bfloat16; another type raises."""
    if dtype is None or dtype == torch.float32:
        return None
    if isinstance(dtype, str):
        name = dtype.rsplit(".", 1)[-1]
        if name not in _DTYPE_NAMES:
            raise NotImplementedError(
                f"dtype={dtype} is not ported: the port computes in float32 or bfloat16")
        return _DTYPE_NAMES[name]
    check_compute_dtype(dtype)
    return dtype


def draw_noise(generator: torch.Generator, shape: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """Standard normal noise for the sampler's starting point."""
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


def _keep(generator: torch.Generator, p: float, shape: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """Bernoulli(p) draw: which sets keep their cond under cond_dropout."""
    return torch.rand(shape, generator=generator, device=device) < p


def _use_sc(generator: torch.Generator, shape: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """Bernoulli(0.5) draw: which sets the trained pass of self-conditioning
    hands their endpoint estimate."""
    return torch.rand(shape, generator=generator, device=device) < 0.5


def _per_set(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A schedule value of a scalar time as is; of per-set times (B,) as (B, 1, ..., 1)."""
    return a.reshape(a.shape + (1,) * (x.ndim - a.ndim)) if a.ndim else a


def is_folded(net: nn.Module) -> bool:
    """Whether weight norm is folded into `net` (between `fold_weight_norm`
    and `unfold_weight_norm`)."""
    return any(
        (isinstance(m, WNDense) and m._folded is not None)
        or (isinstance(m, EPiCLayer) and m._kernel_weights is not None)
        for m in net.modules()
    )


@dataclasses.dataclass(eq=False)
class FlowMatchingModel:
    """Configuration bundle for CNF sampling on particle sets (field names as
    in the JAX FlowMatchingModel)."""

    model: str = "epic"
    features: int = 3
    num_particles: int = 150
    frequencies: int = 6
    hidden_dim: int = 128
    layers: int = 8
    n_transforms: int = 1
    activation: str = "leaky_relu"
    use_weight_norm: bool = True
    latent: int = 16
    t_local_cat: bool = False
    t_global_cat: bool = False
    add_time_to_input: bool = True
    global_cond_dim: int = 0
    local_cond_dim: int = 0
    dropout: float = 0.0
    sum_scale: float = 1e-2
    loss_type: str = "FM-OT"
    sigma: float = 1e-4
    t_emb: str = "sincos"
    diff_config: Mapping[str, Any] = dataclasses.field(
        default_factory=lambda: {"max_sr": 1.0, "min_sr": 1e-8}
    )
    criterion: str = "mse"
    droid_t_max: float = 1.0
    ot_config: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    use_normaliser: bool = False
    normaliser_config: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    self_cond: bool = False
    cond_dropout: float = 0.0
    net_config: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    dtype: Any = None

    def __post_init__(self):
        if self.self_cond:
            if self.loss_type not in ("FM-OT", "CFM", "CFM-OT", "droid"):
                raise ValueError(
                    "self_cond requires a linear-path loss (FM-OT/CFM/CFM-OT/"
                    f"droid) where x1_hat = y - t*v, got {self.loss_type}"
                )
            if self.n_transforms != 1:
                raise ValueError("self_cond supports n_transforms=1")
        self.compute_dtype = compute_dtype(self.dtype)
        if self.criterion not in CRITERIA:
            raise ValueError(f"criterion {self.criterion} not supported")
        self._loss_fn = get_loss_fn(
            self.loss_type, sigma=self.sigma, criterion=self.criterion,
            diff_config=dict(self.diff_config), ot_config=dict(self.ot_config),
            droid_t_max=self.droid_t_max,
        )
        self.conditioned = self.global_cond_dim > 0

    def init(self, seed: int = 0, device: str | torch.device = "cuda") -> CNFStack:
        """The network, with torch-Linear init drawn from `seed`, on `device`."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        net = CNFStack(
            n_transforms=self.n_transforms,
            features=self.features,
            global_cond_dim=self.global_cond_dim,
            use_normaliser=self.use_normaliser,
            normaliser_config=dict(self.normaliser_config),
            generator=gen,
            model=self.model,
            frequencies=self.frequencies,
            hidden_dim=self.hidden_dim,
            layers=self.layers,
            local_cond_dim=self.local_cond_dim,
            latent=self.latent,
            activation=self.activation,
            use_weight_norm=self.use_weight_norm,
            t_local_cat=self.t_local_cat,
            t_global_cat=self.t_global_cat,
            add_time_to_input=self.add_time_to_input,
            t_emb=self.t_emb,
            sum_scale=self.sum_scale,
            dropout=self.dropout,
            net_config=dict(self.net_config),
            self_cond=self.self_cond,
            dtype=self.compute_dtype,
        )
        return net.to(dev).eval()

    @staticmethod
    def fold_weight_norm(net: nn.Module) -> None:
        """Fold w = g * v / ||v|| into every weight once, and cut the EPiC
        layers' weights for the fused layer. `unfold_weight_norm` undoes it.
        The transformer networks and MDMA have no weight norm: nothing changes
        there."""
        for m in net.modules():
            if isinstance(m, (WNDense, EPiCLayer)):
                m.fold()

    @staticmethod
    def unfold_weight_norm(net: nn.Module) -> None:
        for m in net.modules():
            if isinstance(m, (WNDense, EPiCLayer)):
                m.unfold()

    def vector_field(self, net: CNFStack, t, x, cond=None, mask=None) -> torch.Tensor:
        return net(t, x, cond=cond, mask=mask)

    def loss_reads_host(self) -> bool:
        """Whether the training loss reads values back to the host (OT-CFM's
        exact pairing solves each batch's assignment with scipy): such a
        step cannot run inside a captured CUDA graph."""
        return self.loss_type == "CFM-OT" and dict(self.ot_config).get("ot_method") == "exact"

    def loss_accum_weight(self, x: torch.Tensor, mask: torch.Tensor | None,
                          shard: BatchShard | None = None) -> torch.Tensor:
        """Gradient-accumulation weight of one microbatch: its loss
        normalisation mass (of the global microbatch, with a `shard`), so
        that weighted microbatch gradients add up to the big-batch gradient."""
        if mask is None:
            w = torch.full((), float(x.shape[0] * x.shape[1]), device=x.device)
        else:
            w = torch.sum(mask).to(torch.float32)
        return w if shard is None else shard.rows_shard().total(w)

    def loss(
        self,
        net: CNFStack,
        generator: torch.Generator,
        x: torch.Tensor,
        mask: torch.Tensor | None = None,
        cond: torch.Tensor | None = None,
        train: bool = False,
        shard: BatchShard | None = None,
        field=None,
    ) -> torch.Tensor:
        """Masked training (`train=True`) or validation loss of the unfolded
        network, with every draw from `generator`. With `use_normaliser`, x
        and cond are normalised in the model; in training the normalisers'
        statistics are updated from this batch first. In training,
        `cond_dropout` sets whole sets' cond to the null token (zeros),
        drawn first. With `self_cond` the field is the two-pass one: a pass
        without gradient gives the endpoint estimate x1_hat = y - tm*t*v
        (tm = droid_t_max for droid, else 1), masked, which the trained pass
        reads for a Bernoulli(0.5) half of the sets (drawn next), zeros for
        the others. Then t and the noises, as the loss family draws them.
        With a `shard`, x is this rank's rows and the loss is its share of the
        global batch's (module docstring). `field(t, y, cond=, mask=)`
        replaces the network's forward (the pipelined field of
        parallel/pp.py, JAX's `vf_fn`); the normalisers are still `net`'s."""
        if field is not None and self.self_cond:
            raise ValueError("self_cond is not supported with a vf_fn override (pp)")
        if is_folded(net):
            raise RuntimeError(
                "loss needs the unfolded network: folded weights carry no gradient to "
                "weight norm's v and g (call unfold_weight_norm first)"
            )
        if shard is not None and shard.seq is not None:
            if self.loss_type == "CFM-OT":
                raise NotImplementedError(
                    f"trainer.strategy='sp' with CFM-OT is not ported ({ROADMAP_ITEM}): the "
                    "pairing couples each set's particles across the split")
            if mask is None:
                mask = torch.ones_like(x[..., :1])
            n = x.shape[1]
            shard = shard.at_particles(n)
            # the padding slots' field is dropped (a transformer's is not masked)
            real = shard.local_particles(torch.ones_like(x[:1, :, :1]))
            x, mask = shard.local_particles(x), shard.local_particles(mask)
            with sequence_parallel(shard.seq):
                return self._loss(net, generator, x, mask, cond, train, shard,
                                  lambda *a, **k: net(*a, **k) * real)
        return self._loss(net, generator, x, mask, cond, train, shard,
                          net if field is None else field)

    def _loss(self, net, generator, x, mask, cond, train, shard, field):
        """`loss` on these rows and particles; `field` is the network's
        forward (the normalisers are read from `net`)."""
        if self.use_normaliser:
            # in training the statistics are updated first (x's, then cond's) and
            # each input normalised with what its layer has just learned
            x = net.normalise(x, mask, update_stats=train, shard=shard)
            if self.conditioned and cond is not None:
                cond = net.normalise_cond(cond, update_stats=train,
                                          shard=None if shard is None else shard.rows_shard())
        if train and self.cond_dropout > 0.0 and self.conditioned and cond is not None:
            keep = local_draw(shard, lambda g, shape, dev: _keep(g, 1.0 - self.cond_dropout,
                                                                 shape, dev),
                              generator, (cond.shape[0], 1), cond.device)
            cond = torch.where(keep, cond, torch.zeros_like(cond))
        if not self.self_cond:
            return self._loss_fn(lambda t, y, c, m: field(t, y, cond=c, mask=m), generator, x,
                                 mask, cond, shard=shard)
        use = local_draw(shard, _use_sc, generator, (x.shape[0], 1, 1), x.device)
        sc_tm = self.droid_t_max if self.loss_type == "droid" else 1.0

        def vf(t, y, c, m):
            with torch.no_grad():
                x1_hat = y - sc_tm * t[:, None, None] * field(t, y, cond=c, mask=m)
                if m is not None:
                    x1_hat = x1_hat * m
            return field(t, y, cond=c, mask=m, x_sc=torch.where(use, x1_hat, 0.0))

        return self._loss_fn(vf, generator, x, mask, cond, shard=shard)

    def log_prob(
        self,
        net: CNFStack,
        x: torch.Tensor,
        cond: torch.Tensor | None = None,
        mask: torch.Tensor | None = None,
        ode_steps: int = 100,
        exact: bool = True,
        generator: torch.Generator | None = None,
        eps: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """log p(x) (B,) by the augmented ODE: (x, log-det) integrated with
        the midpoint rule from t=0 (data) to t=1 (prior), each flow in turn
        from flow 0, with the divergence of the drift (for diffusion the
        probability-flow drift) accumulated, then the standard-normal prior.
        `exact` takes the trace of each set's Jacobian (`torch.func.jacfwd`
        under `vmap`); otherwise Hutchinson's e^T (dv/dx) e with e = `eps`,
        or drawn from `generator` (seed 0 when neither is given) in x's shape.

        Forward-mode differentiation runs on the unfolded module path: the
        kernels' autograd Functions have no forward-mode rule, so a folded
        network raises, and so does attention wherever it would launch a
        kernel (`ops.attention.forward_mode_ad`: a CUDA tensor at a shape the
        kernel takes). Where `attn_impl` names a kernel but the dispatcher
        takes the einsum path (`packed` on the CPU, for cross-attention shapes
        or longer sets) or a kernel's plain version (`fused`, `flash` on the
        CPU), it computes, as the JAX package's does for `packed`."""
        if self.loss_type == "droid" and self.droid_t_max != 1.0:
            raise NotImplementedError(
                "log_prob is not defined for the droid VE prior (t_max != 1): "
                "the s=1 marginal is x + t_max*z, only approximately Gaussian"
            )
        if self.self_cond:
            raise NotImplementedError(
                "log_prob with self_cond: the sampled field is history-dependent (x1_hat "
                "carried across steps), not an instantaneous ODE field"
            )
        if is_folded(net):
            raise RuntimeError("log_prob needs the unfolded network (call unfold_weight_norm)")
        from torch.func import jacfwd, jvp, vmap

        sched = VPDiffusionSchedule(**dict(self.diff_config)) if self.loss_type == "diffusion" else None
        if not exact and eps is None:
            if generator is None:
                generator = torch.Generator(x.device).manual_seed(0)
            eps = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)

        def vf_single(k, t, xi, ci, mi):
            out = net.flow_k(k, t, xi[None], cond=None if ci is None else ci[None],
                             mask=None if mi is None else mi[None])[0]
            if sched is not None:
                _, noise_rate = sched(t)
                out = -0.5 * sched.get_betas(t) * (xi - out / noise_rate)
            return out

        def div_single(k, t, xi, ci, mi, ei):
            if exact:
                jac = jacfwd(lambda z: vf_single(k, t, z.reshape(xi.shape), ci, mi).reshape(-1))(
                    xi.reshape(-1))
                return torch.trace(jac)
            _, tangent = jvp(lambda z: vf_single(k, t, z, ci, mi), (xi,), (ei,))
            return torch.sum(tangent * ei)

        in_dims = (0, None if cond is None else 0, None if mask is None else 0,
                   None if eps is None else 0)
        n = ode_steps - 1
        dt = 1.0 / n
        ts = torch.arange(n, dtype=torch.float32) * dt
        grid = torch.stack([ts, ts + 0.5 * dt], dim=1).to(x.device)
        z = x
        ladj = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        with torch.no_grad(), forward_mode_ad():
            for k in range(self.n_transforms):
                for t, t_half in grid:
                    dx1 = vmap(lambda xi, ci, mi, ei: vf_single(k, t, xi, ci, mi),
                               in_dims=in_dims)(z, cond, mask, eps)
                    dx2, div2 = vmap(
                        lambda xi, ci, mi, ei: (vf_single(k, t_half, xi, ci, mi),
                                                div_single(k, t_half, xi, ci, mi, ei)),
                        in_dims=in_dims)(z + 0.5 * dt * dx1, cond, mask, eps)
                    z = z + dt * dx2
                    ladj = ladj + dt * div2
        if mask is not None:
            z = z * mask
            dims = torch.sum(mask, dim=(1, 2)) * x.shape[-1]
        else:
            dims = float(math.prod(x.shape[1:]))
        sq = torch.sum(torch.square(z), dim=tuple(range(1, z.ndim)))
        return -0.5 * sq - 0.5 * dims * math.log(2 * math.pi) + ladj

    def _guided_net(self, net: CNFStack, flow_idx, cond, mask, guidance_scale):
        """The raw network prediction net(t, x) of flow `flow_idx` (None: the
        whole stack), with classifier-free guidance as one doubled-batch
        forward, p = p_u + w * (p_c - p_u): the one place where guidance is
        combined, for the ODE drift and the diffusion samplers alike."""

        def raw_net(t, x, c, m):
            if flow_idx is None:
                return net(t, x, cond=c, mask=m)
            return net.flow_k(flow_idx, t, x, cond=c, mask=m)

        if guidance_scale is not None and guidance_scale != 1.0 and cond is not None:
            w = guidance_scale
            cc = torch.cat([cond, torch.zeros_like(cond)], dim=0)
            mm = None if mask is None else torch.cat([mask, mask], dim=0)

            def guided(t, x):
                tt = torch.cat([t, t], dim=0) if t.ndim else t
                out = raw_net(tt, torch.cat([x, x], dim=0), cc, mm)
                v_c, v_u = torch.chunk(out, 2, dim=0)
                return v_u + w * (v_c - v_u)

            return guided
        return lambda t, x: raw_net(t, x, cond, mask)

    def make_drift(self, net: CNFStack, cond=None, mask=None, flow_idx=None, guidance_scale=None):
        """ODE drift f(t, x): the network; for diffusion the probability-flow
        drift -0.5 * beta * (x - eps_theta / sigma_t); for droid with
        t_max != 1 the physical drift t_max * net. t is 0-dim or per set (B,)."""
        pred = self._guided_net(net, flow_idx, cond, mask, guidance_scale)
        if self.loss_type == "diffusion":
            sched = VPDiffusionSchedule(**dict(self.diff_config))

            def drift(t, x):
                # a bfloat16 prediction meets the float32 schedule as in JAX, which
                # promotes it to float32 (a 0-dim float32 tensor would not)
                eps = pred(t, x).to(x.dtype)
                _, noise_rates = sched(t)
                betas = sched.get_betas(t)
                return -0.5 * _per_set(betas, x) * (x - eps / _per_set(noise_rates, x))

            return drift
        if self.loss_type == "droid" and self.droid_t_max != 1.0:
            tm = self.droid_t_max
            return lambda t, x: tm * pred(t, x)
        return pred

    @torch.no_grad()
    def integrate(
        self,
        net: CNFStack,
        z: torch.Tensor,
        cond: torch.Tensor | None = None,
        mask: torch.Tensor | None = None,
        ode_solver: str = "midpoint",
        ode_steps: int = 100,
        guidance_scale: float | None = None,
        generator: torch.Generator | None = None,
        stats: list | None = None,
        noise_rows: tuple[int, slice] | None = None,
    ) -> torch.Tensor:
        """Integrate every flow transform in reverse order from the starting
        point z at t=1 to t=0, with weight norm folded once; with
        `use_normaliser`, around the normalised cond and the reverse
        normalisation of the result, as the JAX `sample` places them. `em`
        draws its noise from `generator` (with `noise_rows` = (n, rows), each
        step's for a batch of n, z's rows of it kept); the DOPRI5 solvers
        append their statistics of each flow to `stats` when it is given."""
        self.fold_weight_norm(net)
        try:
            return self.integrate_folded(net, z, cond, mask, ode_solver, ode_steps,
                                         guidance_scale, generator, stats, noise_rows)
        finally:
            self.unfold_weight_norm(net)

    @torch.no_grad()
    def integrate_folded(
        self,
        net: CNFStack,
        z: torch.Tensor,
        cond: torch.Tensor | None = None,
        mask: torch.Tensor | None = None,
        ode_solver: str = "midpoint",
        ode_steps: int = 100,
        guidance_scale: float | None = None,
        generator: torch.Generator | None = None,
        stats: list | None = None,
        noise_rows: tuple[int, slice] | None = None,
        eps: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """`integrate` on a network whose weight norm is folded already: the
        body of the program that serving.py exports. There em may read its
        noise from `eps` (n_transforms * ode_steps, *z.shape) in place of a
        generator: each flow its `ode_steps` draws, in the order the flows
        run (the last flow first), as they would draw from a generator.
        Inside samplers/ode.py's `exported_loops()` the DOPRI5 solvers'
        statistics appended to `stats` are tensors (the program's outputs)."""
        if ode_solver not in SOLVERS:
            raise NotImplementedError(f"Solver {ode_solver} not implemented")
        if ode_solver in ("em", "ddim") and self.loss_type != "diffusion":
            raise ValueError(f"Solver {ode_solver} requires diffusion loss")
        if ode_solver == "em" and generator is None and eps is None:
            raise ValueError("the em solver draws its noise from a generator or reads it from "
                             "eps: pass one")
        if guidance_scale is not None and self.self_cond:
            raise NotImplementedError("guidance_scale with self_cond")
        if cond is not None and self.use_normaliser and self.conditioned:
            cond = net.normalise_cond(cond)
        if self.self_cond:
            x = self._integrate_sc(net, z, cond, mask, ode_solver, ode_steps)
        else:
            x = z
            for i, k in enumerate(reversed(range(self.n_transforms))):
                flow_eps = None if eps is None else eps[i * ode_steps:(i + 1) * ode_steps]
                x = self._integrate_flow(net, k, x, cond, mask, ode_solver, ode_steps,
                                         guidance_scale, generator, stats, noise_rows, flow_eps)
        if self.use_normaliser:
            x = net.reverse_norm(x, mask)
        return x

    def _integrate_sc(self, net, z, cond, mask, ode_solver, ode_steps):
        """Self-conditioned sampling: the estimate x1_hat is carried across
        steps; the drift is the physical one, tm * v, so that x - t * drift
        is the endpoint estimate on the droid VE path too."""
        sc_tm = self.droid_t_max if self.loss_type == "droid" else 1.0

        def drift_sc(t, x, sc):
            return sc_tm * net(t, x, cond=cond, mask=mask, x_sc=sc)

        return odeint_fixed_sc(drift_sc, z, 1.0, 0.0, ode_steps=ode_steps, method=ode_solver)

    def _integrate_flow(self, net, k, x, cond, mask, ode_solver, ode_steps, guidance_scale,
                        generator, stats, noise_rows=None, eps=None):
        if ode_solver in ("em", "ddim"):
            sched = VPDiffusionSchedule(**dict(self.diff_config))
            noise_model = self._guided_net(net, k, cond, mask, guidance_scale)
            if ode_solver == "em":
                return euler_maruyama_sampler(noise_model, sched, x,
                                              None if eps is not None else generator,
                                              n_steps=ode_steps, noise_rows=noise_rows, eps=eps)
            return ddim_sampler(noise_model, sched, x, n_steps=ode_steps)
        drift = self.make_drift(net, cond, mask, flow_idx=k, guidance_scale=guidance_scale)
        if ode_solver in FIXED_SOLVERS:
            return odeint_fixed(drift, x, 1.0, 0.0, ode_steps=ode_steps, method=ode_solver)
        solve = odeint_dopri5_per_sample if ode_solver == "dopri5_per_sample" else odeint_dopri5
        x, st = solve(drift, x, 1.0, 0.0, rtol=1e-4, atol=1e-4, return_stats=True)
        if stats is not None:
            stats.append(st)
        return x

    def sample(
        self,
        net: CNFStack,
        generator: torch.Generator,
        n_samples: int | None = None,
        cond: torch.Tensor | None = None,
        mask: torch.Tensor | None = None,
        ode_solver: str = "midpoint",
        ode_steps: int = 100,
        num_points: int | None = None,
        guidance_scale: float | None = None,
        stats: list | None = None,
        rank_split: bool = False,
    ) -> torch.Tensor:
        """Generate samples: z ~ N(0, 1) from `generator` (on the network's
        device), times `droid_t_max` for droid, masked, then `integrate`
        (which draws Euler-Maruyama's noise from the same generator). The
        mask's particle axis wins over `num_points`, as in the JAX package.

        With `rank_split` in a process group, every rank draws the whole z,
        integrates its rows of it (and of cond and mask) and gathers the
        ranks' rows: each rank returns what one process returns.
        Euler-Maruyama draws each step's noise for the whole batch too and
        keeps this rank's rows. Every rank must make the call; `n_samples`
        must split evenly over the ranks."""
        if n_samples is None:
            n_samples = cond.shape[0] if cond is not None else mask.shape[0]
        if mask is not None:
            num_points = mask.shape[1]
        elif num_points is None:
            num_points = self.num_particles
        device = next(net.parameters()).device
        z = draw_noise(generator, (n_samples, num_points, self.features), device)
        if self.loss_type == "droid":
            z = z * self.droid_t_max
        if mask is not None:
            z = z * mask
        if not (rank_split and dist.is_initialized()):
            return self.integrate(net, z, cond, mask, ode_solver, ode_steps, guidance_scale,
                                  generator, stats)
        rows = dist.local_rows(n_samples)
        x = self.integrate(net, z[rows], None if cond is None else cond[rows],
                           None if mask is None else mask[rows], ode_solver, ode_steps,
                           guidance_scale, generator, stats, noise_rows=(n_samples, rows))
        return dist.gather_rows(x)
