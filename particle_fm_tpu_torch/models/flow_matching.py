"""FlowMatchingModel; counterpart of particle_fm_tpu/models/flow_matching.py.

The port samples the families whose ODE drift is the network itself (FM-OT,
CFM, CFM-OT) with the fixed-step solvers, in float32, and trains FM-OT and
CFM. As in the JAX package the model is a configuration bundle that takes
every field of the shipped model configs: `init` builds the network (a
`CNFStack` module on the requested device), `loss` is the masked training
and validation loss on the unfolded network, and `sample` folds weight norm
once, draws masked noise from a `torch.Generator` and integrates from t=1
to 0. A field raises only where its value asks for what the port lacks.

`integrate` takes the noise `z` explicitly, so a test can hand it the noise
the JAX package drew.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch
from torch import nn

from particle_fm_tpu_torch.losses.flow_matching import CRITERIA, get_loss_fn
from particle_fm_tpu_torch.models.cnf import CNFStack
from particle_fm_tpu_torch.nets.common import WNDense
from particle_fm_tpu_torch.nets.epic import EPiCLayer
from particle_fm_tpu_torch.samplers.ode import FIXED_SOLVERS, odeint_fixed
from particle_fm_tpu_torch.utils.device import resolve_device

_DRIFT_IS_NET = ("FM-OT", "CFM", "CFM-OT")


def draw_noise(generator: torch.Generator, shape: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """Standard normal noise for the sampler's starting point."""
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


def _keep(generator: torch.Generator, p: float, shape: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """Bernoulli(p) draw: which sets keep their cond under cond_dropout."""
    return torch.rand(shape, generator=generator, device=device) < p


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
        if self.loss_type not in _DRIFT_IS_NET:
            raise NotImplementedError(f"loss_type={self.loss_type} is not ported")
        if self.self_cond or self.dtype is not None:
            raise NotImplementedError("self-conditioning and dtype are not ported")
        if self.dropout > 0.0:
            raise NotImplementedError("dropout is not ported")
        if self.droid_t_max != 1.0:
            raise NotImplementedError("droid_t_max != 1 (the droid VE prior) is not ported")
        if self.criterion not in CRITERIA:
            raise ValueError(f"criterion {self.criterion} not supported")
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
            net_config=dict(self.net_config),
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

    def loss_accum_weight(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        """Gradient-accumulation weight of one microbatch: its loss
        normalisation mass, so that weighted microbatch gradients add up to
        the big-batch gradient."""
        if mask is None:
            return torch.tensor(float(x.shape[0] * x.shape[1]), device=x.device)
        return torch.sum(mask).to(torch.float32)

    def loss(
        self,
        net: CNFStack,
        generator: torch.Generator,
        x: torch.Tensor,
        mask: torch.Tensor | None = None,
        cond: torch.Tensor | None = None,
        train: bool = False,
    ) -> torch.Tensor:
        """Masked training (`train=True`) or validation loss of the unfolded
        network, with t and the noise drawn from `generator`. In training,
        `cond_dropout` sets whole sets' cond to the null token (zeros),
        drawn from the generator before t."""
        if is_folded(net):
            raise RuntimeError(
                "loss needs the unfolded network: folded weights carry no gradient to "
                "weight norm's v and g (call unfold_weight_norm first)"
            )
        loss_fn = get_loss_fn(self.loss_type, sigma=self.sigma, criterion=self.criterion)
        if self.use_normaliser:
            if train:
                raise NotImplementedError(
                    "training with use_normaliser is not ported: the running statistics' "
                    "update is not"
                )
            x = net.normalise(x, mask)
            if self.conditioned and cond is not None:
                cond = net.normalise_cond(cond)
        if train and self.cond_dropout > 0.0 and self.conditioned and cond is not None:
            keep = _keep(generator, 1.0 - self.cond_dropout, (cond.shape[0], 1), cond.device)
            cond = torch.where(keep, cond, torch.zeros_like(cond))
        return loss_fn(lambda t, y, c, m: net(t, y, cond=c, mask=m), generator, x, mask, cond)

    def make_drift(self, net: CNFStack, cond=None, mask=None, flow_idx=None, guidance_scale=None):
        """ODE drift f(t, x): the network, with optional classifier-free
        guidance as one doubled-batch forward, v = v_u + w * (v_c - v_u)."""

        def raw_net(t, x, c, m):
            if flow_idx is None:
                return net(t, x, cond=c, mask=m)
            return net.flow_k(flow_idx, t, x, cond=c, mask=m)

        if guidance_scale is not None and guidance_scale != 1.0 and cond is not None:
            w = guidance_scale
            cc = torch.cat([cond, torch.zeros_like(cond)], dim=0)
            mm = None if mask is None else torch.cat([mask, mask], dim=0)

            def drift(t, x):
                out = raw_net(t, torch.cat([x, x], dim=0), cc, mm)
                v_c, v_u = torch.chunk(out, 2, dim=0)
                return v_u + w * (v_c - v_u)

            return drift
        return lambda t, x: raw_net(t, x, cond, mask)

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
    ) -> torch.Tensor:
        """Integrate every flow transform in reverse order from the noise z
        (already masked) at t=1 to t=0, with weight norm folded once; with
        `use_normaliser`, around the normalised cond and the reverse
        normalisation of the result, as the JAX `sample` places them."""
        if ode_solver not in FIXED_SOLVERS:
            raise NotImplementedError(f"ode_solver={ode_solver} is not ported")
        if cond is not None and self.use_normaliser and self.conditioned:
            cond = net.normalise_cond(cond)
        self.fold_weight_norm(net)
        try:
            x = z
            for k in reversed(range(self.n_transforms)):
                drift = self.make_drift(net, cond, mask, flow_idx=k, guidance_scale=guidance_scale)
                x = odeint_fixed(drift, x, 1.0, 0.0, ode_steps=ode_steps, method=ode_solver)
        finally:
            self.unfold_weight_norm(net)
        if self.use_normaliser:
            x = net.reverse_norm(x, mask)
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
    ) -> torch.Tensor:
        """Generate samples: z ~ N(0, 1) from `generator` (on the network's
        device), masked, then `integrate`. The mask's particle axis wins over
        `num_points`, as in the JAX package."""
        if n_samples is None:
            n_samples = cond.shape[0] if cond is not None else mask.shape[0]
        if mask is not None:
            num_points = mask.shape[1]
        elif num_points is None:
            num_points = self.num_particles
        device = next(net.parameters()).device
        z = draw_noise(generator, (n_samples, num_points, self.features), device)
        if mask is not None:
            z = z * mask
        return self.integrate(net, z, cond, mask, ode_solver, ode_steps, guidance_scale)
