"""Flow matching on flat feature vectors (no sets); counterpart of
particle_fm_tpu/models/flow_matching_flat.py. Stage 1 of the LHCO
two-stage chain (dijet features conditioned on mjj) and the GenChallenge
model.

`FlatCNF` is a small conditional MLP (nets/mlp.py::SmallCondMLP, `net`)
with a sincos time embedding at frequencies arange(1, F+1) * pi, cos before
sin (the set CNF's ladder is 2^k * pi). `FlatStack` holds the flows as
`flow_0`, `flow_1`, ..., the names of the flax module, so utils/from_jax.py
carries one tree into the other.

The flows run differently in each method, as in the JAX model: the loss
chains every flow (the field of flow k+1 reads the field of flow k); `sample`
integrates each flow's own ODE in turn, the last first, from noise at t=1 to
t=0; `log_prob` chains them forward from the data. The loss is FM-OT with
mask=None: on (B, F) data its normalisation is the batch size, as in the JAX
loss, and so is the gradient-accumulation weight.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from particle_fm_tpu_torch.losses.flow_matching import fm_ot_loss
from particle_fm_tpu_torch.models.flow_matching import compute_dtype, draw_noise
from particle_fm_tpu_torch.nets.mlp import SmallCondMLP
from particle_fm_tpu_torch.samplers.ode import odeint_fixed
from particle_fm_tpu_torch.utils.device import resolve_device


class FlatCNF(nn.Module):
    """One flat flow: v(t, x, cond) = net(sincos(t), x, cond), x (B, F)."""

    def __init__(self, features: int, freqs: int = 3, activation: str = "elu", cond_dim: int = 0,
                 generator: torch.Generator | None = None, dtype: torch.dtype | None = None):
        super().__init__()
        self.freqs = freqs
        self.net = SmallCondMLP(features, features, t_dim=2 * freqs, cond_dim=cond_dim,
                                activation=activation, generator=generator, dtype=dtype)

    def forward(self, t: torch.Tensor, x: torch.Tensor, cond: torch.Tensor | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        freqs = torch.arange(1, self.freqs + 1, dtype=x.dtype, device=x.device) * math.pi
        if t.ndim == 0:
            t = t.expand(x.shape[:-1])
        arg = t[..., None] * freqs
        t_emb = torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1)
        return self.net(t_emb.expand(*x.shape[:-1], t_emb.shape[-1]), x, cond)


class FlatStack(nn.Module):
    """The flows `flow_0` ... `flow_{n-1}`; calling the stack chains them."""

    def __init__(self, n_transforms: int, features: int, **cnf_config):
        super().__init__()
        self.n_transforms = n_transforms
        for k in range(n_transforms):
            self.add_module(f"flow_{k}", FlatCNF(features, **cnf_config))

    def flow_k(self, k: int, t, x, cond=None, mask=None) -> torch.Tensor:
        return getattr(self, f"flow_{k}")(t, x, cond, mask)

    def forward(self, t, x, cond=None, mask=None) -> torch.Tensor:
        for k in range(self.n_transforms):
            x = self.flow_k(k, t, x, cond, mask)
        return x


@dataclasses.dataclass(eq=False)
class FlatFlowMatchingModel:
    """FM model over flat vectors: loss, midpoint sampling and log p(x)."""

    features: int = 10
    n_transforms: int = 1
    sigma: float = 1e-4
    activation: str = "elu"
    freqs: int = 3
    cond_dim: int = 1
    dtype: Any = None

    def __post_init__(self):
        self.compute_dtype = compute_dtype(self.dtype)

    def init(self, seed: int = 0, device: str | torch.device = "cuda") -> FlatStack:
        """The network, with torch-Linear init drawn from `seed`, on `device`."""
        dev = resolve_device(device)
        net = FlatStack(self.n_transforms, self.features, freqs=self.freqs,
                        activation=self.activation, cond_dim=self.cond_dim,
                        generator=torch.Generator().manual_seed(seed), dtype=self.compute_dtype)
        return net.to(dev).eval()

    def loss_accum_weight(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        """Gradient-accumulation weight of one microbatch: its batch size,
        the loss's normalisation on flat data."""
        return torch.tensor(float(x.shape[0]), device=x.device)

    def loss(self, net: FlatStack, generator: torch.Generator, x: torch.Tensor,
             mask: torch.Tensor | None = None, cond: torch.Tensor | None = None,
             train: bool = False) -> torch.Tensor:
        """FM-OT loss of the chained flows; t and z drawn from `generator`."""
        return fm_ot_loss(lambda t, y, c, m: net(t, y, c, m), generator, x, None, cond,
                          sigma=self.sigma)

    @torch.no_grad()
    def integrate(self, net: FlatStack, z: torch.Tensor, cond: torch.Tensor | None = None,
                  mask: torch.Tensor | None = None, ode_solver: str = "midpoint",
                  ode_steps: int = 100) -> torch.Tensor:
        """Each flow's ODE from z at t=1 to t=0, the last flow first."""
        if ode_solver != "midpoint":
            raise NotImplementedError(f"Solver {ode_solver} not implemented")
        for k in reversed(range(self.n_transforms)):
            z = odeint_fixed(lambda t, y, k=k: net.flow_k(k, t, y, cond, mask), z, 1.0, 0.0,
                             ode_steps=ode_steps, method="midpoint")
        return z

    def sample(self, net: FlatStack, generator: torch.Generator, n_samples: int | None = None,
               cond: torch.Tensor | None = None, mask: torch.Tensor | None = None,
               ode_solver: str = "midpoint", ode_steps: int = 100) -> torch.Tensor:
        """z ~ N(0, 1) of (n_samples, features) from `generator`, then `integrate`."""
        if n_samples is None:
            n_samples = cond.shape[0]
        device = next(net.parameters()).device
        z = draw_noise(generator, (n_samples, self.features), device)
        return self.integrate(net, z, cond, mask, ode_solver, ode_steps)

    def log_prob(self, net: FlatStack, x: torch.Tensor, cond: torch.Tensor | None = None,
                 ode_steps: int = 50, exact: bool = True, generator: torch.Generator | None = None,
                 eps: torch.Tensor | None = None) -> torch.Tensor:
        """log p(x) (B,) by the augmented ODE: (x, log-det) integrated with
        ode_steps - 1 midpoint steps from t=0 to t=1 through flow 0, then
        flow 1, ..., with the divergence of each flow's field accumulated,
        then the standard-normal prior over the features. `exact` takes the
        trace of each vector's Jacobian (`torch.func.jacfwd` under `vmap`);
        otherwise Hutchinson's e^T (dv/dx) e with one normal probe e = `eps`,
        or drawn from `generator` (seed 0 when neither is given)."""
        from torch.func import jacfwd, jvp, vmap

        if ode_steps < 2:
            raise ValueError(f"log_prob needs ode_steps >= 2, got {ode_steps}")
        if not exact and eps is None:
            if generator is None:
                generator = torch.Generator(x.device).manual_seed(0)
            eps = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)

        def vf_single(k, t, xi, ci):
            return net.flow_k(k, t.reshape(1), xi[None], None if ci is None else ci[None])[0]

        def div_single(k, t, xi, ci, ei):
            if exact:
                return torch.trace(jacfwd(lambda z: vf_single(k, t, z, ci))(xi))
            _, tangent = jvp(lambda z: vf_single(k, t, z, ci), (xi,), (ei,))
            return torch.sum(tangent * ei)

        in_dims = (0, None if cond is None else 0, None if eps is None else 0)
        n = ode_steps - 1
        dt = 1.0 / n
        ts = torch.arange(n, dtype=torch.float32) * dt
        grid = torch.stack([ts, ts + 0.5 * dt], dim=1).to(x.device)
        z, ladj = x, torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        with torch.no_grad():
            for k in range(self.n_transforms):
                for t, t_half in grid:
                    dx1 = vmap(lambda xi, ci, ei: vf_single(k, t, xi, ci), in_dims=in_dims)(
                        z, cond, eps)
                    dx2, div2 = vmap(lambda xi, ci, ei: (vf_single(k, t_half, xi, ci),
                                                         div_single(k, t_half, xi, ci, ei)),
                                     in_dims=in_dims)(z + 0.5 * dt * dx1, cond, eps)
                    z = z + dt * dx2
                    ladj = ladj + dt * div2
        log_prior = (-0.5 * torch.sum(torch.square(z), dim=-1)
                     - 0.5 * self.features * math.log(2 * math.pi))
        return log_prior + ladj
