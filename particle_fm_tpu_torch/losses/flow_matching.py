"""Training objectives; counterpart of particle_fm_tpu/losses/flow_matching.py.

The port carries the two families whose drift is the network and whose loss
needs no pairing: FM-OT and CFM. Every loss has the form

    loss(vf, generator, x, mask, cond) -> scalar

where `vf(t, y, cond, mask)` is the vector-field network, t is (B,) (one
time per set), x is (B, N, F) and mask is (B, N, 1) or None. Randomness
comes from the explicit `torch.Generator`, drawn through `_sample_t` and
`_normal` in the JAX package's order (t, then the noise), so a test can pin
both. Both normalise as sum(err) / mask.sum().
"""

from __future__ import annotations

from typing import Callable

import torch

from particle_fm_tpu_torch.ops.masked import huber

VF = Callable  # vf(t: (B,), y: (B, N, F), cond, mask) -> (B, N, F)

PORTED_LOSSES = ("FM-OT", "CFM")
CRITERIA = ("mse", "huber")


def _ones_mask(x: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(x[..., :1])


def _reduce(err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(err) / torch.sum(mask)


def _criterion(v: torch.Tensor, u: torch.Tensor, criterion: str) -> torch.Tensor:
    if criterion == "mse":
        return torch.square(v - u)
    if criterion == "huber":
        return huber(v - u)
    raise ValueError(f"criterion {criterion} not supported")


def _sample_t(generator: torch.Generator, batch: int, device: torch.device) -> torch.Tensor:
    """One time per set, U[0, 1)."""
    return torch.rand((batch,), generator=generator, device=device, dtype=torch.float32)


def _normal(generator: torch.Generator, shape, device: torch.device) -> torch.Tensor:
    """Standard-normal draw."""
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


def _tb(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast per-set t to x's rank: (B,) -> (B, 1, ..., 1)."""
    return t.reshape((t.shape[0],) + (1,) * (x.ndim - 1))


def fm_ot_loss(
    vf: VF,
    generator: torch.Generator,
    x: torch.Tensor,
    mask: torch.Tensor | None = None,
    cond: torch.Tensor | None = None,
    sigma: float = 1e-4,
    criterion: str = "mse",
) -> torch.Tensor:
    """Lipman flow matching to the OT (straight) probability path:
    y = (1-t) x + (sigma + (1-sigma) t) z, target u = (1-sigma) z - x."""
    if mask is None:
        mask = _ones_mask(x)
    t = _sample_t(generator, x.shape[0], x.device)
    tb = _tb(t, x)
    z = _normal(generator, x.shape, x.device)
    y = (1.0 - tb) * x + (sigma + (1.0 - sigma) * tb) * z
    u = ((1.0 - sigma) * z - x) * mask
    v = vf(t, y, cond, mask)
    return _reduce(_criterion(v, u, criterion), mask)


def cfm_loss(
    vf: VF,
    generator: torch.Generator,
    x: torch.Tensor,
    mask: torch.Tensor | None = None,
    cond: torch.Tensor | None = None,
    sigma: float = 1e-4,
    criterion: str = "mse",
) -> torch.Tensor:
    """Conditional flow matching with the independent coupling:
    y = (1-t) x1 + t x0 + sigma eps, target u = x0 - x1."""
    if mask is None:
        mask = _ones_mask(x)
    t = _sample_t(generator, x.shape[0], x.device)
    tb = _tb(t, x)
    x0 = _normal(generator, x.shape, x.device)
    x1 = x
    mu_t = (1.0 - tb) * x1 + tb * x0
    y = mu_t + sigma * _normal(generator, x.shape, x.device)
    u = (x0 - x1) * mask
    v = vf(t, y, cond, mask)
    return _reduce(_criterion(v, u, criterion), mask)


def get_loss_fn(loss_type: str, sigma: float = 1e-4, criterion: str = "mse") -> Callable:
    """`loss(vf, generator, x, mask, cond)` for a loss_type string."""
    if loss_type == "FM-OT":
        return lambda vf, generator, x, mask=None, cond=None: fm_ot_loss(
            vf, generator, x, mask, cond, sigma=sigma, criterion=criterion
        )
    if loss_type == "CFM":
        return lambda vf, generator, x, mask=None, cond=None: cfm_loss(
            vf, generator, x, mask, cond, sigma=sigma, criterion=criterion
        )
    raise NotImplementedError(
        f"the {loss_type} loss is not ported (the port trains {', '.join(PORTED_LOSSES)})"
    )
