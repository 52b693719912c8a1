"""Training objectives; counterpart of particle_fm_tpu/losses/flow_matching.py.

All six families of the JAX package: FM-OT, CFM, CFM-OT (minibatch-OT
pairing, losses/ot.py), reflow (CFM on a fixed teacher coupling),
PC-JeDi VP-diffusion (noise prediction with the MLE weight) and PC-Droid
(y = x + t*t_max*z). Every loss has the form

    loss(vf, generator, x, mask, cond) -> scalar

where `vf(t, y, cond, mask)` is the vector-field network, t is (B,) (one
time per set), x is (B, N, F) and mask is (B, N, 1) or None. Randomness
comes from the explicit `torch.Generator`, drawn through `_sample_t` and
`_normal` in the JAX package's order (t, then the noises in the order the
JAX function splits its key), so a test can pin them. All normalise by
mask.sum().

Under data parallelism (`shard`, parallel/dist.py) x is this rank's rows of
the global batch: t and the noises are drawn for the global batch and
sliced, and the mask count is summed over the ranks, so the loss is this
rank's share of the global batch's loss (the ranks' shares add up to it,
and so do their gradients). The OT pairing is within each set, so it
couples no rows across ranks.
"""

from __future__ import annotations

from typing import Callable

import torch

from particle_fm_tpu_torch.losses.diffusion import VPDiffusionSchedule
from particle_fm_tpu_torch.losses.ot import gather_particles, ot_pair_indices
from particle_fm_tpu_torch.ops.masked import huber
from particle_fm_tpu_torch.parallel.dist import BatchShard, local_draw

VF = Callable  # vf(t: (B,), y: (B, N, F), cond, mask) -> (B, N, F)

CRITERIA = ("mse", "huber")


def _ones_mask(x: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(x[..., :1])


def _count(mask: torch.Tensor, shard: BatchShard | None) -> torch.Tensor:
    """The mask count of the global batch."""
    n = torch.sum(mask)
    return n if shard is None else shard.total(n)


def _reduce(err: torch.Tensor, mask: torch.Tensor, shard: BatchShard | None) -> torch.Tensor:
    return torch.sum(err) / _count(mask, shard)


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


def _t(generator: torch.Generator, x: torch.Tensor, shard: BatchShard | None) -> torch.Tensor:
    return local_draw(shard, _sample_t, generator, x.shape[0], x.device)


def _z(generator: torch.Generator, x: torch.Tensor, shard: BatchShard | None) -> torch.Tensor:
    return local_draw(shard, _normal, generator, x.shape, x.device, per_particle=True)


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
    shard: BatchShard | None = None,
) -> torch.Tensor:
    """Lipman flow matching to the OT (straight) probability path:
    y = (1-t) x + (sigma + (1-sigma) t) z, target u = (1-sigma) z - x."""
    if mask is None:
        mask = _ones_mask(x)
    t = _t(generator, x, shard)
    tb = _tb(t, x)
    z = _z(generator, x, shard)
    y = (1.0 - tb) * x + (sigma + (1.0 - sigma) * tb) * z
    u = ((1.0 - sigma) * z - x) * mask
    v = vf(t, y, cond, mask)
    return _reduce(_criterion(v, u, criterion), mask, shard)


def cfm_loss(
    vf: VF,
    generator: torch.Generator,
    x: torch.Tensor,
    mask: torch.Tensor | None = None,
    cond: torch.Tensor | None = None,
    sigma: float = 1e-4,
    criterion: str = "mse",
    shard: BatchShard | None = None,
) -> torch.Tensor:
    """Conditional flow matching with the independent coupling:
    y = (1-t) x1 + t x0 + sigma eps, target u = x0 - x1."""
    if mask is None:
        mask = _ones_mask(x)
    t = _t(generator, x, shard)
    tb = _tb(t, x)
    x0 = _z(generator, x, shard)
    x1 = x
    mu_t = (1.0 - tb) * x1 + tb * x0
    y = mu_t + sigma * _z(generator, x, shard)
    u = (x0 - x1) * mask
    v = vf(t, y, cond, mask)
    return _reduce(_criterion(v, u, criterion), mask, shard)


def cfm_ot_loss(
    vf: VF,
    generator: torch.Generator,
    x: torch.Tensor,
    mask: torch.Tensor | None = None,
    cond: torch.Tensor | None = None,
    sigma: float = 1e-4,
    criterion: str = "mse",
    ot_method: str = "sinkhorn",
    ot_reg: float = 0.01,
    ot_iters: int = 50,
    shard: BatchShard | None = None,
) -> torch.Tensor:
    """CFM with the noise particles of each set paired to its data particles
    by a minibatch-OT permutation; each set's mask is permuted with it."""
    if mask is None:
        mask = _ones_mask(x)
    t = _t(generator, x, shard)
    tb = _tb(t, x)
    x0 = _z(generator, x, shard)
    x1 = x
    with torch.no_grad():
        j = ot_pair_indices(x0, x1, method=ot_method, reg=ot_reg, n_iters=ot_iters)
    x1p = gather_particles(x1, j)
    mask_ot = gather_particles(mask, j)
    mu_t = x0 * tb + x1p * (1.0 - tb)
    y = mu_t + sigma * _z(generator, x, shard)
    u = (x0 - x1p) * mask_ot
    v = vf(t, y, cond, mask_ot)
    return _reduce(_criterion(v, u, criterion), mask, shard)


def reflow_loss(
    vf: VF,
    generator: torch.Generator,
    x: torch.Tensor,
    mask: torch.Tensor | None = None,
    cond: torch.Tensor | None = None,
    sigma: float = 1e-4,
    criterion: str = "mse",
    shard: BatchShard | None = None,
) -> torch.Tensor:
    """Rectified flow: CFM on the fixed teacher coupling packed along the
    feature axis, x = concat(x1 teacher sample, x0 its prior noise)."""
    if x.shape[-1] % 2 != 0:
        raise ValueError("reflow batches must pack concat(x1, x0) pairs")
    f = x.shape[-1] // 2
    x1, x0 = x[..., :f], x[..., f:]
    if mask is None:
        mask = _ones_mask(x1)
    t = _t(generator, x1, shard)
    tb = _tb(t, x1)
    mu_t = (1.0 - tb) * x1 + tb * x0
    y = mu_t + sigma * _z(generator, x1, shard)
    u = (x0 - x1) * mask
    v = vf(t, y, cond, mask)
    return _reduce(_criterion(v, u, criterion), mask, shard)


def diffusion_loss(
    vf: VF,
    generator: torch.Generator,
    x: torch.Tensor,
    mask: torch.Tensor | None = None,
    cond: torch.Tensor | None = None,
    criterion: str = "huber",
    schedule: VPDiffusionSchedule = VPDiffusionSchedule(max_sr=1.0, min_sr=1e-8),
    mle_loss_weight: float = 0.001,
    shard: BatchShard | None = None,
) -> torch.Tensor:
    """PC-JeDi VP-diffusion: the network predicts the noise z of
    signal_rate * x + noise_rate * z, plus `mle_loss_weight` times the same
    error weighted by beta / noise_rate."""
    if mask is None:
        mask = _ones_mask(x)
    t = _t(generator, x, shard)
    tb = _tb(t, x)
    z = _z(generator, x, shard) * mask
    signal_rates, noise_rates = schedule(tb)
    noisy = signal_rates * x + noise_rates * z
    pred = vf(t, noisy, cond, mask)
    simple = _criterion(z, pred, criterion) * mask
    count = _count(mask, shard)
    out = torch.sum(simple) / count
    if mle_loss_weight:
        mle = (schedule.get_betas(tb) / noise_rates) * simple
        out = out + mle_loss_weight * torch.sum(mle) / count
    return out


def droid_loss(
    vf: VF,
    generator: torch.Generator,
    x: torch.Tensor,
    mask: torch.Tensor | None = None,
    cond: torch.Tensor | None = None,
    criterion: str = "mse",
    t_max: float = 1.0,
    shard: BatchShard | None = None,
) -> torch.Tensor:
    """PC-Droid: y = x + s*t_max*z with the network time s in [0, 1], target
    u = z. t_max >> the data's spread makes the s=1 marginal t_max*N(0, 1),
    the sampler's prior (see the JAX function's docstring)."""
    if mask is None:
        mask = _ones_mask(x)
    t = _t(generator, x, shard)
    tb = _tb(t, x) * t_max
    z = _z(generator, x, shard)
    y = x + tb * z
    u = z * mask
    v = vf(t, y, cond, mask)
    return _reduce(_criterion(v, u, criterion), mask, shard)


def get_loss_fn(
    loss_type: str,
    sigma: float = 1e-4,
    criterion: str = "mse",
    diff_config: dict | None = None,
    ot_config: dict | None = None,
    droid_t_max: float = 1.0,
) -> Callable:
    """`loss(vf, generator, x, mask, cond, shard=None)` for a loss_type string."""
    diff_config = diff_config or {"max_sr": 1.0, "min_sr": 1e-8}
    ot_config = ot_config or {}
    if loss_type == "FM-OT":
        return lambda vf, generator, x, mask=None, cond=None, shard=None: fm_ot_loss(
            vf, generator, x, mask, cond, sigma=sigma, criterion=criterion, shard=shard
        )
    if loss_type == "CFM":
        return lambda vf, generator, x, mask=None, cond=None, shard=None: cfm_loss(
            vf, generator, x, mask, cond, sigma=sigma, criterion=criterion, shard=shard
        )
    if loss_type == "reflow":
        return lambda vf, generator, x, mask=None, cond=None, shard=None: reflow_loss(
            vf, generator, x, mask, cond, sigma=sigma, criterion=criterion, shard=shard
        )
    if loss_type == "CFM-OT":
        return lambda vf, generator, x, mask=None, cond=None, shard=None: cfm_ot_loss(
            vf, generator, x, mask, cond, sigma=sigma, criterion=criterion, shard=shard,
            **ot_config
        )
    if loss_type == "diffusion":
        sched = VPDiffusionSchedule(**diff_config)
        return lambda vf, generator, x, mask=None, cond=None, shard=None: diffusion_loss(
            vf, generator, x, mask, cond, criterion=criterion, schedule=sched, shard=shard
        )
    if loss_type == "droid":
        return lambda vf, generator, x, mask=None, cond=None, shard=None: droid_loss(
            vf, generator, x, mask, cond, criterion=criterion, t_max=droid_t_max, shard=shard
        )
    raise NotImplementedError(f"Loss type {loss_type} not implemented.")
