"""Consistency distillation: 1-2 step sampling from a trained flow teacher;
counterpart of particle_fm_tpu/training/consistency.py.

Consistency models (Song et al., arXiv:2303.01469) learn a map g(y_t, t)
that sends any point of a probability-flow trajectory to the trajectory's
data end, so that sampling is one network evaluation, with an optional
re-noise and map again ladder. The teachers are the flow-matching models,
whose paths are the straight interpolant y_t = (1-t) x + t z (t=1 noise,
t=0 data). As in the JAX package:

  * the student reuses the teacher's vector-field network F unchanged,
    g(y, t) = y - t F(t, y): the boundary condition g(y, 0) = y holds
    exactly, and at initialisation g is the teacher's one Euler jump to t=0;
  * consistency distillation (`distill_consistency`) pulls the student's
    g at t_{n+1} towards a stop-gradient target network's g at t_n, after one
    Heun step of the teacher's ODE from t_{n+1} to t_n; the target is an EMA
    of the student; direct distillation (`distill_direct`) regresses g onto
    the teacher's whole midpoint solve from t to 0;
  * the loss is the masked pseudo-Huber sqrt(d^2 + c^2) - c, the optimizer
    Adam on optax's warm-up cosine schedule.

On the card the teacher's no-grad solves run the folded teacher, which is
the EPiC kernel, and so does `consistency_sample` (the folded student); the
student's forward and backward stay on the module path, as training does.
The draws (the batch rows from numpy's default_rng(seed), the segments,
times and noises from one `torch.Generator(device)` seeded alike) go
through `draw_segments`, `draw_times` and `draw_noise`, which tests pin.

Driven by scripts/torch_consistency.py.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn

from particle_fm_tpu_torch.models.flow_matching import draw_noise
from particle_fm_tpu_torch.training.lr_schedules import warmup_cosine_decay_schedule


def _check_supported(model) -> None:
    if model.loss_type not in ("FM-OT", "CFM", "CFM-OT", "reflow"):
        raise ValueError(
            "consistency distillation needs a straight-interpolant flow "
            f"teacher (FM-OT/CFM/CFM-OT/reflow); got {model.loss_type!r}")
    if model.n_transforms != 1:
        raise NotImplementedError("consistency distillation requires n_transforms=1")
    if model.use_normaliser:
        raise NotImplementedError(
            "consistency students live in the network input space; teachers "
            "with in-model normalisation are not supported")
    if getattr(model, "self_cond", False):
        raise NotImplementedError("self-conditioning teachers are not supported")


def _g(net, t, y, cond, mask):
    """Consistency function g(y, t) = y - t * F(t, y): exact at t=0."""
    v = net(t, y, cond=cond, mask=mask)
    out = y - t[:, None, None] * v
    if mask is not None:
        out = out * mask
    return out


def time_grid(n_grid: int, t_min: float = 0.002) -> np.ndarray:
    """Discretization t_0 < ... < t_N with t_0 = 0 (the exact boundary) and
    the remaining knots spread over [t_min, 1]. Segment draws use indices
    0..N-1; a draw of segment 0 trains directly against the boundary."""
    ts = np.linspace(t_min, 1.0, n_grid)
    return np.concatenate([[0.0], ts]).astype(np.float32)


def draw_segments(generator: torch.Generator, n: int, n_grid: int, device) -> torch.Tensor:
    """The grid segment of each of n sets, uniform over 0..n_grid-1."""
    return torch.randint(0, n_grid, (n,), generator=generator, device=device)


def draw_times(generator: torch.Generator, n: int, t_min: float, device) -> torch.Tensor:
    """t ~ U(t_min, 1) for each of n sets."""
    u = torch.rand((n,), generator=generator, device=device, dtype=torch.float32)
    return t_min + (1.0 - t_min) * u


@dataclasses.dataclass
class DistillResult:
    net: nn.Module         # the student (unfolded)
    target_net: nn.Module  # the target network (the student itself in direct distillation)
    losses: np.ndarray     # per-step training loss


def _setup(model, net, init_net, lr, warmup, steps):
    """(folded teacher copy, student copy, Adam, schedule)."""
    _check_supported(model)
    teacher = copy.deepcopy(net)
    model.fold_weight_norm(teacher)
    student = copy.deepcopy(init_net if init_net is not None else net)
    model.unfold_weight_norm(student)
    sched = warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1))
    opt = torch.optim.Adam(student.parameters(), lr=sched(0), betas=(0.9, 0.999), eps=1e-8)
    return teacher, student, opt, sched


def _pseudo_huber(g, target, mask, huber_c: float, like):
    d = g - target
    ph = torch.sqrt(torch.square(d) + huber_c ** 2) - huber_c
    m = mask if mask is not None else torch.ones_like(like[..., :1])
    return torch.sum(ph * m) / torch.sum(m)


def _batches(x, mask, cond, device, seed: int, batch_size: int):
    """(rows, x, mask, cond) of each step: rows drawn with replacement from
    numpy's default_rng(seed), as the JAX loop draws them."""
    xt = torch.as_tensor(x, dtype=torch.float32, device=device)
    mt = None if mask is None else torch.as_tensor(mask, dtype=torch.float32, device=device)
    ct = None if cond is None else torch.as_tensor(cond, dtype=torch.float32, device=device)
    rng_np = np.random.default_rng(seed)
    while True:
        idx = torch.as_tensor(rng_np.integers(0, len(x), batch_size), device=device)
        yield (xt[idx], None if mt is None else mt[idx], None if ct is None else ct[idx])


def _step(opt, sched, s: int, loss) -> None:
    for group in opt.param_groups:
        group["lr"] = sched(s)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()


def distill_consistency(
    model,
    net,
    x: np.ndarray,
    mask: np.ndarray | None = None,
    cond: np.ndarray | None = None,
    *,
    steps: int = 4000,
    batch_size: int = 256,
    lr: float = 1e-4,
    warmup: int = 200,
    n_grid: int = 16,
    t_min: float = 0.002,
    target_ema: float = 0.95,
    huber_c: float = 0.15,
    seed: int = 0,
    verbose: bool = False,
    init_net: nn.Module | None = None,
) -> DistillResult:
    """Distill the teacher `net` of `model` into a consistency student over
    the data (x, mask, cond) in normalised space; the student and its target
    start from `init_net` (a previous stage's student) or the teacher. The
    teacher network is left as it was given. `huber_c` should scale with the
    data's std (the datamodules normalise to sigma 5: 0.15 ~= 0.03 * 5)."""
    teacher, student, opt, sched = _setup(model, net, init_net, lr, warmup, steps)
    target = copy.deepcopy(student).requires_grad_(False)
    device = next(net.parameters()).device
    grid = torch.as_tensor(time_grid(n_grid, t_min), device=device)
    gen = torch.Generator(device).manual_seed(seed)
    batches = _batches(x, mask, cond, device, seed, batch_size)
    losses = np.zeros(steps, np.float32)
    for s in range(steps):
        xb, mb, cb = next(batches)
        seg = draw_segments(gen, xb.shape[0], n_grid, device)
        t_lo, t_hi = grid[seg], grid[seg + 1]
        z = draw_noise(gen, tuple(xb.shape), device)
        th = t_hi[:, None, None]
        y_hi = (1.0 - th) * xb + th * z
        if mb is not None:
            y_hi = y_hi * mb
        with torch.no_grad():
            # one Heun step of the teacher's probability-flow ODE: t_hi -> t_lo
            d1 = teacher(t_hi, y_hi, cond=cb, mask=mb)
            dt = (t_lo - t_hi)[:, None, None]
            y_eul = y_hi + dt * d1
            d2 = teacher(t_lo, y_eul, cond=cb, mask=mb)
            y_lo = y_hi + dt * 0.5 * (d1 + d2)
            if mb is not None:
                y_lo = y_lo * mb
            g_target = _g(target, t_lo, y_lo, cb, mb)
        loss = _pseudo_huber(_g(student, t_hi, y_hi, cb, mb), g_target, mb, huber_c, xb)
        _step(opt, sched, s, loss)
        with torch.no_grad():
            for a, b in zip(target.parameters(), student.parameters()):
                a.copy_(target_ema * a + (1.0 - target_ema) * b)
        losses[s] = float(loss.detach())
        if verbose and (s % max(steps // 20, 1) == 0 or s == steps - 1):
            print(f"[consistency] step {s}/{steps} loss {losses[s]:.5f}")
    return DistillResult(net=student, target_net=target, losses=losses)


def distill_direct(
    model,
    net,
    x: np.ndarray,
    mask: np.ndarray | None = None,
    cond: np.ndarray | None = None,
    *,
    steps: int = 4000,
    batch_size: int = 256,
    lr: float = 1e-4,
    warmup: int = 200,
    solver_steps: int = 8,
    t_min: float = 0.002,
    huber_c: float = 0.15,
    seed: int = 0,
    verbose: bool = False,
    init_net: nn.Module | None = None,
) -> DistillResult:
    """Direct trajectory distillation: regress g(y_t, t) onto the teacher's
    whole probability-flow solve from y_t to t=0 (midpoint, `solver_steps`
    equal steps of each set's own length), t ~ U(t_min, 1) per set. No
    bootstrap and no target network: 2 * solver_steps teacher evaluations an
    example, on the folded teacher."""
    teacher, student, opt, sched = _setup(model, net, init_net, lr, warmup, steps)
    device = next(net.parameters()).device
    gen = torch.Generator(device).manual_seed(seed)
    batches = _batches(x, mask, cond, device, seed, batch_size)

    @torch.no_grad()
    def teacher_solve(t, y, cb, mb):
        dt = -(t / solver_steps)[:, None, None]
        for i in range(solver_steps):
            # i / solver_steps in float32, as the JAX loop computes it
            tau = t * (1.0 - torch.tensor(float(i), dtype=torch.float32) / solver_steps)
            k1 = teacher(tau, y, cond=cb, mask=mb)
            y_mid = y + 0.5 * dt * k1
            t_mid = tau + 0.5 * dt[:, 0, 0]
            k2 = teacher(t_mid, y_mid, cond=cb, mask=mb)
            y = y + dt * k2
            y = y * mb if mb is not None else y
        return y

    losses = np.zeros(steps, np.float32)
    for s in range(steps):
        xb, mb, cb = next(batches)
        t = draw_times(gen, xb.shape[0], t_min, device)
        z = draw_noise(gen, tuple(xb.shape), device)
        y_t = (1.0 - t[:, None, None]) * xb + t[:, None, None] * z
        if mb is not None:
            y_t = y_t * mb
        target = teacher_solve(t, y_t, cb, mb)
        loss = _pseudo_huber(_g(student, t, y_t, cb, mb), target, mb, huber_c, xb)
        _step(opt, sched, s, loss)
        losses[s] = float(loss.detach())
        if verbose and (s % max(steps // 20, 1) == 0 or s == steps - 1):
            print(f"[consistency] step {s}/{steps} loss {losses[s]:.5f}")
    return DistillResult(net=student, target_net=student, losses=losses)


@torch.no_grad()
def consistency_sample(
    model,
    net,
    generator: torch.Generator,
    n_samples: int | None = None,
    cond: torch.Tensor | None = None,
    mask: torch.Tensor | None = None,
    steps: int = 1,
    ts: Sequence[float] | None = None,
) -> torch.Tensor:
    """Generate with a consistency student on its folded network: x = g(z, 1)
    with z drawn from `generator` (masked), then `steps` - 1 re-noise and map
    refinements at the times `ts` (default: linspace(1, 0, steps+1)[1:-1],
    e.g. steps=2 -> [0.5]), each drawing its noise next. NFE = steps.
    Matches `sample`'s contract (masked prior, cond/mask batch shapes,
    normalised space). The network is left as it was given."""
    from particle_fm_tpu_torch.models.flow_matching import is_folded

    _check_supported(model)
    if n_samples is None:
        n_samples = cond.shape[0] if cond is not None else mask.shape[0]
    num_points = mask.shape[1] if mask is not None else model.num_particles
    if ts is None:
        ts = list(np.linspace(1.0, 0.0, steps + 1)[1:-1])
    device = next(net.parameters()).device
    folded = is_folded(net)
    model.fold_weight_norm(net)
    try:
        z = draw_noise(generator, (n_samples, num_points, model.features), device)
        if mask is not None:
            z = z * mask
        x = _g(net, torch.ones((n_samples,), dtype=z.dtype, device=device), z, cond, mask)
        for t_mid in ts:
            t_mid = float(t_mid)
            z2 = draw_noise(generator, tuple(x.shape), device)
            y = (1.0 - t_mid) * x + t_mid * z2
            if mask is not None:
                y = y * mask
            x = _g(net, torch.full((n_samples,), t_mid, dtype=x.dtype, device=device), y, cond,
                   mask)
    finally:
        if not folded:
            model.unfold_weight_norm(net)
    return x
