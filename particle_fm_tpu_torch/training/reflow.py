"""Rectified-flow (ReFlow) distillation; counterpart of
particle_fm_tpu/training/reflow.py.

ReFlow (Liu et al., arXiv:2209.03003) retrains the teacher's vector-field
architecture on the deterministic coupling (x0, x1) that the teacher's own
ODE induces: x0 the prior noise, x1 the teacher's sample integrated from it.
The rectified field's paths come out nearly straight, so the student samples
with a few Euler steps. `generate_pairs` integrates the folded teacher (on
the card the EPiC kernel, as `lhco_chain.py`'s stage 2 does) from noise drawn
with `models/flow_matching.py::draw_noise`; the pairs stay in the
datamodule's normalised space, packed by `data/pairs.py` as concat(x1, x0)
for the Trainer and `losses/flow_matching.py::reflow_loss`.

Driven by scripts/torch_reflow.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from particle_fm_tpu_torch.models.flow_matching import draw_noise, is_folded
from particle_fm_tpu_torch.samplers.ode import odeint_fixed


def _as(a, device) -> torch.Tensor | None:
    return None if a is None else torch.as_tensor(a, dtype=torch.float32, device=device)


@torch.no_grad()
def generate_pairs(
    model,
    net,
    n_pairs: int,
    mask: np.ndarray | None = None,
    cond: np.ndarray | None = None,
    batch_size: int = 1024,
    ode_solver: str = "midpoint",
    ode_steps: int = 100,
    seed: int = 0,
    verbose: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None, np.ndarray | None]:
    """Integrate the teacher ODE from fresh prior noise, keeping both ends.

    mask/cond (optional) are pools whose rows are drawn with replacement
    (numpy's default_rng(seed), as the JAX package draws them), so that the
    pairs follow the teacher's conditioning. The noise of each batch of
    `batch_size` (the last padded with copies of its first row) comes from
    one `torch.Generator(device).manual_seed(seed)`. Returns (x1, x0, mask,
    cond) numpy arrays in normalised space: x1 the teacher's sample, x0 the
    noise it was integrated from."""
    if model.loss_type not in ("FM-OT", "CFM", "CFM-OT", "reflow", "diffusion"):
        # droid's VE prior is t_max * N(0, 1), which the reflow student's
        # N(0, 1) sampler cannot reproduce
        raise ValueError(
            "reflow pair generation requires an ODE teacher with a N(0,1) "
            f"prior; got loss_type={model.loss_type!r}")
    if model.use_normaliser:
        raise NotImplementedError(
            "reflow pairs must live in the network's input space; teachers "
            "with in-model normalisation are not supported")
    rng_np = np.random.default_rng(seed)
    idx = rng_np.integers(0, len(mask) if mask is not None else len(cond), n_pairs) \
        if (mask is not None or cond is not None) else None
    mask_all = mask[idx] if mask is not None else None
    cond_all = cond[idx] if cond is not None else None

    device = next(net.parameters()).device
    gen = torch.Generator(device).manual_seed(seed)
    shape = (batch_size, model.num_particles, model.features)
    folded = is_folded(net)
    model.fold_weight_norm(net)
    x0s, x1s = [], []
    n_batches = (n_pairs + batch_size - 1) // batch_size
    try:
        for b in range(n_batches):
            s, e = b * batch_size, min((b + 1) * batch_size, n_pairs)
            sel = np.arange(s, e)
            if len(sel) < batch_size:
                sel = np.concatenate([sel, np.full(batch_size - len(sel), s)])
            mb = _as(mask_all[sel], device) if mask_all is not None else None
            cb = _as(cond_all[sel], device) if cond_all is not None else None
            z = draw_noise(gen, shape, device)
            if mb is not None:
                z = z * mb
            x = z
            for k in reversed(range(model.n_transforms)):
                drift = model.make_drift(net, cond=cb, mask=mb, flow_idx=k)
                x = odeint_fixed(drift, x, 1.0, 0.0, ode_steps=ode_steps, method=ode_solver)
            if mb is not None:
                x = x * mb
            x0s.append(z[: e - s].cpu().numpy())
            x1s.append(x[: e - s].cpu().numpy())
            if verbose and (b % 10 == 0 or b == n_batches - 1):
                print(f"[reflow] pairs {e}/{n_pairs}")
    finally:
        if not folded:
            model.unfold_weight_norm(net)
    x1 = np.concatenate(x1s).astype(np.float32)
    x0 = np.concatenate(x0s).astype(np.float32)
    return x1, x0, mask_all, cond_all


@torch.no_grad()
def straightness(
    model, net, x1: np.ndarray, x0: np.ndarray,
    mask: np.ndarray | None, cond: np.ndarray | None, n_times: int = 8,
) -> float:
    """Mean squared deviation of the learned field from the straight-line
    field on the given coupling, E_t ||v(t, x_t) - (x0 - x1)||^2 (masked),
    at the midpoints of `n_times` equal intervals of t, on the folded
    network: 0 for a perfectly rectified flow (the reflow paper's S(Z))."""
    device = next(net.parameters()).device
    x1t, x0t = _as(x1, device), _as(x0, device)
    m = _as(mask, device) if mask is not None else torch.ones_like(x1t[..., :1])
    c = _as(cond, device)
    folded = is_folded(net)
    model.fold_weight_norm(net)
    try:
        u = (x0t - x1t) * m
        total = 0.0
        for i in range(n_times):
            t = torch.full((x1t.shape[0],), (i + 0.5) / n_times, dtype=torch.float32,
                           device=device)
            tb = t[:, None, None]
            y = (1.0 - tb) * x1t + tb * x0t
            v = model.vector_field(net, t, y, cond=c, mask=m)
            total = total + torch.sum(torch.square((v - u) * m)) / torch.sum(m)
    finally:
        if not folded:
            model.unfold_weight_norm(net)
    return float(total / n_times)


def student_model(teacher_model, sigma: float | None = None):
    """The student shares the teacher's architecture; only the objective
    (and optionally sigma) changes."""
    return dataclasses.replace(
        teacher_model,
        loss_type="reflow",
        sigma=teacher_model.sigma if sigma is None else sigma,
    )
