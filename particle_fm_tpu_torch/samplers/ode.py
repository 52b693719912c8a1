"""Fixed-step ODE integrators; counterpart of particle_fm_tpu/samplers/ode.py.

Step-count convention as in the JAX package: `ode_steps - 1` uniform steps
from t0 to t1, so NFE per set is ode_steps-1 (euler, ab2), 2*(ode_steps-1)
(midpoint, heun) and 4*(ode_steps-1) (rk4).

The time grid is bit-identical to the JAX scan's: t_k = t0 + float32(k) * dt
and the midpoint stage t_k + 0.5*dt, each operation rounded to float32 in the
same order (`dt` itself is the float32 rounding of the float64 quotient, as
JAX casts a Python float against a float32 array). The grid is built on the
CPU and moved to the device once, and the drift receives 0-dim float32
tensors, so the loop never waits on the host.
"""

from __future__ import annotations

from typing import Callable

import torch

Drift = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # f(t, x) -> dx/dt

FIXED_SOLVERS = ("euler", "midpoint", "heun", "rk4", "ab2", "ab3")


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def time_grid(t0: float, t1: float, ode_steps: int) -> tuple[torch.Tensor, float]:
    """(t_k for k < ode_steps-1 as float32, dt as a Python float)."""
    n = ode_steps - 1
    dt = (t1 - t0) / n
    k = torch.arange(n, dtype=torch.float32)
    return _f32(t0) + k * _f32(dt), dt


def _euler_step(f: Drift, t, t_half, t_next, dt, x):
    return x + dt * f(t, x)


def _midpoint_step(f: Drift, t, t_half, t_next, dt, x):
    k1 = f(t, x)
    return x + dt * f(t_half, x + 0.5 * dt * k1)


def _heun_step(f: Drift, t, t_half, t_next, dt, x):
    k1 = f(t, x)
    k2 = f(t_next, x + dt * k1)
    return x + 0.5 * dt * (k1 + k2)


def _rk4_step(f: Drift, t, t_half, t_next, dt, x):
    k1 = f(t, x)
    k2 = f(t_half, x + 0.5 * dt * k1)
    k3 = f(t_half, x + 0.5 * dt * k2)
    k4 = f(t_next, x + dt * k3)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


_STEPPERS = {
    "euler": _euler_step,
    "midpoint": _midpoint_step,
    "heun": _heun_step,
    "rk4": _rk4_step,
}


def odeint_fixed(
    f: Drift,
    x0: torch.Tensor,
    t0: float = 1.0,
    t1: float = 0.0,
    ode_steps: int = 100,
    method: str = "midpoint",
) -> torch.Tensor:
    """Integrate dx/dt = f(t, x) from t0 to t1 with `ode_steps - 1` uniform steps."""
    if method in ("ab2", "ab3"):
        return _odeint_adams(f, x0, t0, t1, ode_steps, order=int(method[-1]))
    stepper = _STEPPERS[method]
    ts, dt = time_grid(t0, t1, ode_steps)
    # the stage times t + 0.5*dt and t + dt, rounded as the JAX steppers round them
    grid = torch.stack([ts, ts + _f32(0.5 * dt), ts + _f32(dt)], dim=1).to(x0.device)
    x = x0
    for t, t_half, t_next in grid:
        x = stepper(f, t, t_half, t_next, dt, x)
    return x


def _odeint_adams(f: Drift, x0, t0, t1, ode_steps: int, order: int):
    """Adams-Bashforth of order 2 (euler bootstrap) or 3 (midpoint bootstrap
    for step 0, AB2 for step 1): one drift evaluation per step after the
    bootstrap. The bootstrap times t0 + k*dt are taken in float64 and then
    rounded, as the JAX version passes Python floats there."""
    ts, dt = time_grid(t0, t1, ode_steps)
    ts = ts.to(x0.device)
    n = ts.shape[0]

    def t_at(k):
        return _f32(t0 + k * dt).to(x0.device)

    f0 = f(t_at(0), x0)
    if order == 2:
        x = x0 + dt * f0
        f_prev = f0
        for k in range(1, n):
            fk = f(ts[k], x)
            x = x + dt * (1.5 * fk - 0.5 * f_prev)
            f_prev = fk
        return x

    k1 = f(t_at(0.5), x0 + 0.5 * dt * f0)
    x1 = x0 + dt * k1
    if n == 1:
        return x1
    f1 = f(t_at(1), x1)
    x = x1 + dt * (1.5 * f1 - 0.5 * f0)
    fm1, fm2 = f1, f0
    for k in range(2, n):
        fk = f(ts[k], x)
        x = x + dt * (23.0 / 12.0 * fk - 16.0 / 12.0 * fm1 + 5.0 / 12.0 * fm2)
        fm1, fm2 = fk, fm1
    return x
