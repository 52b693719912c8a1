"""ODE integrators; counterpart of particle_fm_tpu/samplers/ode.py.

Step-count convention as in the JAX package: `ode_steps - 1` uniform steps
from t0 to t1, so NFE per set is ode_steps-1 (euler, ab2), 2*(ode_steps-1)
(midpoint, heun) and 4*(ode_steps-1) (rk4).

The time grid is bit-identical to the JAX scan's: t_k = t0 + float32(k) * dt
and the midpoint stage t_k + 0.5*dt, each operation rounded to float32 in the
same order (`dt` itself is the float32 rounding of the float64 quotient, as
JAX casts a Python float against a float32 array). The grid is built on the
CPU and moved to the device once, and the drift receives 0-dim float32
tensors, so the loop never waits on the host.

`odeint_fixed_sc` is the fixed-step loop of self-conditioned fields, which
carry the data-endpoint estimate from one evaluation to the next.

Inside `exported_loops()` (serving.py's program, as `torch.export` traces
it) every loop is one `while_loop` whose body is one step, as the JAX
package's exported scan and while loop are: the program holds one step's
graph whatever the step count, so that it exports and loads in seconds.
The fixed-step loops (Euler, midpoint, Heun, RK4, the Adams loops after
their bootstrap steps, the self-conditioned loop, and samplers/sde.py's em
and DDIM) test a step counter on the host (no device read a step), and
compute the step's times from a float32 step index on the state's device in
the operations and order of `time_grid`, so the exported loop computes what
the Python loop computes, bit for bit. The DOPRI5 loops carry t, dt and the
attempt count on the device and test them there, as the JAX loop does; they
return their statistics as tensors, and warn of nothing: the program's
caller reads `reached` (serving.py).

A network that computes in bfloat16 may return a bfloat16 field while the
state stays float32. Its promotion follows JAX's: a Python float (the fixed
steppers' dt) keeps the product in bfloat16 before it meets the float32
state, as a weakly typed JAX scalar does; where the JAX solver multiplies by
a float32 array (the Adams steps' dt, the time of the self-conditioned
estimate, the DOPRI5 stages), JAX computes in float32, and so the field is
cast to the state's type there first (a 0-dim float32 tensor would leave the
product in bfloat16).

`odeint_dopri5` is the adaptive Dormand-Prince 5(4) of the JAX package's
`lax.while_loop`, with one step size and one error norm for the whole batch.
t and dt are float32 tensors on the device, updated as the JAX loop's
`jnp.where` updates them (Python floats would round differently and change
which steps are accepted); the loop condition costs one host read a step.
`odeint_dopri5_per_sample` is what the JAX package gets by `vmap` over that
loop: every set has its own t, dt, error norm and step count, a set that is
done stops changing, and each stage is one network call on the whole batch
with per-set times (B,).
"""

from __future__ import annotations

import contextlib
import functools
import warnings
from typing import Callable

import numpy as np
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
    if exporting():
        dt = (t1 - t0) / (ode_steps - 1)
        t_of, half, whole = _grid_times(x0, t0, dt)

        def advance(k, x):
            t = t_of(k)
            return (stepper(f, t, t + half, t + whole, dt, x),)

        return step_loop(advance, (x0,), 0, ode_steps - 1)[0]
    ts, dt = time_grid(t0, t1, ode_steps)
    # the stage times t + 0.5*dt and t + dt, rounded as the JAX steppers round them
    grid = torch.stack([ts, ts + _f32(0.5 * dt), ts + _f32(dt)], dim=1).to(x0.device)
    x = x0
    for t, t_half, t_next in grid:
        x = stepper(f, t, t_half, t_next, dt, x)
    return x


_exporting = [0]  # depth of `exported_loops` blocks


@contextlib.contextmanager
def exported_loops():
    """A block in which every loop of the samplers is built as one
    `while_loop`, the form of an exported program (serving.py)."""
    _exporting[0] += 1
    try:
        yield
    finally:
        _exporting[0] -= 1


def exporting() -> bool:
    """Whether the loops are being built for an exported program."""
    return _exporting[0] > 0


def _full(like: torch.Tensor, v: float, dtype=torch.float32) -> torch.Tensor:
    """A 0-dim constant as an op of the program (a tensor made from data
    would be a constant inside the loop's graph, which `torch.export.save`
    refuses on torch 2.11)."""
    return torch.full((), v, dtype=dtype, device=like.device)


def step_loop(step, state: tuple, k0: int, n: int) -> tuple:
    """Steps k0..n-1 of a fixed-step loop as one `while_loop` of an exported
    program: step(k, *state) -> state, with k the step index as a float32 on
    the state's device (from which the step computes its times). Carried:
    the step on the host (the loop's test), k, the state."""
    from torch._higher_order_ops.while_loop import while_loop

    def cond(i, k, *s):
        return i < n

    def body(i, k, *s):
        return (i + 1, k + 1) + tuple(step(k, *s))

    carried = (torch.full((), k0, dtype=torch.int64), _full(state[0], k0)) + tuple(state)
    return tuple(while_loop(cond, body, carried)[2:])


def _grid_times(like, t0: float, dt: float):
    """t(k) = t0 + k * dt for a float32 step index k, as `time_grid`
    computes t_k, and the stage offsets 0.5*dt and dt as its grid adds them."""
    start, step, half = (_full(like, v) for v in (t0, dt, 0.5 * dt))
    return (lambda k: start + k * step), half, step


def _odeint_adams(f: Drift, x0, t0, t1, ode_steps: int, order: int):
    """Adams-Bashforth of order 2 (euler bootstrap) or 3 (midpoint bootstrap
    for step 0, AB2 for step 1): one drift evaluation per step after the
    bootstrap. The bootstrap times t0 + k*dt are taken in float64 and then
    rounded, as the JAX version passes Python floats there; the loop after
    them carries (x, the previous fields)."""
    n = ode_steps - 1
    dt = (t1 - t0) / n

    def t_at(k):
        return _full(x0, t0 + k * dt)

    def step(v):  # dt times a field, as JAX's float32 dt computes it
        return dt * v.to(x0.dtype)

    if order == 2:
        def combine(fk, f_prev):
            return 1.5 * fk - 0.5 * f_prev
    else:
        def combine(fk, fm1, fm2):
            return 23.0 / 12.0 * fk - 16.0 / 12.0 * fm1 + 5.0 / 12.0 * fm2

    f0 = f(t_at(0), x0)
    if order == 2:
        state, k0 = (x0 + step(f0), f0), 1
    else:
        k1 = f(t_at(0.5), x0 + 0.5 * step(f0))
        x1 = x0 + step(k1)
        if n == 1:
            return x1
        f1 = f(t_at(1), x1)
        state, k0 = (x1 + step(1.5 * f1 - 0.5 * f0), f1, f0), 2
    if k0 >= n:  # as in JAX, no loop after the bootstrap steps
        return state[0]

    def advance(t, x, *previous):
        fk = f(t, x)
        kept = previous[:-1]
        if exporting():  # a while_loop's output may not be its input: the kept field a copy
            kept = tuple(p.clone() for p in kept)
        return (x + step(combine(fk, *previous)), fk) + kept

    if exporting():
        t_of = _grid_times(x0, t0, dt)[0]
        return step_loop(lambda k, *s: advance(t_of(k), *s), state, k0, n)[0]
    ts, _ = time_grid(t0, t1, ode_steps)
    ts = ts.to(x0.device)
    for k in range(k0, n):
        state = advance(ts[k], *state)
    return state[0]


def odeint_fixed_sc(f, x0: torch.Tensor, t0: float = 1.0, t1: float = 0.0, ode_steps: int = 100,
                    method: str = "midpoint") -> torch.Tensor:
    """Fixed-step integration of a self-conditioned field f(t, x, x1_hat)
    that returns the physical drift dx/dt. The carried x1_hat is the
    endpoint estimate x - t * f(t, x, x1_hat) of the latest grid evaluation
    (zeros before the first). euler or midpoint."""
    if method not in ("euler", "midpoint"):
        raise ValueError(f"self-conditioned sampling supports euler/midpoint, got {method}")
    dt = (t1 - t0) / (ode_steps - 1)

    def advance(t, t_half, x, sc):
        v1 = f(t, x, sc)
        sc = x - t * v1.to(x.dtype)
        if method == "euler":
            return x + dt * v1, sc
        return x + dt * f(t_half, x + 0.5 * dt * v1, sc), sc

    state = (x0, torch.zeros_like(x0))
    if exporting():
        t_of, half, _ = _grid_times(x0, t0, dt)

        def step(k, x, sc):
            t = t_of(k)
            return advance(t, t + half, x, sc)

        return step_loop(step, state, 0, ode_steps - 1)[0]
    ts, _ = time_grid(t0, t1, ode_steps)
    for t, t_half in torch.stack([ts, ts + _f32(0.5 * dt)], dim=1).to(x0.device):
        state = advance(t, t_half, *state)
    return state[0]


# Dormand-Prince 5(4): nodes and weights rounded to float32 as the JAX
# package's jnp.array tables round them; the stage coefficients stay Python
# floats, rounded where they meet a float32 tensor, as JAX rounds them.
_DP_C = [float(c) for c in np.float32([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])]
_DP_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_DP_B5 = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0]
_DP_B4 = [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40]


def _dp_weight_ops(device: torch.device, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The 5th- and 4th-order weights, rounded to float32 as the JAX package's
    are and then held in the state's dtype, on `device`, built by ops (the
    form an exported program takes them in)."""
    return tuple(torch.stack([torch.full((), v, dtype=torch.float32, device=device) for v in w])
                 .to(dtype) for w in (_DP_B5, _DP_B4))


_dp_weights = functools.lru_cache(maxsize=None)(_dp_weight_ops)  # the live loops': built once


def _dp_stages(f: Drift, t: torch.Tensor, dt: torch.Tensor, x: torch.Tensor):
    """(5th-order solution, its difference to the 4th-order one) of one
    step. t and dt are 0-dim, or (B,) with one value per set."""
    dtb = dt.reshape(dt.shape + (1,) * (x.ndim - dt.ndim))
    ks = []
    for i in range(7):
        xi = x
        for j, aij in enumerate(_DP_A[i]):
            xi = xi + dtb * aij * ks[j]
        ks.append(f(t + _DP_C[i] * dt, xi).to(x.dtype))
    k = torch.stack(ks)
    b5, b4 = (_dp_weight_ops if exporting() else _dp_weights)(x.device, k.dtype)
    x5 = x + dtb * torch.tensordot(b5, k, dims=1)
    x4 = x + dtb * torch.tensordot(b4, k, dims=1)
    return x5, x5 - x4


def _error_ratio(err, x, x_new, rtol, atol, dims):
    scale = atol + rtol * torch.maximum(torch.abs(x), torch.abs(x_new))
    return torch.sqrt(torch.mean(torch.square(err / scale), dim=dims))


def _dopri5_start(x0, t0, t1, init_dt, shape=()):
    """(direction, t, dt) at the start, t and dt in the state's dtype as in
    the JAX loop (a float64 state is integrated in float64 time)."""
    direction = 1.0 if t1 > t0 else -1.0
    dt0 = direction * (init_dt if init_dt is not None else abs(t1 - t0) / 50.0)
    t = torch.full(shape, t0, dtype=x0.dtype, device=x0.device)
    dt = torch.full(shape, dt0, dtype=x0.dtype, device=x0.device)
    return direction, t, dt


def _dopri5_update(f, t, dt, x, t1, direction, rtol, atol, safety, dims):
    """One attempted step: (t, x, dt) after it, as the JAX loop body, and
    whether it was accepted."""
    dt = torch.where(direction * (t + dt - t1) > 0, t1 - t, dt)
    x_new, err = _dp_stages(f, t, dt, x)
    en = _error_ratio(err, x, x_new, rtol, atol, dims)
    accept = en <= 1.0
    factor = torch.clamp(safety * (1.0 / torch.clamp_min(en, 1e-10)) ** 0.2, 0.2, 5.0)
    t = torch.where(accept, t + dt, t)
    x = torch.where(accept.reshape(accept.shape + (1,) * (x.ndim - accept.ndim)), x_new, x)
    return t, x, dt * factor, accept


def _running(direction, t, t1, n, max_steps):
    """Whether an integration (or each set's) goes on: short of t1 and of
    the step budget, the JAX loop's test."""
    return (direction * (t1 - t) > 1e-10) & (n < max_steps)


def truncation_warning(max_steps: int, t: float, t1: float, stacklevel: int = 2) -> None:
    """The warning of a DOPRI5 run that spent its step budget short of t1."""
    warnings.warn(
        f"odeint_dopri5: step budget ({max_steps}) exhausted at t={t} before "
        f"reaching t1={t1}; the result is truncated (raise max_steps or loosen rtol/atol)",
        RuntimeWarning, stacklevel=stacklevel + 1,
    )


def odeint_dopri5(f: Drift, x0: torch.Tensor, t0: float = 1.0, t1: float = 0.0,
                  rtol: float = 1e-4, atol: float = 1e-4, init_dt: float | None = None,
                  max_steps: int = 1000, safety: float = 0.9, warn_on_truncation: bool = True,
                  return_stats: bool = False):
    """Adaptive DOPRI5 with one step size for the whole batch.

    A run that spends `max_steps` attempts before reaching t1 is truncated:
    it warns (`warn_on_truncation`), and with `return_stats` the result is
    (x, {"steps": attempts, "reached": bool}). Inside `exported_loops()` the
    loop is one `while_loop` on the device, and the statistics are tensors,
    with the end time "t" beside them; nothing warns."""
    direction, t, dt = _dopri5_start(x0, t0, t1, init_dt)
    if exporting():
        from torch._higher_order_ops.while_loop import while_loop

        def cond(t, dt, x, n):
            return _running(direction, t, t1, n, max_steps)

        def body(t, dt, x, n):
            t, x, dt, _ = _dopri5_update(f, t, dt, x, t1, direction, rtol, atol, safety, None)
            return t, dt, x, n + 1

        n0 = torch.zeros((), dtype=torch.int64, device=x0.device)
        t, _, x, n = while_loop(cond, body, (t, dt, x0, n0))
        stats = {"steps": n, "reached": direction * (t1 - t) <= 1e-10, "t": t}
        return (x, stats) if return_stats else x
    x, n = x0, 0
    while n < max_steps and bool(direction * (t1 - t) > 1e-10):
        t, x, dt, _ = _dopri5_update(f, t, dt, x, t1, direction, rtol, atol, safety, None)
        n += 1
    reached = bool(direction * (t1 - t) <= 1e-10)
    if warn_on_truncation and not reached:
        truncation_warning(max_steps, float(t), t1)
    if return_stats:
        return x, {"steps": n, "reached": reached}
    return x


def odeint_dopri5_per_sample(f: Drift, x0: torch.Tensor, t0: float = 1.0, t1: float = 0.0,
                             rtol: float = 1e-4, atol: float = 1e-4,
                             init_dt: float | None = None, max_steps: int = 1000,
                             safety: float = 0.9, return_stats: bool = False):
    """Adaptive DOPRI5 with its own step size per set (the leading axis of
    x0), in one batched loop: f is called with per-set times (B,). With
    `return_stats`: (x, {"steps": attempts per set (B,), "loops": network
    passes per stage, "reached": per set (B,), "accepted": (loops, B), which
    attempts each set accepted}). No truncation warning, as the JAX package
    gives none under vmap. Inside `exported_loops()` the loop is one
    `while_loop` on the device, and the statistics are tensors, without
    "accepted"."""
    b = x0.shape[0]
    dims = tuple(range(1, x0.ndim))
    direction, t, dt = _dopri5_start(x0, t0, t1, init_dt, (b,))

    def attempt(t, dt, x, n):
        active = _running(direction, t, t1, n, max_steps)
        t_new, x_new, dt_new, accept = _dopri5_update(f, t, dt, x, t1, direction, rtol, atol,
                                                      safety, dims)
        t = torch.where(active, t_new, t)
        x = torch.where(active.reshape((b,) + (1,) * (x.ndim - 1)), x_new, x)
        dt = torch.where(active, dt_new, dt)
        return t, dt, x, n + active.to(torch.int64), active & accept

    n = torch.zeros(b, dtype=torch.int64, device=x0.device)
    if exporting():
        from torch._higher_order_ops.while_loop import while_loop

        def cond(t, dt, x, n, loops):
            return _running(direction, t, t1, n, max_steps).any()

        def body(t, dt, x, n, loops):
            return attempt(t, dt, x, n)[:4] + (loops + 1,)

        t, _, x, n, loops = while_loop(cond, body, (t, dt, x0, n, torch.zeros_like(n[0])))
        stats = {"steps": n, "loops": loops, "reached": direction * (t1 - t) <= 1e-10}
        return (x, stats) if return_stats else x
    x, accepted = x0, []
    while bool(_running(direction, t, t1, n, max_steps).any()):
        t, dt, x, n, took = attempt(t, dt, x, n)
        accepted.append(took)
    if return_stats:
        return x, {"steps": n, "loops": len(accepted), "reached": direction * (t1 - t) <= 1e-10,
                   "accepted": torch.stack(accepted) if accepted else
                   torch.zeros((0, b), dtype=torch.bool, device=x0.device)}
    return x
