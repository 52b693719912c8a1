"""Serving the sampler; counterpart of particle_fm_tpu/serving.py.

`make_serve_fn` binds a model, its network and the sampling protocol into
fn(seed, [cond], [mask]) -> samples in physical units (the datamodule-level
inverse z-score x * std / sigma + mean, then the mask re-applied), and
`serve_batches` answers a request of any size with padded fixed-size
batches, one seed per batch derived as the JAX package derives it (hash_v1:
SeedSequence([seed, chunk])). The seed starts a `torch.Generator` on the
network's device. There is no exported artifact: the function runs the
PyTorch program itself. A model built with `dtype="bfloat16"` serves in it:
the network computes in bfloat16, while the noise, cond, mask, the solver's
state and the output stay float32.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def make_serve_fn(
    model,
    net,
    *,
    batch_size: int,
    ode_solver: str = "midpoint",
    ode_steps: int = 100,
    num_points: Optional[int] = None,
    has_cond: bool = False,
    has_mask: bool = False,
    means=None,
    stds=None,
    normalize_sigma: float = 5.0,
    guidance_scale: Optional[float] = None,
) -> Callable:
    """fn(seed, [cond (B, C)], [mask (B, N, 1)]) -> (B, N, F) float32 tensor
    on the network's device. `fn.meta` describes the calling convention for
    `serve_batches`."""
    if guidance_scale is not None and not has_cond:
        raise ValueError("guidance_scale requires a conditional sampler (has_cond)")
    device = next(net.parameters()).device

    def as_tensor(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    means_t = None if means is None else as_tensor(means)
    stds_t = None if stds is None else as_tensor(stds)

    def serve(seed, *args):
        idx = 0
        cond = mask = None
        if has_cond:
            cond, idx = as_tensor(args[idx]), idx + 1
        if has_mask:
            mask = as_tensor(args[idx])
        gen = torch.Generator(device).manual_seed(int(seed))
        x = model.sample(
            net,
            gen,
            n_samples=batch_size,
            cond=cond,
            mask=mask,
            ode_solver=ode_solver,
            ode_steps=ode_steps,
            num_points=num_points,
            guidance_scale=guidance_scale,
        )
        if means_t is not None:
            x = x * (stds_t / normalize_sigma) + means_t
        if mask is not None:
            x = x * mask
        return x

    serve.meta = {
        "batch_size": int(batch_size),
        "cond_dim": int(model.global_cond_dim) if has_cond else 0,
        "use_mask": bool(has_mask),
        "ode_solver": str(ode_solver),
        "ode_steps": int(ode_steps),
        "guidance_scale": None if guidance_scale is None else float(guidance_scale),
        "seed_scheme": "hash_v1",
    }
    return serve


def chunk_seed(seed: int, chunk: int, scheme: str = "hash_v1") -> int:
    """The seed of one fixed-size batch of a request. Only the JAX
    package's current scheme, hash_v1, is carried: the port reads no legacy
    artifact."""
    if scheme == "hash_v1":
        return int(np.random.SeedSequence([int(seed) % (2**64), chunk]).generate_state(1)[0])
    raise ValueError(f"unknown seed_scheme {scheme!r}")


def serve_batches(
    fn: Callable,
    meta: dict,
    n_samples: int,
    cond: Optional[np.ndarray] = None,
    mask: Optional[np.ndarray] = None,
    seed: int = 0,
) -> np.ndarray:
    """Answer a request of `n_samples` sets in padded batches of
    meta["batch_size"]; the last batch is padded with copies of its first
    row, so padding never makes an empty set."""
    bs = int(meta["batch_size"])
    scheme = meta.get("seed_scheme", "hash_v1")
    chunks = []
    for i, lo in enumerate(range(0, n_samples, bs)):
        hi = min(lo + bs, n_samples)
        n_real = hi - lo

        def pad(a):
            sl = a[lo:hi]
            if n_real == bs:
                return sl
            return np.concatenate([sl] + [sl[:1]] * (bs - n_real), axis=0)

        args = [chunk_seed(seed, i, scheme)]
        if meta.get("cond_dim", 0):
            args.append(pad(cond).astype(np.float32))
        if meta.get("use_mask", False):
            args.append(pad(mask).astype(np.float32))
        chunks.append(fn(*args)[:n_real].cpu().numpy())
    return np.concatenate(chunks, axis=0)
