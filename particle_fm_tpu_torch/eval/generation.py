"""Batched generation driver; counterpart of particle_fm_tpu/eval/generation.py.

Parity: particle_fm/utils/data_generation.py:17-174. Batches through the
port's `FlowMatchingModel.sample`, inverse-normalizes on the host,
re-applies the mask, and measures wall-clock excluding the first batch
(warm-up, as the JAX package excludes its compilation).

The remainder batch is padded up to `batch_size` with copies of its first
row (and the extra samples discarded), as in the JAX package, so every batch
has one shape.

In a process group (torchrun) every rank calls it with the same arguments
and each batch is sampled rank-split (`FlowMatchingModel.sample`'s
`rank_split`): each rank integrates its rows of the batch's noise and every
rank returns the whole sample, equal to one process's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from particle_fm_tpu_torch.data.utils import inverse_normalize_tensor
from particle_fm_tpu_torch.parallel import dist
from particle_fm_tpu_torch.serving import chunk_seed
from particle_fm_tpu_torch.utils.device import resolve_device


def generate_data(
    model,
    net,
    num_jet_samples: int,
    batch_size: int = 256,
    cond: np.ndarray | None = None,
    variable_set_sizes: bool = False,
    mask: np.ndarray | None = None,
    normalized_data: bool = False,
    normalize_sigma: float = 5,
    means=None,
    stds=None,
    log_pt: bool = False,
    pt_standardization: bool = False,
    shuffle_mask: bool = False,
    verbose: bool = False,
    ode_solver: str = "midpoint",
    ode_steps: int = 100,
    seed: int = 0,
    scaler=None,
    num_points: int | None = None,
    guidance_scale: float | None = None,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, float]:
    """Sample num_jet_samples sets with the network `net` (on `device`, CUDA
    unless the caller asks for the CPU); returns (data (S, N, F),
    generation_time).

    Batch i draws its noise from a `torch.Generator` on the device seeded
    with `serving.chunk_seed(seed, i)`, as `serve_batches` seeds a batch.
    The port cannot replay the JAX package's `random.split` stream, so the
    samples of the two packages agree only where a test pins the noise.

    generation_time excludes the first batch; the copy of each batch to the
    host is the fence. `num_points` pins the generated set size when no mask
    is used; when a mask is supplied its particle axis is the set size."""
    if variable_set_sizes and mask is None:
        raise ValueError("Please use mask when using variable_set_sizes=True")
    if num_points is None and mask is not None:
        num_points = int(mask.shape[1])
    if mask is not None and len(mask) != num_jet_samples:
        raise ValueError(
            f"Mask should have the same length as num_jet_samples "
            f"({len(mask)} != {num_jet_samples})"
        )
    dev = resolve_device(device)
    net_dev = next(net.parameters()).device
    if net_dev.type != dev.type or dev.index not in (None, net_dev.index):
        raise ValueError(f"the network is on {net_dev}, generation asked for {dev}")
    mask_rs = np.random.default_rng(seed)

    def to_dev(a):
        return None if a is None else torch.as_tensor(np.asarray(a, np.float32), device=net_dev)

    n_batches = int(np.ceil(num_jet_samples / batch_size))
    chunks = []
    start_time = None

    for i in range(n_batches):
        lo = i * batch_size
        hi = min(lo + batch_size, num_jet_samples)
        n_real = hi - lo

        def pad(sliced):
            if n_real == batch_size:
                return sliced
            return np.concatenate(
                [sliced] + [sliced[:1]] * (batch_size - n_real), axis=0
            )

        cond_batch = pad(cond[lo:hi]) if cond is not None else None
        if variable_set_sizes:
            if shuffle_mask:
                perm = mask_rs.permutation(len(mask))
                mask_sel = mask[perm][:n_real]
            else:
                mask_sel = mask[lo:hi]
            mask_batch = pad(mask_sel)
        else:
            mask_batch = None
            mask_sel = None

        if i == 1:
            start_time = time.perf_counter()

        gen = torch.Generator(net_dev).manual_seed(chunk_seed(seed, i))
        out = model.sample(
            net,
            gen,
            n_samples=batch_size,
            cond=to_dev(cond_batch),
            mask=to_dev(mask_batch),
            ode_solver=ode_solver,
            ode_steps=ode_steps,
            num_points=num_points,
            guidance_scale=guidance_scale,
            rank_split=dist.is_initialized(),
        )
        batch = out.cpu().numpy()[:n_real]  # the copy to the host is the fence

        if normalized_data:
            if pt_standardization:
                # LHCO convention: (eta, phi) standardized with sigma=10,
                # pt with sigma=5 (data_generation.py:105-114)
                batch[..., :2] = inverse_normalize_tensor(
                    batch[..., :2], means[:2], stds[:2], sigma=10
                )
                batch[..., 2] = inverse_normalize_tensor(
                    batch[..., 2:3], means[2:3], stds[2:3], sigma=5
                )[..., 0]
            else:
                batch = inverse_normalize_tensor(batch, means, stds, sigma=normalize_sigma)
            if log_pt:
                batch[..., 2] = 1.0 - np.exp(batch[..., 2])
        if scaler is not None:
            # sklearn-style pipeline inverse-transform (reference
            # data_generation.py:177-308); applied to real hits only
            if mask_sel is not None:
                keep = mask_sel[..., 0] > 0
                batch[keep] = scaler.inverse_transform(batch[keep])
            else:
                batch = scaler.inverse_transform(batch)
        if variable_set_sizes:
            batch = batch * mask_sel
        chunks.append(batch)

    end_time = time.perf_counter()
    data = np.concatenate(chunks, axis=0)
    generation_time = (end_time - start_time) if start_time is not None else 0.0
    return data, generation_time


def measure_generation_timing(models_by_size: list, jets_to_generate: int = 1000,
                              batch_size: int = 256, ode_solver: str = "midpoint",
                              ode_steps: int = 100) -> tuple[list, list]:
    """Generation seconds per jet at several jet sizes: `models_by_size` =
    [(n_particles, model, net), ...], each generated on its network's
    device. Returns (sizes, seconds_per_jet)."""
    sizes, times = [], []
    for n, model, net in models_by_size:
        _, t = generate_data(model, net, num_jet_samples=jets_to_generate,
                             batch_size=batch_size, variable_set_sizes=False,
                             ode_solver=ode_solver, ode_steps=ode_steps,
                             device=next(net.parameters()).device)
        sizes.append(int(n))
        times.append(t / jets_to_generate)
    return sizes, times
