#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (particle_fm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the
   kernel library from csrc/ with nvcc (build time on its own line).
2. Kernel phase: the fused EPiC layer (csrc/epic_layer.cu) at the
   JetNet-150 flagship shapes (B=640, N=150, H=128, L=10, t=32, C=2, float32,
   multiplicities 30-150) against its plain PyTorch version on the card,
   atol 1e-4 / rtol 1e-4, and both timed with CUDA events in turns (plain,
   kernel, kernel, plain; each 20 calls back to back between two events,
   the median of 5 such runs, after 5 calls of warm-up).
3. Serving phase: the fm_tops150_cond configuration at full width (seeded
   random weights; the repo has no trained checkpoint) answers requests of
   1000, 640 and 7 jets through `make_serve_fn`/`serve_batches`: batch 640,
   midpoint, ode_steps=51 (100 network evaluations). Checks finite outputs,
   zero padded rows, and 6 layers x 100 evaluations x 4 batches kernel
   launches; then the same requests run with the EPiC layer's plain version
   and must agree within atol 1e-3, and a small batch must agree with the
   CPU within atol 1e-4. Prints jets/s of both paths, each the mean of two
   runs taken in turns (kernel, plain, plain, kernel).
4. Prints the `kernels` JSON line, the card line again, and as the last
   line {"ok": true, "device": {...}}.

Every failure exits non-zero before the last line. The script needs the
repository beside it and a CUDA device; it imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent

# flagship kernel shapes and the H100 SXM's published peaks
B, N, H, L, T, C = 640, 150, 128, 10, 32, 2
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
KERNEL_TOL = 1e-4
PATH_TOL = 1e-3
CPU_TOL = 1e-4
REQUESTS = (1000, 640, 7)
SERVE_BATCH = 640
ODE_STEPS = 51


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ragged_mask(rs: np.random.RandomState, b: int, n: int, lo: int = 30) -> np.ndarray:
    counts = rs.randint(lo, n + 1, size=(b, 1))
    return (np.arange(n)[None, :] < counts).astype(np.float32)


def kernel_phase(torch, ops, dev) -> dict:
    from particle_fm_tpu_torch.utils.timing import cuda_ms

    gen = torch.Generator().manual_seed(0)

    def lin(fan_in, *shape):
        bound = fan_in ** -0.5
        return (torch.rand(*shape, generator=gen) * 2 - 1) * bound

    k1, k2, k3, k4 = T + 2 * H + L + C, T + H + C, T + L + C, T + C
    rs = np.random.RandomState(0)
    inputs = [
        torch.randn(B, N, H, generator=gen),
        torch.randn(B, L, generator=gen),
        torch.from_numpy(ragged_mask(rs, B, N)),
        torch.randn(B, T + C, generator=gen),
        lin(k1, k1, H), lin(k1, H), lin(k2, k2, L), lin(k2, L),
        lin(k3, H, H), lin(k3, k3, H), lin(k3, H),
        lin(k4, H, H), lin(k4, k4, H), lin(k4, H),
    ]
    args = [a.to(dev).contiguous() for a in inputs]
    dims = dict(sum_scale=1e-2, tg_dim=T, tl_dim=T, c_dim=C)

    xo, go = ops.epic_layer(*args, **dims)
    torch.cuda.synchronize()
    rx, rg = ops.epic_layer_reference(*args, **dims)
    if not (torch.isfinite(xo).all() and torch.isfinite(go).all()):
        fail("epic_layer kernel gave non-finite values")
    err = max((xo - rx).abs().max().item(), (go - rg).abs().max().item())
    for got, want in ((xo, rx), (go, rg)):
        if not torch.allclose(got, want, atol=KERNEL_TOL, rtol=KERNEL_TOL):
            fail(f"epic_layer kernel disagrees with its plain version: max abs err {err}")

    # in turns (plain, kernel, kernel, plain), so clock ramps hit both alike
    kernel_fn = lambda: ops.epic_layer(*args, **dims)
    plain_fn = lambda: ops.epic_layer_reference(*args, **dims)
    turns = [cuda_ms(f) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn)]
    ms, plain_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2

    # least time for the same work: each input read once and each output
    # written once, against the multiply-adds of the pool, the per-set MLPs
    # and the two H x H local matmuls plus their five elementwise operations
    n_bytes = sum(a.numel() * a.element_size() for a in args) + 4 * (B * N * H + B * L)
    flops = (2 * B * N * H + 2 * B * (k1 * H + k2 * L + k3 * H + k4 * H)
             + 2 * 2 * B * N * H * H + 5 * B * N * H)
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return {
        "name": "epic_layer",
        "route": "cuda",
        "source": "particle_fm_tpu_torch/csrc/epic_layer.cu",
        "replaces": "particle_fm_tpu/ops/pallas/epic_layer.py:113",
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,  # no single PyTorch call computes an EPiC layer
        "turns_ms": {"plain": [turns[0], turns[3]], "kernel": [turns[1], turns[2]]},
        "shape": {"B": B, "N": N, "H": H, "L": L, "t": T, "C": C, "dtype": "float32"},
        "bytes": n_bytes,
        "flops": flops,
    }


def serving_phase(torch, ops, dev) -> dict:
    from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel
    from particle_fm_tpu_torch.serving import make_serve_fn, serve_batches

    # configs/experiment/jetnet/fm_tops150_cond.yaml on configs/model/flow_matching.yaml
    model = FlowMatchingModel(
        model="epic", features=3, num_particles=150, frequencies=16, hidden_dim=128,
        layers=6, latent=10, t_emb="cosine", t_global_cat=True, t_local_cat=True,
        add_time_to_input=False, global_cond_dim=2, local_cond_dim=2, loss_type="FM-OT",
    )
    net = model.init(seed=0, device=dev)
    proto = dict(batch_size=SERVE_BATCH, ode_solver="midpoint", has_cond=True, has_mask=True,
                 means=[0.0, 0.0, 0.05], stds=[0.1, 0.1, 0.06])
    fn = make_serve_fn(model, net, ode_steps=ODE_STEPS, **proto)
    warm = make_serve_fn(model, net, ode_steps=2, **proto)

    rs = np.random.RandomState(1)
    reqs = [(ragged_mask(rs, n, 150)[..., None], rs.randn(n, 2).astype(np.float32))
            for n in REQUESTS]
    n_batches = sum(-(-n // SERVE_BATCH) for n in REQUESTS)
    want_launches = model.layers * 2 * (ODE_STEPS - 1) * n_batches

    def answer(f):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [serve_batches(f, f.meta, len(m), cond=c, mask=m, seed=10 + i)
                for i, (m, c) in enumerate(reqs)]
        torch.cuda.synchronize()
        return outs, time.perf_counter() - t0

    answer(warm)
    ops.epic_layer.launches = 0
    outs, secs = answer(fn)  # the main path
    launches = ops.epic_layer.launches

    for (m, _), out in zip(reqs, outs):
        if out.shape != (len(m), 150, 3):
            fail(f"served shape {out.shape}, expected {(len(m), 150, 3)}")
        if not np.isfinite(out).all():
            fail("served samples are not finite")
        if np.abs(out[m[..., 0] == 0]).max(initial=0.0) != 0.0:
            fail("padded rows of the served samples are not zero")
    if launches != want_launches:
        fail(f"epic_layer launched {launches} times on the serving path, expected {want_launches}")

    # then in turns with the EPiC layer's plain version: plain, plain, kernel
    with mock.patch.object(ops, "epic_layer", ops.epic_layer_reference):
        answer(warm)
        plain_outs, plain_secs = answer(fn)
        plain_secs2 = answer(fn)[1]
    secs2 = answer(fn)[1]
    path_err = max(float(np.abs(a - b).max()) for a, b in zip(outs, plain_outs))
    if not path_err <= PATH_TOL:
        fail(f"kernel path and plain path disagree after 100 evaluations: {path_err}")

    # a small input against the CPU, with the same noise and weights
    gen = torch.Generator().manual_seed(2)
    mask = torch.from_numpy(ragged_mask(rs, 8, 150)[..., None])
    cond = torch.randn(8, 2, generator=gen)
    z = torch.randn(8, 150, 3, generator=gen) * mask
    gpu = model.integrate(net, z.to(dev), cond.to(dev), mask.to(dev), "midpoint", 5).cpu()
    cpu_net = copy.deepcopy(net).cpu()
    cpu = model.integrate(cpu_net, z, cond, mask, "midpoint", 5)
    cpu_err = float((gpu - cpu).abs().max())
    if not cpu_err <= CPU_TOL:
        fail(f"small batch on the card disagrees with the CPU: {cpu_err}")

    jets = sum(REQUESTS)
    return {
        "config": "fm_tops150_cond (seeded random weights)",
        "requests": list(REQUESTS), "batch": SERVE_BATCH, "batches": n_batches,
        "ode_solver": "midpoint", "ode_steps": ODE_STEPS, "nfe": 2 * (ODE_STEPS - 1),
        "kernel_path_s": [secs, secs2], "plain_path_s": [plain_secs, plain_secs2],
        "kernel_path_jets_per_s": 2 * jets / (secs + secs2),
        "plain_path_jets_per_s": 2 * jets / (plain_secs + plain_secs2),
        "kernel_path_batch_jets_per_s": 2 * n_batches * SERVE_BATCH / (secs + secs2),
        "plain_path_batch_jets_per_s": 2 * n_batches * SERVE_BATCH / (plain_secs + plain_secs2),
        "epic_layer_launches": launches,
        "max_abs_diff_kernel_vs_plain": path_err, "max_abs_diff_card_vs_cpu": cpu_err,
    }


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available; this script runs on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    try:
        import particle_fm_tpu_torch
        from particle_fm_tpu_torch.ops import epic_layer as ops
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    if Path(particle_fm_tpu_torch.__file__).resolve().parent.parent != ROOT:
        fail(f"imported the port from {particle_fm_tpu_torch.__file__}, not from {ROOT}")

    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    lib = ops.build_library()
    ops.load_library()
    print(json.dumps({"build_s": time.perf_counter() - t0, "library": lib.name}), flush=True)
    log = lib.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("ptxas:", line.strip())

    kernel = kernel_phase(torch, ops, dev)
    print(json.dumps({"kernel_phase": kernel}), flush=True)
    serving = serving_phase(torch, ops, dev)
    print(json.dumps({"serving": serving}), flush=True)
    kernel["launches"] = serving["epic_layer_launches"]

    print(json.dumps({"kernels": [kernel]}))
    print(card)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
