#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (particle_fm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the three
   kernel libraries from csrc/ with nvcc, one compiler per source, all
   started together (build time on its own line).
2. Kernel phases, each of the four kernels against its plain PyTorch version
   on the card at the shapes the serving paths give it, atol 1e-4 / rtol
   1e-4, and both timed with CUDA events in turns (plain, kernel, kernel,
   plain; each 20 calls back to back between two events, the median of 5 such
   runs, after 5 calls of warm-up):
   - the fused EPiC layer (csrc/epic_layer.cu) at the JetNet-150 flagship
     shapes (B=640, N=150, H=128, L=10, t=32, C=2, float32, multiplicities
     30-150);
   - packed short-set attention (csrc/short_attention.cu) at the PC-Droid
     transformer's shape (B=640, L=150, 16 heads of 16, ragged key mask,
     q/k/v as the three slices of one QKV projection), and once with a
     (B, H, L, L) bias at B=64;
   - fused short-set attention (same source) at the cross-attention model's
     two shapes (B=640, 16 heads of 8: 4 queries on 150 masked keys, 150
     queries on 4 keys; the times are those of one such pair), and once
     masked with a bias at Lq=37, Lk=150;
   - blockwise flash attention (csrc/flash_attention.cu) at MDMA's shape
     (B=32, one class-token query on 6000 keys with 1000-6000 real ones, 2
     heads of 128) and at the transformer's shape on 279-particle sets
     (B=256, Lq=Lk=279, 16 heads of 16, slices of one QKV projection), and
     checked only at B=4, Lq=Lk=1500, 4 heads of 128, masked and unmasked.
   Beside each: the least time the card could take (bytes over 3.35 TB/s
   against float32 operations over 67 TFLOP/s) and, for attention, one
   `scaled_dot_product_attention` call on the same tensors as a yardstick
   (the port never calls it).
3. Serving phases through `make_serve_fn`/`serve_batches`, midpoint,
   ode_steps=51 (100 network evaluations), float32, seeded random weights
   (the repo has no trained checkpoint), ragged masks and a random cond:
   - fm_tops150_cond (EPiC), batch 640, requests of 640 and 7 jets;
   - path A, fm_droid_transformer at full width (model_dim 256, 3 layers,
     16 heads, attn_impl=packed, scores_dtype=null), batch 640, requests of
     640 and 7 jets;
   - path B, fm_droid_crossattention at full width (model_dim 128, 8 layers,
     16 heads, 4 global tokens, attn_impl=fused), batch 640, 640 and 7 jets;
   - path C, calo/mdma_calo on flow_matching_mdma (4 features, 6000 hits,
     1-wide cond, hidden 256, latent 16, 8 layers) with net_config.num_heads=2,
     so that the head dim is 128 and attention(impl="auto") takes the flash
     kernel; batch 32, requests of 32 and 5 showers of 1000-6000 hits;
   - path D, lhco/jets_transformer on fm_droid_transformer (279 particles,
     5-wide cond) with attn_impl=flash, scores_dtype=null; batch 256,
     requests of 256 and 7 events of 30-279 particles.
   The transformer configurations zero-initialise their attention and
   output projections, so every parameter is re-drawn from a seed first, and
   the vector field must not be identically zero. Each phase sets the launch
   counts to 0, serves, and checks finite outputs, zero padded rows, the
   exact number of launches of its kernel and none of another path's; then
   the same requests run with the kernel's wrapper replaced by its plain
   version and must agree within atol 1e-3, and a small batch must agree
   with the CPU within atol 1e-4. Prints jets/s of both paths, each the mean
   of two runs taken in turns (kernel, plain, plain, kernel).
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
ODE_STEPS = 51
# operations per attention score beside the two products: scale, mask add,
# subtract the maximum, exponential, sum
SCORE_OPS = 5


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


def check_kernel(torch, name: str, got, want) -> float:
    """Max abs error of a kernel's result against its plain version's."""
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"{name} kernel gave non-finite values")
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, atol=KERNEL_TOL, rtol=KERNEL_TOL):
        fail(f"{name} kernel disagrees with its plain version: max abs err {err}")
    return err


def timed_in_turns(kernel_fn, plain_fn) -> dict:
    """plain, kernel, kernel, plain, so clock ramps hit both alike."""
    from particle_fm_tpu_torch.utils.timing import cuda_ms

    turns = [cuda_ms(f) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn)]
    return {"ms": (turns[1] + turns[2]) / 2, "plain_ms": (turns[0] + turns[3]) / 2,
            "turns_ms": {"plain": [turns[0], turns[3]], "kernel": [turns[1], turns[2]]}}


def bound(n_bytes: float, flops: float) -> dict:
    """Least time for the work: each input read once and each output written
    once, against the float32 operations at the CUDA cores' rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "flops": flops}


def kernel_phase(torch, ops, dev) -> dict:
    gen = torch.Generator().manual_seed(0)

    def lin(fan_in, *shape):
        bound_ = fan_in ** -0.5
        return (torch.rand(*shape, generator=gen) * 2 - 1) * bound_

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
    rx, rg = ops.epic_layer_reference(*args, **dims)
    err = max(check_kernel(torch, "epic_layer", xo, rx), check_kernel(torch, "epic_layer", go, rg))

    # the multiply-adds of the pool, the per-set MLPs and the two H x H local
    # matmuls plus their five elementwise operations
    n_bytes = sum(a.numel() * a.element_size() for a in args) + 4 * (B * N * H + B * L)
    flops = (2 * B * N * H + 2 * B * (k1 * H + k2 * L + k3 * H + k4 * H)
             + 2 * 2 * B * N * H * H + 5 * B * N * H)
    return {
        "name": "epic_layer",
        "route": "cuda",
        "source": "particle_fm_tpu_torch/csrc/epic_layer.cu",
        "replaces": "particle_fm_tpu/ops/pallas/epic_layer.py:113",
        "launches": None,
        "max_abs_err": err,
        **timed_in_turns(lambda: ops.epic_layer(*args, **dims),
                         lambda: ops.epic_layer_reference(*args, **dims)),
        **bound(n_bytes, flops),
        "library_ms": None,  # no single PyTorch call computes an EPiC layer
        "shape": {"B": B, "N": N, "H": H, "L": L, "t": T, "C": C, "dtype": "float32"},
    }


def attention_case(torch, dev, seed, b, lq, lk, h, d, masked, bias=False, fused_qkv=False,
                   lo=30):
    """q, k, v (B, L, H, D), mask (B, Lk) with `lo`..Lk real keys and bias
    (B, H, Lq, Lk) on the card."""
    gen = torch.Generator().manual_seed(seed)
    if fused_qkv:  # the three slices of one (B, L, 3*H*D) projection output
        qkv = torch.randn(b, lq, 3 * h * d, generator=gen).to(dev)
        q, k, v = (t.view(b, lq, h, d) for t in qkv.chunk(3, dim=-1))
    else:
        q = torch.randn(b, lq, h, d, generator=gen).to(dev)
        k = torch.randn(b, lk, h, d, generator=gen).to(dev)
        v = torch.randn(b, lk, h, d, generator=gen).to(dev)
    mask = torch.from_numpy(ragged_mask(np.random.RandomState(seed), b, lk, lo=min(lo, lk))).to(dev) if masked else None
    ab = torch.randn(b, h, lq, lk, generator=gen).to(dev) if bias else None
    return q, k, v, mask, ab


def attention_measure(torch, name, fn, ref, case) -> dict:
    """One attention kernel at one shape: check, time in turns with its plain
    version, time the library call, count the bound."""
    import torch.nn.functional as F

    from particle_fm_tpu_torch.utils.timing import cuda_ms

    q, k, v, mask, ab = case
    b, lq, h, d = q.shape
    lk = k.shape[1]
    err = check_kernel(torch, name, fn(q, k, v, mask, ab), ref(q, k, v, mask, ab))
    add = None if mask is None else ((mask - 1.0) * 1e9)[:, None, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=add).transpose(1, 2)
    lib_err = (library() - ref(q, k, v, mask, ab)).abs().max().item()
    if not lib_err <= KERNEL_TOL:
        fail(f"{name}: the library yardstick computes another function (max abs err {lib_err})")
    n_bytes = 4 * (2 * q.numel() + k.numel() + v.numel() + (0 if mask is None else mask.numel()))
    flops = (4 * d + SCORE_OPS) * b * h * lq * lk
    return {"max_abs_err": err,
            **timed_in_turns(lambda: fn(q, k, v, mask, ab), lambda: ref(q, k, v, mask, ab)),
            **bound(n_bytes, flops), "library_ms": cuda_ms(library),
            "shape": {"B": b, "Lq": lq, "Lk": lk, "H": h, "D": d, "masked": mask is not None,
                      "dtype": "float32"}}


def packed_phase(torch, sa, dev) -> dict:
    main = attention_case(torch, dev, 3, 640, 150, 150, 16, 16, masked=True, fused_qkv=True)
    entry = attention_measure(torch, "packed_short_attention", sa.packed_short_attention,
                              sa.packed_short_attention_reference, main)
    q, k, v, mask, ab = attention_case(torch, dev, 4, 64, 150, 150, 16, 16, masked=True, bias=True)
    bias_err = check_kernel(torch, "packed_short_attention (bias)",
                            sa.packed_short_attention(q, k, v, mask, ab),
                            sa.packed_short_attention_reference(q, k, v, mask, ab))
    return {"name": "packed_short_attention", "route": "cuda",
            "source": "particle_fm_tpu_torch/csrc/short_attention.cu",
            "replaces": "particle_fm_tpu/ops/pallas/short_attention.py:308",
            "launches": None, **entry, "max_abs_err_with_bias": bias_err}


def fused_phase(torch, sa, dev) -> dict:
    fn, ref = sa.fused_short_attention, sa.fused_short_attention_reference
    shapes = {
        "from": attention_measure(torch, "fused_short_attention (from)", fn, ref,
                                  attention_case(torch, dev, 5, 640, 4, 150, 16, 8, masked=True)),
        "to": attention_measure(torch, "fused_short_attention (to)", fn, ref,
                                attention_case(torch, dev, 6, 640, 150, 4, 16, 8, masked=False)),
    }
    q, k, v, mask, ab = attention_case(torch, dev, 7, 64, 37, 150, 16, 8, masked=True, bias=True)
    bias_err = check_kernel(torch, "fused_short_attention (bias)", fn(q, k, v, mask, ab),
                            ref(q, k, v, mask, ab))
    pair = lambda key: sum(s[key] for s in shapes.values())
    return {"name": "fused_short_attention", "route": "cuda",
            "source": "particle_fm_tpu_torch/csrc/short_attention.cu",
            "replaces": "particle_fm_tpu/ops/pallas/short_attention.py:74",
            "launches": None,
            "max_abs_err": max(s["max_abs_err"] for s in shapes.values()),
            # one layer of the cross-attention encoder launches one of each shape
            "per": "one 'from' launch plus one 'to' launch",
            "ms": pair("ms"), "plain_ms": pair("plain_ms"),
            **bound(pair("bytes"), pair("flops")), "library_ms": pair("library_ms"),
            "shapes": shapes, "max_abs_err_with_bias": bias_err}


def flash_phase(torch, fa, dev) -> dict:
    fn = lambda q, k, v, mask, ab: fa.flash_masked_attention(q, k, v, mask)
    ref = lambda q, k, v, mask, ab: fa.flash_masked_attention_reference(q, k, v, mask)
    shapes = {
        "path C": attention_measure(torch, "flash_masked_attention (class token)", fn, ref,
                                    attention_case(torch, dev, 8, 32, 1, 6000, 2, 128, masked=True,
                                                   lo=1000)),
        "path D": attention_measure(torch, "flash_masked_attention (279 particles)", fn, ref,
                                    attention_case(torch, dev, 9, 256, 279, 279, 16, 16,
                                                   masked=True, fused_qkv=True)),
    }
    long_errs = {}
    for key, masked in (("max_abs_err_long_masked", True), ("max_abs_err_long_unmasked", False)):
        case = attention_case(torch, dev, 10, 4, 1500, 1500, 4, 128, masked=masked)
        long_errs[key] = check_kernel(torch, f"flash_masked_attention ({key})", fn(*case), ref(*case))
    main = shapes["path C"]  # the shape `impl="auto"` sends to this kernel
    return {"name": "flash_masked_attention", "route": "cuda",
            "source": "particle_fm_tpu_torch/csrc/flash_attention.cu",
            "replaces": "particle_fm_tpu/ops/pallas/flash_attention.py:58",
            "launches": None,
            "max_abs_err": max(s["max_abs_err"] for s in shapes.values()),
            "per": "one launch at path C's shape; path D's shape under `shapes`",
            **{key: main[key] for key in ("ms", "plain_ms", "turns_ms", "bound_ms", "bound_by",
                                          "bytes", "flops", "library_ms", "shape")},
            "shapes": shapes, **long_errs}


def redraw_parameters(torch, net, seed: int) -> None:
    """Seeded non-zero values for every parameter: matrices N(0, 1/fan_in),
    vectors their initial value (LayerNorm 1, bias 0 or small) + 0.1 N(0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            draw = torch.randn(p.shape, generator=gen).to(p.device)
            if p.ndim >= 2:
                p.copy_(draw / p.shape[-1] ** 0.5)
            else:
                p.add_(0.1 * draw)


def serving_phase(torch, dev, name, config, model, net, wrapper_owner, wrapper_name,
                  launches_per_eval, requests, counted, batch=640, mask_lo=30,
                  cpu_batch=8) -> dict:
    """Serve `requests` in batches of `batch` through make_serve_fn/
    serve_batches on the kernel path and on the plain path, and hold a small
    batch of `cpu_batch` sets against the CPU. Sets have `mask_lo` to
    `model.num_particles` real particles."""
    from particle_fm_tpu_torch.serving import make_serve_fn, serve_batches

    wrapper = getattr(wrapper_owner, wrapper_name)
    plain = getattr(wrapper_owner, wrapper_name + "_reference")
    n, feats, cond_dim = model.num_particles, model.features, model.global_cond_dim
    proto = dict(batch_size=batch, ode_solver="midpoint", has_cond=True, has_mask=True,
                 means=[0.0, 0.0, 0.05, 0.0][:feats], stds=[0.1, 0.1, 0.06, 0.2][:feats])
    fn = make_serve_fn(model, net, ode_steps=ODE_STEPS, **proto)
    warm = make_serve_fn(model, net, ode_steps=2, **proto)

    rs = np.random.RandomState(1)
    reqs = [(ragged_mask(rs, r, n, mask_lo)[..., None], rs.randn(r, cond_dim).astype(np.float32))
            for r in requests]
    n_batches = sum(-(-r // batch) for r in requests)
    want_launches = launches_per_eval * 2 * (ODE_STEPS - 1) * n_batches

    def answer(f):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [serve_batches(f, f.meta, len(m), cond=c, mask=m, seed=10 + i)
                for i, (m, c) in enumerate(reqs)]
        torch.cuda.synchronize()
        return outs, time.perf_counter() - t0

    answer(warm)
    for w in counted:
        w.launches = 0
    outs, secs = answer(fn)  # the main path
    launches = wrapper.launches

    for (m, _), out in zip(reqs, outs):
        if out.shape != (len(m), n, feats):
            fail(f"{name}: served shape {out.shape}, expected {(len(m), n, feats)}")
        if not np.isfinite(out).all():
            fail(f"{name}: served samples are not finite")
        if np.abs(out[m[..., 0] == 0]).max(initial=0.0) != 0.0:
            fail(f"{name}: padded rows of the served samples are not zero")
    if launches != want_launches:
        fail(f"{name}: {wrapper_name} launched {launches} times on the serving path, "
             f"expected {want_launches}")
    if sum(w.launches for w in counted) != launches:
        fail(f"{name}: a kernel of another path was launched on this one")

    # then in turns with the kernel's plain version: plain, plain, kernel
    with mock.patch.object(wrapper_owner, wrapper_name, plain):
        answer(warm)
        plain_outs, plain_secs = answer(fn)
        plain_secs2 = answer(fn)[1]
    secs2 = answer(fn)[1]
    path_err = max(float(np.abs(a - b).max()) for a, b in zip(outs, plain_outs))
    if not path_err <= PATH_TOL:
        fail(f"{name}: kernel path and plain path disagree after 100 evaluations: {path_err}")

    # a small input against the CPU, with the same noise and weights
    gen = torch.Generator().manual_seed(2)
    mask = torch.from_numpy(ragged_mask(rs, cpu_batch, n, mask_lo)[..., None])
    cond = torch.randn(cpu_batch, cond_dim, generator=gen)
    z = torch.randn(cpu_batch, n, feats, generator=gen) * mask
    with torch.no_grad():
        field = model.vector_field(net, torch.full((cpu_batch,), 0.5, device=dev), z.to(dev),
                                   cond.to(dev), mask.to(dev))
    field_max = float(field.abs().max())
    if not (np.isfinite(field_max) and field_max > 0.0):
        fail(f"{name}: the vector field is identically zero or not finite (max abs {field_max})")
    gpu = model.integrate(net, z.to(dev), cond.to(dev), mask.to(dev), "midpoint", 5).cpu()
    cpu_net = copy.deepcopy(net).cpu()
    cpu = model.integrate(cpu_net, z, cond, mask, "midpoint", 5)
    cpu_err = float((gpu - cpu).abs().max())
    if not cpu_err <= CPU_TOL:
        fail(f"{name}: small batch on the card disagrees with the CPU: {cpu_err}")

    jets = sum(requests)
    return {
        "config": config, "requests": list(requests), "batch": batch, "batches": n_batches,
        "ode_solver": "midpoint", "ode_steps": ODE_STEPS, "nfe": 2 * (ODE_STEPS - 1),
        "kernel_path_s": [secs, secs2], "plain_path_s": [plain_secs, plain_secs2],
        "kernel_path_jets_per_s": 2 * jets / (secs + secs2),
        "plain_path_jets_per_s": 2 * jets / (plain_secs + plain_secs2),
        "kernel_path_batch_jets_per_s": 2 * n_batches * batch / (secs + secs2),
        "plain_path_batch_jets_per_s": 2 * n_batches * batch / (plain_secs + plain_secs2),
        "kernel": wrapper_name, "launches": launches, "vector_field_max_abs": field_max,
        "max_abs_diff_kernel_vs_plain": path_err, "max_abs_diff_card_vs_cpu": cpu_err,
        "cpu_batch": cpu_batch,
    }


def droid_net_config(core_key: str, model_dim: int, num_layers: int, attn_impl: str,
                     dense_hddn: int | None = None) -> dict:
    """net_config of configs/model/fm_droid_{transformer,crossattention}.yaml,
    with the attention kernel chosen and float32 scores."""
    embd = {"act_h": "lrlu", "nrm": "layer"}
    dense = dict(embd, output_init_zeros=True)
    if dense_hddn:
        dense["hddn_dim"] = dense_hddn
    mha = {"num_heads": 16, "init_zeros": True, "do_layer_norm": True,
           "scores_dtype": None, "attn_impl": attn_impl}
    return {"node_embd_config": embd, "ctxt_embd_config": dict(embd, outp_dim=64),
            "outp_embd_config": dict(embd, output_init_zeros=True),
            core_key: {"model_dim": model_dim, "num_layers": num_layers, "mha_config": mha,
                       "dense_config": dense}}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available; this script runs on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    try:
        import particle_fm_tpu_torch
        from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel
        from particle_fm_tpu_torch.ops import _build
        from particle_fm_tpu_torch.ops import epic_layer as ops
        from particle_fm_tpu_torch.ops import flash_attention as fa
        from particle_fm_tpu_torch.ops import short_attention as sa
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
    libs = _build.build_libraries([ops.SOURCE, sa.SOURCE, fa.SOURCE])
    for module in (ops, sa, fa):
        module.load_library()
    print(json.dumps({"build_s": time.perf_counter() - t0, "libraries": [p.name for p in libs]}),
          flush=True)
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                print(f"ptxas ({lib.name}):", line.strip())

    kernels = {k["name"]: k for k in (kernel_phase(torch, ops, dev), packed_phase(torch, sa, dev),
                                      fused_phase(torch, sa, dev), flash_phase(torch, fa, dev))}
    for k in kernels.values():
        print(json.dumps({"kernel_phase": k}), flush=True)

    jets = dict(features=3, frequencies=16, t_emb="cosine", loss_type="FM-OT")
    jetnet = dict(jets, num_particles=150, global_cond_dim=2)
    # configs/experiment/jetnet/fm_tops150_cond.yaml on configs/model/flow_matching.yaml
    epic = FlowMatchingModel(
        model="epic", hidden_dim=128, layers=6, latent=10, t_global_cat=True, t_local_cat=True,
        add_time_to_input=False, local_cond_dim=2, **jetnet,
    )
    droid = FlowMatchingModel(
        model="droid_fulltransformer", add_time_to_input=True,
        net_config=droid_net_config("te_config", 256, 3, "packed"), **jetnet,
    )
    cross = FlowMatchingModel(
        model="droid_fullcrossattention", add_time_to_input=True,
        net_config=droid_net_config("cae_config", 128, 8, "fused", dense_hddn=256), **jetnet,
    )
    # configs/experiment/calo/mdma_calo.yaml on configs/model/flow_matching_mdma.yaml, with 2
    # heads of 128 in place of 8 of 32 (the parameters have the same shapes)
    mdma = FlowMatchingModel(
        model="mdma", features=4, num_particles=6000, global_cond_dim=1, frequencies=16,
        t_emb="cosine", add_time_to_input=False, loss_type="CFM",
        net_config=dict(latent=16, hidden_dim=256, layers=8, num_heads=2, t_local_cat=True,
                        t_global_cat=True, global_cond_dim=1),
    )
    # configs/experiment/lhco/jets_transformer.yaml on configs/model/fm_droid_transformer.yaml
    lhco = FlowMatchingModel(
        model="droid_fulltransformer", add_time_to_input=True, num_particles=279,
        global_cond_dim=5, net_config=droid_net_config("te_config", 256, 3, "flash"), **jets,
    )
    nets = {}
    for seed, (key, model) in enumerate([("droid", droid), ("cross", cross), ("lhco", lhco)], 1):
        nets[key] = model.init(seed=0, device=dev)
        redraw_parameters(torch, nets[key], seed=seed)
    redrawn = "(every parameter re-drawn from a seed)"
    runs = [
        dict(name="epic", config="fm_tops150_cond (seeded random weights)", model=epic,
             net=epic.init(seed=0, device=dev), wrapper_owner=ops, wrapper_name="epic_layer",
             launches_per_eval=epic.layers, requests=(640, 7)),
        dict(name="path A", config="fm_droid_transformer, attn_impl=packed, scores_dtype=null "
             + redrawn, model=droid, net=nets["droid"], wrapper_owner=sa,
             wrapper_name="packed_short_attention", launches_per_eval=3, requests=(640, 7)),
        dict(name="path B", config="fm_droid_crossattention, attn_impl=fused, scores_dtype=null, "
             "4 global tokens " + redrawn, model=cross, net=nets["cross"], wrapper_owner=sa,
             wrapper_name="fused_short_attention", launches_per_eval=2 * 8, requests=(640, 7)),
        dict(name="path C", config="calo/mdma_calo on flow_matching_mdma, net_config.num_heads=2 "
             "(head dim 128: impl=auto takes the flash kernel), 6000 hits, CFM (seeded random "
             "weights)", model=mdma, net=mdma.init(seed=0, device=dev), wrapper_owner=fa,
             wrapper_name="flash_masked_attention", launches_per_eval=8, requests=(32, 5),
             batch=32, mask_lo=1000, cpu_batch=2),
        dict(name="path D", config="lhco/jets_transformer on fm_droid_transformer, "
             "attn_impl=flash, scores_dtype=null, 279 particles, cond 5 " + redrawn, model=lhco,
             net=nets["lhco"], wrapper_owner=fa, wrapper_name="flash_masked_attention",
             launches_per_eval=3, requests=(256, 7), batch=256),
    ]
    counted = [ops.epic_layer, sa.packed_short_attention, sa.fused_short_attention,
               fa.flash_masked_attention]
    for run in runs:
        serving = serving_phase(torch, dev, counted=counted, **run)
        print(json.dumps({"serving": run["name"], **serving}), flush=True)
        kernel = kernels[run["wrapper_name"]]
        kernel["launches"] = (kernel["launches"] or 0) + serving["launches"]
        kernel.setdefault("launches_by_path", {})[run["name"]] = serving["launches"]

    kernels = list(kernels.values())
    print(json.dumps({"kernels": kernels}))
    print(card)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
