#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's train step on one NVIDIA GPU.

    python3 scripts/profile_torch_train.py [--config epic|transformer] [--steps 4]
        [--dtype float32|bfloat16]
        [--out build/measurements/profile_torch_train_<config>[_bfloat16].json]

Builds the training cells of chip_smoke.py from configs/ with the port's
compose: `epic` is fm_tops150_cond (the EPiC module path: the fused layer is
forward-only and does not train), `transformer` is fm_droid_transformer with
attn_impl=packed and scores_dtype=null on the same data, every parameter
re-drawn. Synthetic JetNet-150, batch 1024, AdamW at a constant lr 1e-3,
without TF32; `--dtype bfloat16` trains with model.dtype=bfloat16 (float32
master weights, bfloat16 compute). After two warm-up steps it times
`--steps` steps once without and once under torch.profiler, and prints the
wall time per step, the device's busy share (summed kernel time over the
wall) and the kernels by device time; for `transformer` the kernel path and,
with the packed kernel replaced by its plain version, the plain path, and
the packed kernel's share of the device time (its forward; the backward
recomputes the plain `packed_ref_math`). Writes the same as JSON to `--out`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import compose_training, redraw_parameters, run_steps, train_setup  # noqa: E402
from particle_fm_tpu_torch.ops import short_attention as attention_ops  # noqa: E402
from scripts.profile_torch_port import kernel_rows  # noqa: E402

DATA = ["experiment=jetnet/fm_tops150_cond", "data.synthetic=true"]
CONFIGS = {
    "epic": DATA,
    "transformer": DATA + ["model=fm_droid_transformer",
                           "model.net_config.te_config.mha_config.attn_impl=packed",
                           "model.net_config.te_config.mha_config.scores_dtype=null"],
}


def profile_steps(trainer, state, steps: int, kernel: str | None = None) -> dict:
    """Wall and device time per step; with `kernel`, also the device time a
    step and the share of the kernels whose names hold it."""
    data = trainer._place_train_split()
    run_steps(torch, trainer, state, data, 2)
    t0 = time.perf_counter()
    run_steps(torch, trainer, state, data, steps)
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_steps(torch, trainer, state, data, steps)
        profiled = time.perf_counter() - t0
    rows = kernel_rows(prof)
    busy = sum(r["device_ms"] for r in rows)
    result = {"wall_ms_per_step_unprofiled": wall * 1e3 / steps,
              "wall_ms_per_step": profiled * 1e3 / steps,
              "device_ms_per_step": busy / steps,
              "device_busy_share_unprofiled": busy / (wall * 1e3),
              "kernels": [dict(r, device_ms_per_step=r["device_ms"] / steps) for r in rows[:20]]}
    if kernel is not None:
        ms = sum(r["device_ms"] for r in rows if kernel in r["name"])
        result.update({f"{kernel}_device_ms_per_step": ms / steps, f"{kernel}_share": ms / busy})
    return result


def attention_split(batch, dtype: torch.dtype, reps: int = 10) -> dict:
    """Device ms of one packed attention call at path A's shape (16 heads of
    16) on the step's batch of masks, CUDA events over `reps` calls: the
    forward (the kernel) and the backward (`packed_ref_math` recomputed and
    differentiated)."""
    mask = batch[1][..., 0]
    b, l = mask.shape
    gen = torch.Generator(mask.device).manual_seed(0)
    q, k, v, g = (torch.randn(b, l, 16, 16, generator=gen, device=mask.device, dtype=dtype)
                  for _ in range(4))
    leaves = [a.requires_grad_(True) for a in (q, k, v)]

    def timed(fn) -> float:
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    forward = timed(lambda: attention_ops.packed_short_attention(*leaves, mask))
    out = attention_ops.packed_short_attention(*leaves, mask)
    backward = timed(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True))
    return {"shape": [b, l, 16, 16], "forward_ms": forward, "backward_ms": backward}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=list(CONFIGS), default="epic")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    suffix = "" if args.dtype == "float32" else f"_{args.dtype}"
    out = Path(args.out or ROOT / "build" / "measurements"
               / f"profile_torch_train_{args.config}{suffix}.json")
    if not torch.cuda.is_available():
        sys.exit("profile_torch_train: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    model, dm, cfg = compose_training(CONFIGS[args.config] + [f"model.dtype={args.dtype}"])
    dm.setup()
    trainer, state = train_setup(torch, model, dm, cfg, dev)
    result = {"card": card, "config": args.config, "dtype": args.dtype, "batch": dm.batch_size,
              "steps": args.steps}
    if args.config == "transformer":
        attention_ops.load_library()
        redraw_parameters(torch, state.net, seed=4)
        kernel = ("packed_attention_bf16_kernel" if args.dtype == "bfloat16"
                  else "packed_attention_kernel")
        result["kernel_path"] = profile_steps(trainer, state, args.steps, kernel)
        split = trainer._place_train_split()
        first = next(iter(trainer._epoch_batches(split, 0)))
        attention = attention_split(first, model.compute_dtype or torch.float32)
        layers = 3 * attention["forward_ms"], 3 * attention["backward_ms"]
        device = result["kernel_path"]["device_ms_per_step"]
        result["attention_per_step"] = dict(
            attention, layers=3, forward_share=layers[0] / device,
            backward_share=layers[1] / device)
        # the forward's kernel replaced by its plain version; the backward is the same
        with mock.patch.object(attention_ops, "_packed_forward",
                               attention_ops.packed_short_attention_reference):
            result["plain_path"] = profile_steps(trainer, state, args.steps)
    else:
        result["module_path"] = profile_steps(trainer, state, args.steps)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(card, args.config, args.dtype, f"batch {dm.batch_size}")
    if "attention_per_step" in result:
        a = result["attention_per_step"]
        print(f"packed attention a call: forward {a['forward_ms']:.3f} ms, backward "
              f"{a['backward_ms']:.3f} ms; shares of the step's device time (3 layers): "
              f"forward {a['forward_share']:.4f}, backward {a['backward_share']:.4f}")
    for path in (k for k in result if k.endswith("_path")):
        r = result[path]
        print(f"{path}: {r['wall_ms_per_step_unprofiled']:.2f} ms/step wall unprofiled, "
              f"{r['wall_ms_per_step']:.2f} profiled; kernels {r['device_ms_per_step']:.2f} "
              f"ms/step, busy share {r['device_busy_share_unprofiled']:.3f}")
        for key in (k for k in r if k.endswith("_share") and k != "device_busy_share_unprofiled"):
            print(f"  {key}: {r[key]:.4f}")
        for k in r["kernels"][:14]:
            print(f"  {k['device_ms_per_step']:8.3f} ms/step {k['calls']:6d}x  {k['name']}")


if __name__ == "__main__":
    main()
