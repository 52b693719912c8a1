#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's train step on one NVIDIA GPU.

    python3 scripts/profile_torch_train.py [--config epic|transformer] [--steps 4]
        [--out build/measurements/profile_torch_train_<config>.json]

Builds the training cells of chip_smoke.py from configs/ with the port's
compose: `epic` is fm_tops150_cond (the EPiC module path: the fused layer is
forward-only and does not train), `transformer` is fm_droid_transformer with
attn_impl=packed and scores_dtype=null on the same data, every parameter
re-drawn. Synthetic JetNet-150, batch 1024, AdamW at a constant lr 1e-3,
float32 without TF32. After two warm-up steps it times `--steps` steps once
without and once under torch.profiler, and prints the wall time per step,
the device's busy share (summed kernel time over the wall) and the kernels
by device time; for `transformer` the kernel path and, with the packed
kernel's wrapper replaced by its plain version, the plain path. Writes the
same as JSON to `--out`.
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


def profile_steps(trainer, state, steps: int) -> dict:
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
    return {"wall_ms_per_step_unprofiled": wall * 1e3 / steps,
            "wall_ms_per_step": profiled * 1e3 / steps,
            "device_ms_per_step": busy / steps,
            "device_busy_share_unprofiled": busy / (wall * 1e3),
            "kernels": [dict(r, device_ms_per_step=r["device_ms"] / steps) for r in rows[:20]]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=list(CONFIGS), default="epic")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = Path(args.out or ROOT / "build" / "measurements" / f"profile_torch_train_{args.config}.json")
    if not torch.cuda.is_available():
        sys.exit("profile_torch_train: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    model, dm, cfg = compose_training(CONFIGS[args.config])
    dm.setup()
    trainer, state = train_setup(torch, model, dm, cfg, dev)
    result = {"card": card, "config": args.config, "batch": dm.batch_size, "steps": args.steps}
    if args.config == "transformer":
        attention_ops.load_library()
        redraw_parameters(torch, state.net, seed=4)
        result["kernel_path"] = profile_steps(trainer, state, args.steps)
        with mock.patch.object(attention_ops, "packed_short_attention",
                               attention_ops.packed_short_attention_reference):
            result["plain_path"] = profile_steps(trainer, state, args.steps)
    else:
        result["module_path"] = profile_steps(trainer, state, args.steps)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(card, args.config, f"batch {dm.batch_size}")
    for path in (k for k in result if k.endswith("_path")):
        r = result[path]
        print(f"{path}: {r['wall_ms_per_step_unprofiled']:.2f} ms/step wall unprofiled, "
              f"{r['wall_ms_per_step']:.2f} profiled; kernels {r['device_ms_per_step']:.2f} "
              f"ms/step, busy share {r['device_busy_share_unprofiled']:.3f}")
        for k in r["kernels"][:14]:
            print(f"  {k['device_ms_per_step']:8.3f} ms/step {k['calls']:6d}x  {k['name']}")


if __name__ == "__main__":
    main()
