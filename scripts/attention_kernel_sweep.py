#!/usr/bin/env python3
"""Time the port's three attention CUDA kernels over a sweep of shapes.

    python3 scripts/attention_kernel_sweep.py [--kernels packed,fused,flash]
        [--out build/measurements/attention_kernel_sweep.json]

For each shape it times the kernel (`ops.short_attention.packed_short_attention`
or `fused_short_attention`, `ops.flash_attention.flash_masked_attention`) with
CUDA events (utils/timing.py: 20 calls back to back per event pair, median of
5 runs) on random float32 inputs with ragged key masks, checks it against its
plain PyTorch version (atol/rtol 1e-4), and prints one JSON line per shape
with the time, the achieved float32 rate of the two products and the bytes
moved per second. The first packed shape, the first two fused shapes and the
first two flash shapes are those of the served models; the others vary one of
B, L, H and D around them, and the flash rows repeat the packed kernel's
served shape and MDMA's with its shipped 8 heads of 32.

    python3 scripts/attention_kernel_sweep.py --compare OTHER.cu [--kernels flash]

also builds another version of the kernels' source (same C entry points;
csrc/flash_attention.cu when only flash rows are asked for, else
csrc/short_attention.cu, whose rows are then the ones compared) and times
the two in turns at each shape (other, this, this, other), so that two
versions are compared inside one run on one card. OTHER.cu finds the headers
it includes beside itself first, then in csrc/. An earlier commit's kernel:

    mkdir -p build/parent
    git show <commit>:particle_fm_tpu_torch/csrc/short_attention.cu > build/parent/short_attention.cu
    git show <commit>:particle_fm_tpu_torch/csrc/attention_common.cuh > build/parent/attention_common.cuh
    python3 scripts/attention_kernel_sweep.py --kernels packed --compare build/parent/short_attention.cu
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import attention_case  # noqa: E402
from particle_fm_tpu_torch.ops import flash_attention, short_attention  # noqa: E402
from particle_fm_tpu_torch.utils.timing import cuda_ms  # noqa: E402

# kernel -> (module, wrapper, plain version)
KERNELS = {
    "packed": (short_attention, "packed_short_attention", "packed_short_attention_reference"),
    "fused": (short_attention, "fused_short_attention", "fused_short_attention_reference"),
    "flash": (flash_attention, "flash_masked_attention", "flash_masked_attention_reference"),
}
# (kernel, B, Lq, Lk, H, D, masked, q/k/v as slices of one QKV projection)
SHAPES = [
    ("packed", 640, 150, 150, 16, 16, True, True),
    ("packed", 640, 150, 150, 16, 16, True, False),
    ("packed", 128, 150, 150, 16, 16, True, True),
    ("packed", 640, 30, 30, 16, 16, True, True),
    ("packed", 640, 64, 64, 16, 16, True, True),
    ("packed", 640, 256, 256, 16, 16, True, True),
    ("packed", 640, 150, 150, 8, 32, True, True),
    ("packed", 640, 150, 150, 32, 8, True, True),
    ("packed", 256, 128, 128, 8, 64, True, True),
    ("fused", 640, 4, 150, 16, 8, True, False),
    ("fused", 640, 150, 4, 16, 8, False, False),
    ("fused", 640, 150, 150, 16, 16, True, False),
    ("fused", 640, 1, 150, 16, 16, True, False),
    ("fused", 640, 16, 150, 16, 8, True, False),
    ("fused", 640, 150, 16, 16, 8, False, False),
    ("fused", 64, 512, 512, 8, 32, True, False),
    ("flash", 32, 1, 6000, 2, 128, True, False),
    ("flash", 256, 279, 279, 16, 16, True, True),
    ("flash", 4, 1, 6000, 2, 128, True, False),
    ("flash", 256, 1, 6000, 2, 128, True, False),
    ("flash", 32, 1, 6000, 8, 32, True, False),
    ("flash", 32, 1, 1024, 2, 128, True, False),
    ("flash", 640, 150, 150, 16, 16, True, True),
    ("flash", 64, 558, 558, 16, 16, True, True),
    ("flash", 4, 1500, 1500, 4, 128, True, False),
    ("flash", 16, 1024, 1024, 8, 64, True, True),
]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "measurements" / "attention_kernel_sweep.json"))
    ap.add_argument("--kernels", default="packed,fused,flash", help="which kernels' rows to run")
    ap.add_argument("--compare", type=Path, default=None,
                    help="another version of the kernels' source to time in turns with this one")
    args = ap.parse_args()
    wanted = args.kernels.split(",")
    compared = flash_attention if wanted == ["flash"] else short_attention
    if not torch.cuda.is_available():
        sys.exit("attention_kernel_sweep: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda", 0)
    this = compared.SOURCE
    rows = []
    for i, (name, b, lq, lk, h, d, masked, sliced) in enumerate(SHAPES):
        if name not in wanted:
            continue
        ops, wrapper, plain = KERNELS[name]
        q, k, v, mask, _ = attention_case(torch, dev, i, b, lq, lk, h, d, masked, fused_qkv=sliced,
                                          lo=lk // 6 if lk >= 1024 else 30)
        fn = getattr(ops, wrapper)
        want = getattr(ops, plain)(q, k, v, mask)
        kernel = lambda: fn(q, k, v, mask)
        row = {"kernel": name, "B": b, "Lq": lq, "Lk": lk, "H": h, "D": d, "masked": masked,
               "sliced_qkv": sliced}
        compare = args.compare is not None and ops is compared
        sources = [args.compare.resolve(), this] if compare else [this]
        for src in sources:
            compared.SOURCE = src
            torch.testing.assert_close(kernel(), want, atol=1e-4, rtol=1e-4)
        if not compare:
            ms = cuda_ms(kernel)
        else:
            other, turns = sources[0], []
            for src in (other, this, this, other):
                compared.SOURCE = src
                turns.append(cuda_ms(kernel))
            ms = (turns[1] + turns[2]) / 2
            row["compare_ms"] = (turns[0] + turns[3]) / 2
            row["turns_ms"] = turns
        compared.SOURCE = this
        n_bytes = 4 * (2 * q.numel() + k.numel() + v.numel() + (mask.numel() if masked else 0))
        row.update({"kernel_ms": ms, "products_tflops": 4 * b * h * lq * lk * d / ms / 1e9,
                    "gbytes_per_s": n_bytes / ms / 1e6})
        rows.append(row)
        print(json.dumps(row), flush=True)
        del q, k, v, mask, want
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
