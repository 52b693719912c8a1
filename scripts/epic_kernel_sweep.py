#!/usr/bin/env python3
"""Time the port's fused EPiC-layer CUDA kernel over a sweep of shapes.

    python3 scripts/epic_kernel_sweep.py [--out build/measurements/epic_kernel_sweep.json]

For each (B, N, H) it times `ops.epic_layer` (the kernel) and
`ops.epic_layer_reference` (the plain PyTorch version) with CUDA events
(utils/timing.py: 20 calls back to back per event pair, median of 5 runs) on random inputs with the
flagship's L=10, t=32, C=2 and full masks, and prints one JSON line per
shape. Varying N at fixed B separates the per-set work (pool, per-set MLPs)
from the per-row work (the two H x H matmuls).

    python3 scripts/epic_kernel_sweep.py --compare OTHER.cu

also builds another version of the kernel source (same C entry point) and
times the two in turns at each shape (other, this, this, other), so that two
versions are compared inside one run on one card.
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

from particle_fm_tpu_torch.ops import epic_layer as ops  # noqa: E402
from particle_fm_tpu_torch.utils.timing import cuda_ms  # noqa: E402

SHAPES = [(640, 150, 128), (640, 1, 128), (640, 64, 128), (640, 128, 128), (640, 300, 128),
          (132, 150, 128), (1320, 150, 128), (640, 150, 64), (640, 150, 256)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "measurements" / "epic_kernel_sweep.json"))
    ap.add_argument("--compare", type=Path, default=None,
                    help="another version of csrc/epic_layer.cu to time in turns with this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("epic_kernel_sweep: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    gen = torch.Generator(device="cuda").manual_seed(0)
    lat, t, c = 10, 32, 2
    rows = []
    for b, n, h in SHAPES:
        r = lambda *s: torch.randn(*s, generator=gen, device="cuda") * 0.1
        a = [r(b, n, h), r(b, lat), torch.ones(b, n, device="cuda"), r(b, t + c),
             r(t + 2 * h + lat + c, h), r(h), r(t + h + c, lat), r(lat),
             r(h, h), r(t + lat + c, h), r(h), r(h, h), r(t + c, h), r(h)]
        dims = dict(sum_scale=1e-2, tg_dim=t, tl_dim=t, c_dim=c)
        kernel = lambda: ops.epic_layer(*a, **dims)
        plain = cuda_ms(lambda: ops.epic_layer_reference(*a, **dims))
        row = {"B": b, "N": n, "H": h}
        if args.compare is None:
            ms = cuda_ms(kernel)
        else:
            this, other = ops.SOURCE, args.compare.resolve()
            turns = []
            for src in (other, this, this, other):
                ops.SOURCE = src
                turns.append(cuda_ms(kernel))
            ops.SOURCE = this
            ms = (turns[1] + turns[2]) / 2
            row["compare_ms"] = (turns[0] + turns[3]) / 2
            row["turns_ms"] = turns
        flops = 4 * b * n * h * h
        row.update({"kernel_ms": ms, "plain_ms": plain, "kernel_us_per_set": 1e3 * ms / b,
                    "local_matmul_tflops": flops / ms / 1e9})
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
