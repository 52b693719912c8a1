#!/usr/bin/env python3
"""Time the port's fused EPiC-layer CUDA kernel over a sweep of shapes.

    python3 scripts/epic_kernel_sweep.py [--out build/measurements/epic_kernel_sweep.json]

For each (B, N, H, L, C) it times `ops.epic_layer` (the kernel) and
`ops.epic_layer_reference` (the plain PyTorch version) with CUDA events
(utils/timing.py: 20 calls back to back per event pair, median of 5 runs) on
random inputs with t=32, cond C wide on both MLP paths and full masks, checks
the kernel against the plain version (max abs error printed), and prints one
JSON line per shape. The first rows are the served flagship
(fm_tops150_cond), lhco/bigPC and jetclass/jetclass_cond (whose cond feeds
the global MLPs only: its last row); the others vary N at fixed B, which
separates the per-set work (pool, per-set MLPs) from the per-row work (the
two H x H matmuls), and B and H around the flagship.

    python3 scripts/epic_kernel_sweep.py --compare OTHER.cu

also builds another version of the kernel source and times the two in turns
at each shape where cond feeds both paths (other, this, this, other), so that
two versions are compared inside one run on one card. OTHER.cu may have the
C entry point of an earlier version, which took one cond width (`c`) where
this one takes two (`cg`, `cl`): the script calls each library with its own
argument list. An earlier commit's kernel:

    mkdir -p build/parent
    git show <commit>:particle_fm_tpu_torch/csrc/epic_layer.cu > build/parent/epic_layer.cu
    python3 scripts/epic_kernel_sweep.py --compare build/parent/epic_layer.cu
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from particle_fm_tpu_torch.ops import _build  # noqa: E402
from particle_fm_tpu_torch.ops import epic_layer as ops  # noqa: E402
from particle_fm_tpu_torch.utils.timing import cuda_ms  # noqa: E402

T = 32
# (B, N, H, L, C, cond on the local path too)
SHAPES = [(640, 150, 128, 10, 2, True), (128, 558, 256, 256, 10, True),
          (512, 128, 300, 16, 12, True), (512, 128, 300, 16, 12, False),
          (640, 1, 128, 10, 2, True), (640, 64, 128, 10, 2, True), (640, 128, 128, 10, 2, True),
          (640, 300, 128, 10, 2, True), (132, 150, 128, 10, 2, True),
          (1320, 150, 128, 10, 2, True), (640, 150, 64, 10, 2, True),
          (640, 150, 256, 10, 2, True)]


def other_entry(path: Path):
    """The entry point of another version of the source, with its own
    argument list: 8 ints (one cond width) or 9 (global and local)."""
    lib = ctypes.CDLL(str(_build.build_library(path)))
    fn = lib.epic_layer_fwd_f32
    two = "int cg, int cl" in path.read_text()  # the entry point takes both cond widths
    fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * (9 if two else 8)
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(args, b, n, h, lat, s, c):
        xo, go = torch.empty_like(args[0]), torch.empty_like(args[1])
        ints = (b, n, h, lat, s, T, T) + ((c, c) if two else (c,))
        err = fn(*(a.data_ptr() for a in args), xo.data_ptr(), go.data_ptr(), *ints, 1e-2,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{path}: cudaError {err}")
        return xo, go

    return call


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
    other = other_entry(args.compare.resolve()) if args.compare else None
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, n, h, lat, c, local in SHAPES:
        cl = c if local else 0
        r = lambda *s: torch.randn(*s, generator=gen, device="cuda") * 0.1
        a = [r(b, n, h), r(b, lat), torch.ones(b, n, device="cuda"), r(b, T + c),
             r(T + 2 * h + lat + c, h), r(h), r(T + h + c, lat), r(lat),
             r(h, h), r(T + lat + cl, h), r(h), r(h, h), r(T + cl, h), r(h)]
        dims = dict(sum_scale=1e-2, tg_dim=T, tl_dim=T, cg_dim=c, cl_dim=cl)
        kernel = lambda: ops.epic_layer(*a, **dims)
        want = ops.epic_layer_reference(*a, **dims)
        row = {"B": b, "N": n, "H": h, "L": lat, "C": c, "cond_on_local_path": local,
               "max_abs_err": (kernel()[0] - want[0]).abs().max().item(),
               "plain_ms": cuda_ms(lambda: ops.epic_layer_reference(*a, **dims))}
        old = lambda: other(a, b, n, h, lat, T + c, c)
        if other is not None and local:
            try:
                row["compare_max_abs_err"] = (old()[0] - want[0]).abs().max().item()
            except RuntimeError as e:  # a shape the other version does not take
                row["compare_refused"] = str(e)
        if "compare_max_abs_err" not in row:
            ms = cuda_ms(kernel)
        else:
            turns = [cuda_ms(f) for f in (old, kernel, kernel, old)]
            ms = (turns[1] + turns[2]) / 2
            row["compare_ms"] = (turns[0] + turns[3]) / 2
            row["turns_ms"] = turns
        flops = 4 * b * n * h * h
        row.update({"kernel_ms": ms, "kernel_us_per_set": 1e3 * ms / b,
                    "local_matmul_tflops": flops / ms / 1e9})
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
