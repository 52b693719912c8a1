#!/usr/bin/env python3
"""Time design variants of the fused EPiC layer's kernel against the
committed one, in turns, at the shapes of the EPiC configs the repo ships.

    python3 scripts/epic_layer_variants.py [--variants committed,l2_weights,...]
        [--out build/measurements/epic_layer_variants.json]

A variant is a copy of csrc/epic_layer.cu and csrc/mma_tf32.cuh under
build/variants/epic_<name>/ with lines replaced (the script fails if a line it
wants to replace is no longer there once):

  l2_weights   the local weights always staged slice by slice, never held
               whole in shared memory
  nt_8         a warp's output tile 16 x 64 (8 n8 tiles) in place of 16 x 32
  warps_8      8 consumer warps with output tiles of 32 x 32 (two m16 tiles):
               the first tensor-core version's geometry
  one_product  one TF32 product per float32 product (wrong to 1e-3: it shows
               what the other two cost)
  no_local     the consumers skip their two matmuls (wrong: what is left is
               the producers, the staging and the epilogues)
  no_global    the producers skip the pool and the per-set MLPs (wrong: what
               is left is the local path)
  producers_8  8 producer warps in place of 4 (a block of 24 warps: fewer
               registers a thread)
  wide_tail    a set's last tile of at most 32 rows in warp tiles 32 columns
               wide too (half the consumer warps idle) in place of 16

Each is built with nvcc as the port builds its own, checked against the
plain version (max abs error printed, not asserted), and timed with CUDA
events in two rounds (forwards, then backwards through the list; utils/
timing.py) at the flagship (B=640, N=150, H=128, L=10, cond 2 on both paths),
lhco/bigPC (B=128, N=558, H=256, L=256, cond 10 on both) and
jetclass/jetclass_cond (B=512, N=128, H=300, L=16, cond 12 on the global
path), t=32. Prints one JSON line per shape with the mean ms per variant, and
what each library reports of its launch at the flagship.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from particle_fm_tpu_torch.ops import _build  # noqa: E402
from particle_fm_tpu_torch.ops import epic_layer as ops  # noqa: E402
from particle_fm_tpu_torch.utils.timing import cuda_ms  # noqa: E402

EPIC, MMA = "epic_layer.cu", "mma_tf32.cuh"
# name -> [(file, text as committed, replacement)]
VARIANTS = {
    "committed": [],
    "l2_weights": [(EPIC, "{{1, 64, 0}, {1, 32, 0}, {0, 64, 32}", "{{0, 64, 32}, {0, 64, 32}, {0, 64, 32}")],
    "nt_8": [(EPIC, "constexpr int kNt = 4; ", "constexpr int kNt = 8; ")],
    "warps_8": [(EPIC, "constexpr int kWarps = 16; ", "constexpr int kWarps = 8; "),
                (EPIC, "constexpr int kMt = 1; ", "constexpr int kMt = 2; ")],
    "one_product": [(MMA, "    for (int nt = 0; nt < NT; ++nt) mma_tf32(c[mt][nt], a_lo[mt], b0[nt].hi, b1[nt].hi);\n",
                     "    for (int nt = 0; nt < NT; ++nt) {}\n"),
                    (MMA, "    for (int nt = 0; nt < NT; ++nt) mma_tf32(c[mt][nt], a_hi[mt], b0[nt].lo, b1[nt].lo);\n",
                     "    for (int nt = 0; nt < NT; ++nt) {}\n")],
    "producers_8": [(EPIC, "constexpr int kPWarps = 4; ", "constexpr int kPWarps = 8; ")],
    "wide_tail": [(EPIC, "    const bool narrow = rows <= 2 * kWarpRows && lay.rows > 2 * kWarpRows;",
                   "    const bool narrow = false;")],
    "no_local": [(EPIC, "  for (int k0 = 0; k0 < hp; k0 += 8) {\n", "  for (int k0 = 0; k0 < 0; k0 += 8) {\n")],
    "no_global": [(EPIC, "  float* part = sm + lay.part;\n\n", "  float* part = sm + lay.part;\n  if (n > 0) return;\n")],
}
T = 32
# name -> (B, N, H, L, C, cond on the local path)
SHAPES = {"flagship": (640, 150, 128, 10, 2, True), "bigPC": (128, 558, 256, 256, 10, True),
          "jetclass_cond": (512, 128, 300, 16, 12, False)}


def make_variant(name: str) -> Path:
    out = ROOT / "build" / "variants" / f"epic_{name}"
    out.mkdir(parents=True, exist_ok=True)
    for f in (EPIC, MMA):
        shutil.copy(_build.CSRC_DIR / f, out / f)
    for file, old, new in VARIANTS[name]:
        text = (out / file).read_text()
        if text.count(old) != 1:
            sys.exit(f"epic_layer_variants: {file} no longer has {old!r} once")
        (out / file).write_text(text.replace(old, new))
    return out / EPIC


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", default=str(ROOT / "build" / "measurements" / "epic_layer_variants.json"))
    args = ap.parse_args()
    names = args.variants.split(",")
    if not torch.cuda.is_available():
        sys.exit("epic_layer_variants: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    sources = {name: make_variant(name) for name in names}
    _build.build_libraries(list(sources.values()))
    b, n, h, lat, c, _ = SHAPES["flagship"]
    result = {"card": card, "reports": {
        name: ops.launch_report(b, n, h, lat, T + c, T, T, c, c, source=src)
        for name, src in sources.items()}, "shapes": {}}
    print(json.dumps({"reports": result["reports"]}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    committed = ops.SOURCE
    for label, (b, n, h, lat, c, local) in SHAPES.items():
        cl = c if local else 0
        r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
        w = lambda *s: torch.randn(*s, generator=gen, device="cuda") / s[0] ** 0.5
        counts = torch.randint(30 if n > 30 else 1, n + 1, (b, 1), device="cuda", generator=gen)
        mask = (torch.arange(n, device="cuda")[None, :] < counts).float()
        a = [r(b, n, h), r(b, lat), mask, r(b, T + c),
             w(T + 2 * h + lat + c, h), r(h), w(T + h + c, lat), r(lat),
             w(h, h), w(T + lat + cl, h), r(h), w(h, h), w(T + cl, h), r(h)]
        dims = dict(sum_scale=1e-2, tg_dim=T, tl_dim=T, cg_dim=c, cl_dim=cl)
        want = ops.epic_layer_reference(*a, **dims)[0]
        row = {name: {"ms_rounds": []} for name in names}
        for order in (names, names[::-1]):
            for name in order:
                ops.SOURCE = sources[name]
                row[name]["max_abs_err"] = (ops.epic_layer(*a, **dims)[0] - want).abs().max().item()
                row[name]["ms_rounds"].append(cuda_ms(lambda: ops.epic_layer(*a, **dims)))
        ops.SOURCE = committed
        for v in row.values():
            v["ms"] = sum(v["ms_rounds"]) / len(v["ms_rounds"])
        row["plain_ms"] = cuda_ms(lambda: ops.epic_layer_reference(*a, **dims))
        result["shapes"][label] = row
        print(json.dumps({label: row}), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
