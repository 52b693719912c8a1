#!/usr/bin/env python3
"""Time design variants of the tensor-core attention kernels against the
committed ones, in turns, at the served shapes.

    python3 scripts/attention_mma_variants.py [--variants one_product,keys_8,...]
        [--out build/measurements/attention_mma_variants.json]

A variant is a copy of csrc/ under build/variants/<name>/ with one or more
lines of csrc/attention_mma.cuh or csrc/short_attention.cu replaced (the
script fails if a line it wants to replace is no longer there):

  one_product      one TF32 product per float32 product (wrong to 1e-3: it
                   shows what the other two cost)
  truncate         the TF32 head by clearing bits, not rounding to nearest
  cvt_rna          the TF32 head by cvt.rna.tf32.f32
  keys_8           8 keys per softmax step at every head dim (not 16 up to 16)
  no_register_cap  the packed kernel without its cap of 64 registers
  keys_8_no_cap    both of the last two
  first_version    cvt_rna and keys_8_no_cap together: the tile step as it was
                   first written

Each is built with nvcc as the port builds its own, checked against the
plain version (max abs error printed, not asserted: one_product is meant to
miss), and timed with CUDA events in two rounds (forwards, then backwards
through the list, so that clock ramps hit all alike; utils/timing.py) at the
packed kernel's served shape (B=640, L=150, 16 heads of 16, q/k/v slices of
one QKV projection) and the flash kernel's (B=256, Lq=Lk=279, 16 heads of 16).
Prints one JSON line per shape with the mean ms per variant, and the
registers per thread of the two kernels as each library reports them.
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

from chip_smoke import attention_case  # noqa: E402
from particle_fm_tpu_torch.ops import _build, flash_attention, short_attention  # noqa: E402
from particle_fm_tpu_torch.utils.timing import cuda_ms  # noqa: E402

MMA, SHORT, FLASH = "attention_mma.cuh", "short_attention.cu", "flash_attention.cu"
KEYS_8 = (MMA, "return dp <= 16 ? 2 : 1;", "return 1;")
NO_CAP = (SHORT, "DP <= 16 && !kBias ? 2 : 1)", "1)")
HEAD = "  r.hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
CVT_RNA = (MMA, HEAD, '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r.hi) : "f"(x));\n')
# name -> [(file, line as committed, replacement)]
VARIANTS = {
    "committed": [],
    "one_product": [(MMA, "  mma_tf32(c, a_lo, b0.hi, b1.hi);\n  mma_tf32(c, a_hi, b0.lo, b1.lo);\n", "")],
    "truncate": [(MMA, HEAD, "  r.hi = __float_as_uint(x) & 0xffffe000u;\n")],
    "cvt_rna": [CVT_RNA],
    "keys_8": [KEYS_8],
    "no_register_cap": [NO_CAP],
    "keys_8_no_cap": [KEYS_8, NO_CAP],
    "first_version": [CVT_RNA, KEYS_8, NO_CAP],
}


def make_variant(name: str) -> Path:
    out = ROOT / "build" / "variants" / name
    out.mkdir(parents=True, exist_ok=True)
    for src in _build.CSRC_DIR.glob("*attention*.cu*"):
        shutil.copy(src, out / src.name)
    for file, old, new in VARIANTS[name]:
        text = (out / file).read_text()
        if text.count(old) != 1:
            sys.exit(f"attention_mma_variants: {file} no longer has the line {old!r} once")
        (out / file).write_text(text.replace(old, new))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", default=str(ROOT / "build" / "measurements" / "attention_mma_variants.json"))
    args = ap.parse_args()
    names = args.variants.split(",")
    if not torch.cuda.is_available():
        sys.exit("attention_mma_variants: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda", 0)

    # a variant's headers lie beside its source: the compiler finds them there
    # first, and the library's name hashes them
    dirs = {name: make_variant(name) for name in names}
    _build.build_libraries([d / f for d in dirs.values() for f in (SHORT, FLASH)])
    committed = short_attention.SOURCE, flash_attention.SOURCE
    result = {"card": card, "registers": {}, "shapes": {}}
    for name in names:
        short_attention.SOURCE, flash_attention.SOURCE = dirs[name] / SHORT, dirs[name] / FLASH
        result["registers"][name] = {
            "packed_attention_kernel<16, no bias>":
                short_attention.packed_launch_report(150, 16)["registers_per_thread"],
            "flash_mma_kernel<16>": flash_attention.mma_launch_report(279, 16)["registers_per_thread"]}
    short_attention.SOURCE, flash_attention.SOURCE = committed
    print(json.dumps({"registers": result["registers"]}))

    shapes = {
        "packed B=640 L=150 H=16 D=16": (
            short_attention, SHORT, short_attention.packed_short_attention,
            short_attention.packed_short_attention_reference,
            attention_case(torch, dev, 3, 640, 150, 150, 16, 16, masked=True, fused_qkv=True)[:4]),
        "flash B=256 L=279 H=16 D=16": (
            flash_attention, FLASH, flash_attention.flash_masked_attention,
            flash_attention.flash_masked_attention_reference,
            attention_case(torch, dev, 9, 256, 279, 279, 16, 16, masked=True, fused_qkv=True)[:4]),
    }
    for label, (module, file, fn, ref, case) in shapes.items():
        committed = module.SOURCE
        want = ref(*case)
        row = {name: {"ms_rounds": []} for name in names}
        for order in (names, names[::-1]):
            for name in order:
                module.SOURCE = dirs[name] / file
                row[name]["max_abs_err"] = (fn(*case) - want).abs().max().item()
                row[name]["ms_rounds"].append(cuda_ms(lambda: fn(*case)))
        module.SOURCE = committed
        for r in row.values():
            r["ms"] = sum(r["ms_rounds"]) / len(r["ms_rounds"])
        result["shapes"][label] = row
        print(json.dumps({label: {n: {"ms": round(r["ms"], 4), "max_abs_err": r["max_abs_err"]}
                                  for n, r in row.items()}}), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
