#!/usr/bin/env python3
"""What held the first fused short-set attention kernel back: its access
pattern or its serial chain of reductions. Times, in turns, at the two shapes
the cross-attention model serves (B=640, 16 heads of 8: 4 queries on 150
masked keys, and 150 queries on 4 keys):

  parent     an earlier version of csrc/short_attention.cu;
  copy_only  the same source with the fused kernel's arithmetic taken out: it
             stages K and V of a head in shared memory, reads every query row
             and writes every output row as the parent does, and computes
             nothing (its output is wrong on purpose);
  committed  csrc/short_attention.cu as it stands.

    mkdir -p build/parent
    for f in short_attention.cu attention_common.cuh attention_mma.cuh; do
      git show <commit>:particle_fm_tpu_torch/csrc/$f > build/parent/$f; done
    python3 scripts/fused_attention_reading.py --parent build/parent/short_attention.cu

If copy_only takes about as long as parent, the access pattern holds the
parent back; if it takes about as long as the bytes at the card's memory rate,
the arithmetic does. Each version is timed with CUDA events (utils/timing.py)
in two rounds (forwards, then backwards through the list) and checked against
the plain version (max abs error printed, not asserted). Prints one JSON line
per shape and writes build/measurements/fused_attention_reading.json.
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
from particle_fm_tpu_torch.ops import _build, short_attention  # noqa: E402
from particle_fm_tpu_torch.utils.timing import cuda_ms  # noqa: E402

# the arithmetic of the first fused kernel, from its scores to its reduced output
COMPUTE_FROM = "    float s[KPL];\n"
COMPUTE_TO = "    for (int c = 0; c < DP; ++c) o[c] = group_sum<G>(o[c]);\n"
COPY = ("    float o[DP];\n#pragma unroll\n"
        "    for (int c = 0; c < DP; ++c) o[c] = qr[c] + ks[gl * ST + c] + vs[gl * ST + c];\n")


def copy_only(parent: Path) -> Path:
    out = ROOT / "build" / "variants" / "fused_copy_only"
    out.mkdir(parents=True, exist_ok=True)
    for src in parent.parent.glob("*.cu*"):
        shutil.copy(src, out / src.name)
    text = parent.read_text()
    a, b = text.find(COMPUTE_FROM), text.find(COMPUTE_TO)
    if a < 0 or b < a or text.count(COMPUTE_FROM) != 1:
        sys.exit("fused_attention_reading: the parent's fused kernel is not the one this "
                 "script knows how to strip")
    (out / parent.name).write_text(text[:a] + COPY + text[b + len(COMPUTE_TO):])
    return out / parent.name


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--out", default=str(ROOT / "build" / "measurements" /
                                         "fused_attention_reading.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("fused_attention_reading: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda", 0)
    sources = {"parent": args.parent.resolve(), "copy_only": copy_only(args.parent.resolve()),
               "committed": short_attention.SOURCE}
    _build.build_libraries(list(sources.values()))
    names = list(sources)
    fn, ref = short_attention.fused_short_attention, short_attention.fused_short_attention_reference
    result = {"card": card, "shapes": {}}
    for label, case in {
        "4 queries on 150 keys": attention_case(torch, dev, 5, 640, 4, 150, 16, 8, masked=True),
        "150 queries on 4 keys": attention_case(torch, dev, 6, 640, 150, 4, 16, 8, masked=False),
    }.items():
        q, k, v, mask, _ = case
        want = ref(q, k, v, mask)
        n_bytes = 4 * (2 * q.numel() + k.numel() + v.numel() + (0 if mask is None else mask.numel()))
        row = {name: {"ms_rounds": []} for name in names}
        for order in (names, names[::-1]):
            for name in order:
                short_attention.SOURCE = sources[name]
                row[name]["max_abs_err"] = (fn(q, k, v, mask) - want).abs().max().item()
                row[name]["ms_rounds"].append(cuda_ms(lambda: fn(q, k, v, mask)))
        short_attention.SOURCE = sources["committed"]
        for r in row.values():
            r["ms"] = sum(r["ms_rounds"]) / len(r["ms_rounds"])
        row["bytes_ms_at_3.35_TB_per_s"] = n_bytes / 3.35e12 * 1e3
        result["shapes"][label] = row
        print(json.dumps({label: row}), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
