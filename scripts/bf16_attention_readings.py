#!/usr/bin/env python3
"""In-turn readings of the bfloat16 attention kernels redesigned for the H100
at their served shapes, beside the float32 fused kernel:

  packed_bf16     `packed_short_attention_bf16` at path A (fm_droid_transformer:
                  B=640, L=150, 16 heads of 16, q/k/v the three slices of one
                  QKV projection, 30-150 real keys), with bf16
                  `scaled_dot_product_attention` on the same tensors in the
                  same turns ("library");
  flash_bf16      `flash_masked_attention_bf16` at path D (lhco/jets_transformer:
                  B=256, Lq=Lk=279, 16 heads of 16, q/k/v the three slices of
                  one QKV projection, 30-279 real keys);
  fused_bf16_from `fused_short_attention_bf16`, path B's first half (B=640, 4
                  queries on 150 masked keys, 30-150 real, 16 heads of 8);
  fused_bf16_to   its second half (150 queries on 4 keys, no mask);
  fused_f32_from, fused_f32_to   the float32 kernel at the same two shapes.

    python3 scripts/bf16_attention_readings.py [--rounds 3] [--parent DIR]
        [--out build/measurements/bf16_attention_readings.json]

Each kernel is called through its wrapper and read with `cuda_ms`
(utils/timing.py: 20 calls between two CUDA events, the median of 5 such
runs, after 5 calls of warm-up; the host's time to issue a call is in it
where the host is slower than the device) and with `device_ms` (the
kernels' device time from torch.profiler), in `--rounds` rounds; a round
reads every (kernel, version) pair forwards, then backwards through the list,
so every reading has its neighbours on both sides (the library call is read
with `cuda_ms` only: it may launch more than one kernel). Printed: the median
of each pair's readings, every reading, and the maximum error against the
plain version (checked: 1e-4 in float32, 2 bfloat16 ulps of the largest |out|
in bfloat16); with `--parent`, also each committed kernel's largest
difference from the parent's on the same inputs (`max_abs_diff_from_parent`).

With `--parent DIR`, DIR holds another version of csrc/ (short_attention.cu,
flash_attention.cu and the headers they include); its libraries are built
beside the committed ones and read in the same turns, through the same
wrappers (the C entry points take the same arguments). An earlier commit's:

    mkdir -p build/parent/csrc
    git archive <commit> particle_fm_tpu_torch/csrc | tar -x -C build/parent
    python3 scripts/bf16_attention_readings.py --parent build/parent/particle_fm_tpu_torch/csrc
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import attention_case  # noqa: E402
from particle_fm_tpu_torch.ops import _build  # noqa: E402
from particle_fm_tpu_torch.ops import flash_attention as fa  # noqa: E402
from particle_fm_tpu_torch.ops import short_attention as sa  # noqa: E402
from particle_fm_tpu_torch.utils.timing import cuda_ms, device_ms  # noqa: E402


LIBRARY = "library"


def cases(dev):
    """name -> (module, wrapper, plain version, (q, k, v, mask))"""
    bf = lambda c: (*(x.to(torch.bfloat16) for x in c[:3]), c[3])
    a = attention_case(torch, dev, 60, 640, 150, 150, 16, 16, masked=True, fused_qkv=True)
    d = attention_case(torch, dev, 65, 256, 279, 279, 16, 16, masked=True, fused_qkv=True)
    frm = attention_case(torch, dev, 62, 640, 4, 150, 16, 8, masked=True)
    to = attention_case(torch, dev, 63, 640, 150, 4, 16, 8, masked=False)
    flash = (fa, "flash_masked_attention", "flash_masked_attention_reference")
    fused = (sa, "fused_short_attention", "fused_short_attention_reference")
    packed = (sa, "packed_short_attention", "packed_short_attention_reference")
    return {"packed_bf16": (*packed, bf(a[:4])), "flash_bf16": (*flash, bf(d[:4])),
            "fused_bf16_from": (*fused, bf(frm[:4])), "fused_bf16_to": (*fused, bf(to[:4])),
            "fused_f32_from": (*fused, frm[:4]), "fused_f32_to": (*fused, to[:4])}


def library(inputs):
    """bf16 `scaled_dot_product_attention` on the kernel's inputs, the mask
    as the additive (mask - 1) * 1e9 in bfloat16."""
    q, k, v, mask = inputs
    add = None if mask is None else ((mask - 1.0) * 1e9)[:, None, None, :].to(torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=add).transpose(1, 2)


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def tolerance(want) -> float:
    if want.dtype == torch.float32:
        return 1e-4
    top = float(want.float().abs().max())
    return 2 * 2.0 ** (math.floor(math.log2(top)) - 7)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--parent", type=Path, default=None, help="another version of csrc/")
    ap.add_argument("--out", default=str(ROOT / "build" / "measurements" /
                                         "bf16_attention_readings.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bf16_attention_readings: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    sources = {"committed": {sa: sa.SOURCE, fa: fa.SOURCE}}
    if args.parent is not None:
        parent = args.parent.resolve()
        sources = {"parent": {sa: parent / sa.SOURCE.name, fa: parent / fa.SOURCE.name},
                   **sources}
    _build.build_libraries([s for v in sources.values() for s in v.values()])

    def reader(module, wrapper, inputs, version):
        fn = getattr(module, wrapper)

        def call():
            module.SOURCE = sources[version][module]
            return fn(*inputs)
        return call

    committed = sources["committed"]
    readings, errs, diffs = {}, {}, {}
    with torch.no_grad():
        for name, (module, wrapper, plain, inputs) in cases(dev).items():
            want = getattr(module, plain)(*inputs)
            outs = {}
            for version in sources:
                call = reader(module, wrapper, inputs, version)
                outs[version] = call()
                errs[name, version] = max_err(outs[version], want)
                if not errs[name, version] <= tolerance(want):
                    raise SystemExit(f"{name} ({version}) disagrees with its plain version: "
                                     f"{errs[name, version]}")
                readings[name, version] = (call, [], [])
            if "parent" in outs:
                diffs[name] = max_err(outs["committed"], outs["parent"])
            if name == "packed_bf16":
                errs[name, LIBRARY] = max_err(library(inputs)(), want)
                readings[name, LIBRARY] = (library(inputs), [], None)
        order = list(readings)
        for _ in range(args.rounds):
            for key in order + order[::-1]:
                readings[key][1].append(cuda_ms(readings[key][0]))
            for key in order + order[::-1]:
                if readings[key][2] is not None:
                    readings[key][2].append(device_ms(readings[key][0]))
    for module, source in committed.items():
        module.SOURCE = source
    rows = []
    for (name, version), (_, ms, dms) in readings.items():
        rows.append({"card": card, "kernel": name, "version": version,
                     "median_ms": statistics.median(ms), "readings_ms": ms,
                     "median_device_ms": statistics.median(dms) if dms else None,
                     "device_readings_ms": dms, "max_abs_err": errs[name, version]})
        if version == "committed" and name in diffs:
            rows[-1]["max_abs_diff_from_parent"] = diffs[name]
        print(json.dumps(rows[-1]), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(json.dumps(r) for r in rows) + "\n")


if __name__ == "__main__":
    main()
