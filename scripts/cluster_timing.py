"""Time the port's jet clusterer against another version of its source.

    python3 scripts/cluster_timing.py [--compare particle_fm_tpu/native/fastjet_lite/cluster.cpp]
        [--jets 10000] [--rounds 2] [--out build/measurements/cluster_timing.json]

The eval path's clustering stage at N = 150: tau1-3 (three exclusive-kt
clusterings with WTA axes, `eval/substructure.py::nsubjettiness`) and the kt
splitting scales d12/d23 (`native/binding.py::kt_split_scales`, R = 0.8) on
`--jets` synthetic JetNet-150 top jets. Both sources are built with the
binding's own flags into build/native/ and called through the binding (events
split over threads as the eval path splits them), in turns: committed,
compare, compare, committed, `--rounds` times. Fails unless both give the same
results bit for bit. The clustering runs on the host; the card's name and
power limit are recorded with the host's core count where `nvidia-smi` exists.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compare", default=str(ROOT / "particle_fm_tpu" / "native" / "fastjet_lite"
                                             / "cluster.cpp"))
    ap.add_argument("--jets", type=int, default=10_000)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "build" / "measurements" / "cluster_timing.json"))
    args = ap.parse_args()

    from particle_fm_tpu_torch.data.synthetic import synthetic_jetnet
    from particle_fm_tpu_torch.eval.substructure import nsubjettiness
    from particle_fm_tpu_torch.native import binding

    sources = {"committed": binding.SOURCE, "compare": Path(args.compare).resolve()}
    libs = {}
    for name, source in sources.items():
        binding.SOURCE, binding._lib = source, None
        libs[name] = binding.get_lib()

    parts, _ = synthetic_jetnet(["t"], num_jets=args.jets, num_particles=150, seed=0)
    x = parts[..., :3].astype(np.float64)
    pt, eta, phi = x[..., 2], x[..., 0], x[..., 1]
    mask = (pt > 0).astype(np.float64)

    def stage():
        return nsubjettiness(pt, eta, phi, mask), binding.kt_split_scales(pt, eta, phi, R=0.8)

    times = {name: [] for name in libs}
    results = {}
    for _ in range(args.rounds):
        for name in ("committed", "compare", "compare", "committed"):
            binding._lib = libs[name]
            t0 = time.perf_counter()
            results[name] = stage()
            times[name].append(time.perf_counter() - t0)
    (taus_a, d_a), (taus_b, d_b) = results["committed"], results["compare"]
    same = all(np.array_equal(a, b) for a, b in zip((*taus_a, d_a), (*taus_b, d_b)))
    card = None
    if shutil.which("nvidia-smi"):
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
    report = {"card": card, "host_cores": len(os.sched_getaffinity(0)), "jets": args.jets,
              "stage": "nsubjettiness (tau1-3) + kt_split_scales, N=150",
              "sources": {k: str(v.relative_to(ROOT)) for k, v in sources.items()},
              "seconds": times, "min_s": {k: min(v) for k, v in times.items()},
              "bit_equal": same}
    print(json.dumps(report))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    if not same:
        raise SystemExit("the two sources disagree")


if __name__ == "__main__":
    main()
