"""`make repro-flagship` with the PyTorch port on one GPU.

    python scripts/torch_repro_flagship.py [--epochs 800] [--out DIR]

Trains fm_tops150_cond on 30,000 synthetic jets (`cond_dropout=0.1`) with the
shipped eval callbacks and test pass through `particle_fm_tpu_torch.train`,
then runs the full-chain evaluation `particle_fm_tpu_torch.eval_ckpt` on the
run's best checkpoint. The run directory goes under runs/; its config,
per-epoch metrics, test metrics and eval metrics are copied into --out
(default chiprun_out/repro_flagship) with a summary.json that holds the
card's name and power limit and the wall time of each part.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=800)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "repro_flagship"))
    args = ap.parse_args()

    import torch

    from particle_fm_tpu_torch import eval_ckpt
    from particle_fm_tpu_torch import train as ptrain

    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; this script runs on an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    overrides = ["experiment=jetnet/fm_tops150_cond", "data.synthetic=true",
                 "data.synthetic_num_jets=30000", f"trainer.max_epochs={args.epochs}",
                 "model.cond_dropout=0.1", f"output_dir={ROOT / 'runs' / 'repro_flagship_torch'}"]
    t0 = time.perf_counter()
    metrics, objs = ptrain.main(overrides)
    train_s = time.perf_counter() - t0
    run_dir = objs["out_dir"]
    t0 = time.perf_counter()
    eval_metrics = eval_ckpt.main(["--run_dir", run_dir])
    eval_s = time.perf_counter() - t0

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for name in ("config.yaml", "metrics.jsonl", "final_metrics.yaml", "eval_metrics.yaml"):
        shutil.copy(Path(run_dir) / name, out / name)
    history = objs["trainer"].metrics_history
    summary = {"card": card, "overrides": overrides, "train_and_test_s": train_s,
               "eval_ckpt_s": eval_s, "epochs": len(history), "steps": objs["trainer"].state.step,
               "median_epoch_time_s": sorted(m["epoch_time"] for m in history)[len(history) // 2],
               "test_metrics": {k: float(v) for k, v in metrics.items()
                                if isinstance(v, (int, float))},
               "eval_ckpt_metrics": {k: float(v) for k, v in eval_metrics.items()}}
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
