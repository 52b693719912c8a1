"""Import a trained reference (ewencedr/particle_fm) Lightning checkpoint into
a run directory of the PyTorch port (the counterpart of
scripts/import_reference_ckpt.py):

    python3 scripts/torch_import_reference_ckpt.py \
        --ckpt /path/to/epoch=...-EMA.ckpt --out runs/imported_tops30 \
        experiment=jetnet/fm_tops30_cond [model.hidden_dim=128 ...]

The trailing dotlist composes the port's config as the training CLI does; it
must describe the model the checkpoint was trained with (the shape-checked
mapping of particle_fm_tpu_torch/utils/torch_import.py raises on any
mismatch). The output is a whole run directory: `config.yaml` and
`checkpoints/last.pt` (training/checkpoint.py's format) with the imported
tensors as both the parameters and their EMA twin, and a fresh AdamW state.
Every tool of the port loads it unchanged:

    python -m particle_fm_tpu_torch.eval_ckpt --run_dir <out> --ckpt last
    python -m particle_fm_tpu_torch.evaluate ckpt_path=<out> ckpt=last
    python3 scripts/torch_serve_model.py --run_dir <out> --ckpt last
    python3 scripts/torch_export_model.py --run_dir <out> --ckpt last
    python3 scripts/torch_reflow.py --run_dir <out> --ckpt last
    python -m particle_fm_tpu_torch.train ... load_weights_from=<out>/checkpoints/last.pt

Pass the reference's `-EMA.ckpt` sidecar to import the EMA weights, which are
what the reference evaluates. The import is a host job: the checkpoint is
read with `torch.load(weights_only=True)` and written on the CPU, and the
tools above place it on the card when they load it.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: list[str] | None = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", required=True, help="reference .ckpt/.pt file")
    ap.add_argument("--out", default=None, help="output run dir (default runs/imported/<time>)")
    ap.add_argument("overrides", nargs="*",
                    help="config dotlist, e.g. experiment=jetnet/fm_tops30_cond model.layers=6")
    args = ap.parse_args(argv)

    import torch

    from particle_fm_tpu_torch.config.core import compose, save_config
    from particle_fm_tpu_torch.train import CONFIG_DIR
    from particle_fm_tpu_torch.training.checkpoint import CheckpointManager
    from particle_fm_tpu_torch.training.step import create_train_state
    from particle_fm_tpu_torch.utils.run_io import build_run
    from particle_fm_tpu_torch.utils.torch_import import (
        load_reference_checkpoint,
        state_dict_from_reference,
    )

    cfg = compose(CONFIG_DIR, "train", overrides=list(args.overrides))
    out_dir = args.out or os.path.join("runs/imported", time.strftime("%Y-%m-%d_%H-%M-%S"))
    os.makedirs(out_dir, exist_ok=True)

    # the optimizer is the run's (the checkpointed AdamW state belongs to
    # it), built as utils/run_io.py::load_run rebuilds it
    _dm, model, optimizer = build_run(cfg)
    state = create_train_state(model, optimizer, seed=0, device="cpu")
    sd = load_reference_checkpoint(args.ckpt)
    state.net.load_state_dict(state_dict_from_reference(sd, model))
    with torch.no_grad():  # the imported tensors as the EMA twin too
        for e, p in zip(state.ema_params, state.net.parameters(), strict=True):
            e.copy_(p)
    print(f"[import] converted {len(sd)} reference tensors from {args.ckpt}")

    save_config(cfg, os.path.join(out_dir, "config.yaml"))
    cm = CheckpointManager(os.path.join(out_dir, "checkpoints"),
                           (cfg.get("trainer") or {}).get("ckpt_monitors", {"val_loss": "min"}))
    path = cm.save_last(state)
    cm.flush()
    print(f"[import] wrote run dir {out_dir} (checkpoint: {path})")
    print(f"[import] evaluate with: python -m particle_fm_tpu_torch.eval_ckpt --run_dir {out_dir} "
          "--ckpt last")
    return out_dir


if __name__ == "__main__":
    main()
