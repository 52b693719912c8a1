"""Generate JetClass jets from a trained run through the PyTorch port and
write them in the JetClass h5 layout (the counterpart of
scripts/generate_jets_jetclass.py):

    python3 scripts/torch_generate_jets_jetclass.py --run_dir <run> [--n_samples N]
        [--use_gen_conditioning] [--out generated_jetclass.h5] [--device cpu]

Sample with the test split's (truth) conditioning and masks, or with
`--use_gen_conditioning` the generated-conditioning file the datamodule was
configured with (`tensor_conditioning_gen`, `mask_gen`); un-standardise;
write `part_features` (with `names_part_features`), `part_mask` and
`conditioning` (with `names_conditioning`). Generation runs on the card
unless `--device cpu` is given; the h5 file needs h5py, asked for before the
generation.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _names(names) -> np.ndarray:
    return np.asarray([n.encode() if isinstance(n, str) else n for n in names])


def main(argv: list[str] | None = None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--run_dir", required=True)
    ap.add_argument("--ckpt", default="best", choices=["best", "last"])
    ap.add_argument("--n_samples", type=int, default=None)
    ap.add_argument("--ode_steps", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=1024)
    ap.add_argument("--use_gen_conditioning", action="store_true",
                    help="condition on the datamodule's generated-conditioning file")
    ap.add_argument("--out", default="generated_jetclass.h5")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from particle_fm_tpu_torch.data.utils import import_h5py
    from particle_fm_tpu_torch.eval.generation import generate_data
    from particle_fm_tpu_torch.utils.device import resolve_device
    from particle_fm_tpu_torch.utils.run_io import load_run

    h5py = import_h5py()
    device = resolve_device(args.device)
    _cfg, dm, model, net = load_run(args.run_dir, args.ckpt, device=device)

    if args.use_gen_conditioning:
        if getattr(dm, "tensor_conditioning_gen", None) is None:
            raise ValueError("datamodule has no generated-conditioning file configured")
        cond, mask = dm.tensor_conditioning_gen, dm.mask_gen
    else:
        cond, mask = dm.tensor_conditioning_test, dm.mask_test
    n = min(args.n_samples or len(mask), len(mask))

    gen, gen_time = generate_data(
        model, net, num_jet_samples=n, batch_size=args.batch_size,
        cond=cond[:n] if cond is not None else None, variable_set_sizes=True, mask=mask[:n],
        normalized_data=dm.means is not None, normalize_sigma=getattr(dm, "normalize_sigma", 5),
        means=dm.means, stds=dm.stds, ode_steps=args.ode_steps, seed=0, device=device,
    )
    print(f"[generate_jetclass] generated {gen.shape} in {gen_time:.1f}s")

    names_part = getattr(dm, "names_particle_features", None)
    names_cond = getattr(dm, "names_conditioning", None)
    with h5py.File(args.out, "w") as f:
        d = f.create_dataset("part_features", data=gen.astype(np.float32))
        if names_part is not None:
            d.attrs["names_part_features"] = _names(names_part)
        f.create_dataset("part_mask", data=mask[:n][..., 0].astype(np.float32))
        if cond is not None:
            d = f.create_dataset("conditioning", data=cond[:n].astype(np.float32))
            if names_cond is not None:
                d.attrs["names_conditioning"] = _names(names_cond)
    print(f"[generate_jetclass] wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
