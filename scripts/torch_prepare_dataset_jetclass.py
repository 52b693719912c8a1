"""Prepare JetClass training files from raw per-type arrays, with the
PyTorch port's data modules (the counterpart of
scripts/prepare_dataset_jetclass.py):

    python3 scripts/torch_prepare_dataset_jetclass.py --raw_dir <dir> --out_dir data/jetclass
        [--splits 0.7 0.15 0.15] [--synthetic] [--seed 0]

Merge the per-jet-type files `<raw_dir>/<type>.h5` (part_features (N, P, F)
unstandardised, part_mask (N, P), jet_features (N, J), labels, with their
`names_*` attributes), shuffle them with RandomState(seed), take masked
per-feature means and stds over the train split's real particles, and write
the standardised train/val/test h5 files that
data/jetclass.py::JetClassDataModule reads (part_features, part_mask,
jet_features, labels, part_means, part_stds, with `names_*` attributes).
`--synthetic` first writes demo raw inputs (three jet types, 2,000 jets of 32
particles each, data/jetclass.py::synthetic_jetclass_file). A host job in
numpy; it needs h5py and raises at once without it.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv: list[str] | None = None) -> list[str]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--raw_dir", default=None)
    ap.add_argument("--out_dir", default="data/jetclass")
    ap.add_argument("--splits", type=float, nargs=3, default=[0.7, 0.15, 0.15])
    ap.add_argument("--synthetic", action="store_true", help="generate demo raw inputs first")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from particle_fm_tpu_torch.data.jetclass import JETCLASS_TYPES, synthetic_jetclass_file
    from particle_fm_tpu_torch.data.utils import import_h5py, masked_mean_std

    h5py = import_h5py()
    raw_dir = args.raw_dir or os.path.join(args.out_dir, "raw")
    if args.synthetic:
        os.makedirs(raw_dir, exist_ok=True)
        for i, jt in enumerate(JETCLASS_TYPES[:3]):
            synthetic_jetclass_file(os.path.join(raw_dir, f"{jt}.h5"), num_jets=2000,
                                    num_particles=32, num_types=3, seed=args.seed + i)
        print(f"[prepare_jetclass] wrote synthetic raw inputs to {raw_dir}")

    files = sorted(f for f in os.listdir(raw_dir) if f.endswith(".h5"))
    if not files:
        raise FileNotFoundError(f"no raw .h5 files in {raw_dir}")

    parts, masks, jets, labels = [], [], [], []
    names = {}
    for f in files:
        with h5py.File(os.path.join(raw_dir, f), "r") as h:
            parts.append(np.asarray(h["part_features"]))
            masks.append(np.asarray(h["part_mask"]))
            jets.append(np.asarray(h["jet_features"]))
            labels.append(np.asarray(h["labels"]))
            for k in ("part_features", "jet_features", "labels"):
                names[k] = np.asarray(h[k].attrs[f"names_{k}"])

    x, mask = np.concatenate(parts), np.concatenate(masks)
    jf, lb = np.concatenate(jets), np.concatenate(labels)
    perm = np.random.RandomState(args.seed).permutation(len(x))
    x, mask, jf, lb = x[perm], mask[perm], jf[perm], lb[perm]

    n = len(x)
    n_train, n_val = int(args.splits[0] * n), int(args.splits[1] * n)
    bounds = {"train": (0, n_train), "val": (n_train, n_train + n_val),
              "test": (n_train + n_val, n)}

    # the standardisation constants of the train split only
    means, stds = masked_mean_std(x[:n_train], mask[:n_train, :, None])
    stds = np.where(stds == 0, 1.0, stds)

    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    for split, (lo, hi) in bounds.items():
        path = os.path.join(args.out_dir, f"{split}.h5")
        with h5py.File(path, "w") as h:
            std_x = ((x[lo:hi] - means) / stds) * mask[lo:hi][..., None]
            for key, data, attr, attr_names in (
                ("part_features", std_x, "names_part_features", names["part_features"]),
                ("part_mask", mask[lo:hi], None, None),
                ("jet_features", jf[lo:hi], "names_jet_features", names["jet_features"]),
                ("labels", lb[lo:hi], "names_labels", names["labels"]),
                ("part_means", means, "names_part_means", names["part_features"]),
                ("part_stds", stds, "names_part_stds", names["part_features"]),
            ):
                d = h.create_dataset(key, data=np.asarray(data).astype(np.float32))
                if attr is not None:
                    d.attrs[attr] = attr_names
        print(f"[prepare_jetclass] wrote {path} ({hi - lo} jets)")
        written.append(path)
    return written


if __name__ == "__main__":
    main()
