"""CaloChallenge preprocessing with the PyTorch port's scalers (the
counterpart of scripts/preprocessing_calo_challenge.py): voxelised showers
to point clouds, and the fitted per-feature scaler.

    python3 scripts/torch_preprocessing_calo_challenge.py \
        --input dataset_2_1.hdf5 [--num_z 45 --num_alpha 16 --num_r 9] \
        --out data/calo/dataset2.npz --scaler_out data/calo/scaler.pkl

    # no raw file at hand: the synthetic voxel grid
    python3 scripts/torch_preprocessing_calo_challenge.py --synthetic --out /tmp/calo.npz

Each voxel grid (num_z x num_alpha x num_r) becomes its hits (E, z, alpha,
r); a ScalerBase of data/calo_scalers.py (E: log1p, then standardised; z,
alpha, r: dequantised) is fitted on the pooled hits and pickled. The npz
(`showers`, an object array of per-shower hits, and `energies`) is what
data/calo.py::CaloChallengeDataModule(dataset_file=...) reads. A host job in
numpy; reading `--input` needs h5py, the synthetic mode does not.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def showers_to_pointclouds(showers: np.ndarray, num_z: int, num_alpha: int, num_r: int):
    """(B, num_z*num_alpha*num_r) voxel energies -> per-shower (n_hits,
    [E, z, alpha, r]) float32 arrays."""
    grids = showers.reshape(len(showers), num_z, num_alpha, num_r)
    out = []
    for grid in grids:
        z, a, r = np.nonzero(grid)
        e = grid[z, a, r]
        pc = np.stack([e, z.astype(np.float64), a.astype(np.float64), r.astype(np.float64)],
                      axis=-1)
        out.append(pc.astype(np.float32))
    return out


class Log1p:
    """x -> log(1 + x); the inverse is expm1 (float64 in, as sklearn's
    FunctionTransformer with validate=True)."""

    def fit(self, X, y=None):
        return self

    def transform(self, X, y=None):
        return np.log1p(np.asarray(X, np.float64))

    def inverse_transform(self, X, y=None):
        return np.expm1(np.asarray(X, np.float64))


def fit_scaler(pointclouds: list[np.ndarray]):
    """The per-feature scaler fitted on the pooled hits: log1p and
    standardisation of E, dequantisation of the integer coordinates."""
    from particle_fm_tpu_torch.data.calo_scalers import DQ, Pipeline, ScalerBase, StandardScaler

    log_e = Pipeline([("log1p", Log1p()), ("std", StandardScaler())])
    sb = ScalerBase([log_e, DQ(seed=0), DQ(seed=1), DQ(seed=2)], ["energy", "z", "alpha", "r"])
    pooled = np.concatenate([pc for pc in pointclouds if len(pc)], axis=0)
    sb.fit(pooled.astype(np.float64))
    return sb


def main(argv: list[str] | None = None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", help="raw CaloChallenge hdf5 (showers + incident_energies)")
    ap.add_argument("--num_z", type=int, default=45)
    ap.add_argument("--num_alpha", type=int, default=16)
    ap.add_argument("--num_r", type=int, default=9)
    ap.add_argument("--max_showers", type=int, default=0, help="0 = all")
    ap.add_argument("--synthetic", action="store_true",
                    help="generate a synthetic voxel file instead of reading --input")
    ap.add_argument("--out", required=True, help="output npz for CaloChallengeDataModule")
    ap.add_argument("--scaler_out", default=None, help="where to pickle the fitted ScalerBase")
    args = ap.parse_args(argv)

    if args.synthetic:
        rs = np.random.RandomState(0)
        n = args.max_showers or 500
        showers = rs.exponential(0.01, size=(n, args.num_z * args.num_alpha * args.num_r))
        showers[showers < 0.05] = 0.0  # sparsify
        energies = rs.uniform(1.0, 1000.0, size=(n, 1))
    else:
        if not args.input:
            raise SystemExit("--input required (or --synthetic)")
        from particle_fm_tpu_torch.data.utils import import_h5py

        with import_h5py().File(args.input, "r") as f:
            showers = np.asarray(f["showers"])
            energies = np.asarray(f["incident_energies"]).reshape(-1, 1)
        if args.max_showers:
            showers, energies = showers[: args.max_showers], energies[: args.max_showers]

    pcs = showers_to_pointclouds(showers, args.num_z, args.num_alpha, args.num_r)
    n_hits = np.array([len(pc) for pc in pcs])
    print(f"[calo] {len(pcs)} showers, hits/shower: "
          f"median {int(np.median(n_hits))}, max {int(n_hits.max())}")

    scaler = fit_scaler(pcs)
    if args.scaler_out:
        os.makedirs(os.path.dirname(args.scaler_out) or ".", exist_ok=True)
        with open(args.scaler_out, "wb") as f:
            pickle.dump(scaler, f)
        print(f"[calo] scaler saved to {args.scaler_out}")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(args.out, showers=np.array(pcs, dtype=object),
                        energies=energies.astype(np.float32))
    print(f"[calo] wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
