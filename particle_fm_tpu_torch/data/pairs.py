"""Datamodule of teacher-generated (noise, sample) pairs; counterpart of
particle_fm_tpu/data/pairs.py.

Feeds ReFlow distillation (training/reflow.py): `x` packs concat(x1, x0)
along the feature axis, so the (x, mask, cond) batch contract and the
Trainer apply unchanged (losses/flow_matching.py::reflow_loss splits them).
Pairs live in the teacher datamodule's normalised space; the teacher's
means/stds/cond stats stored beside them are kept, so that the student's
samples can be undone with the teacher's pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from particle_fm_tpu_torch.data.base import ArrayDataModule, Split


@dataclass
class ReflowPairsDataModule(ArrayDataModule):
    """Loads an npz written by training/reflow.py's pipeline
    (scripts/torch_reflow.py; keys: x1, x0, optional mask/cond, optional
    means/stds/cond_means/cond_stds). The validation split is a seeded
    permutation's first `val_fraction`, as in the JAX package."""

    pairs_path: str = ""
    val_fraction: float = 0.05
    seed: int = 42

    def setup(self) -> None:
        d = np.load(self.pairs_path, allow_pickle=False)
        x1, x0 = d["x1"], d["x0"]
        if x1.shape != x0.shape:
            raise ValueError(f"pair shape mismatch: {x1.shape} vs {x0.shape}")
        x = np.concatenate([x1, x0], axis=-1).astype(np.float32)
        mask = d["mask"].astype(np.float32) if "mask" in d else np.ones_like(x1[..., :1])
        cond = d["cond"].astype(np.float32) if "cond" in d else None

        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(len(x))
        n_val = max(1, int(len(x) * self.val_fraction))
        v, tr = perm[:n_val], perm[n_val:]
        self.train = Split(x[tr], mask[tr], cond[tr] if cond is not None else None)
        self.val = Split(x[v], mask[v], cond[v] if cond is not None else None)
        self.test = self.val

        for k in ("means", "stds", "cond_means", "cond_stds"):
            if k in d:
                setattr(self, k, d[k])
        # the raw views (the x1 half only)
        self.tensor_train, self.mask_train = x1[tr], mask[tr]
        self.tensor_val = self.tensor_test = x1[v]
        self.mask_val = self.mask_test = mask[v]
        if cond is not None:
            self.tensor_conditioning_train = cond[tr]
            self.tensor_conditioning_val = self.tensor_conditioning_test = cond[v]
