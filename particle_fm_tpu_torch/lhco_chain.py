"""The LHCO two-stage generation chain; counterpart of
scripts/generate_data_lhco.py.

    python -m particle_fm_tpu_torch.lhco_chain --stage1_run <jet-feature run> \
        --stage2_run <constituent run> [--stage2_run_y <y-jet run>] \
        [--n_samples N] [--ode_steps S] [--batch_size B] [--recluster] [--metrics] \
        [--out lhco_generated.h5] [--device cpu]

Stage 1 samples dijet features in the signal region with the flat model
(models/flow_matching_flat.py), conditioned on the held-out signal-region
mjj of its datamodule, tiled to `n_samples`. Stage 2 generates each jet's
constituents with a set model conditioned on that jet's stage-1 features
(pt, eta, phi, m, normalised with the stage-2 datamodule's statistics),
with a mask of the jet's stage-1 multiplicity, rounded and clipped to
[1, N]. One constituent model serves the leading jet; with `stage2_run_y`
a second one serves the subleading jet. `--recluster` turns the relative
(eta, phi, pt) constituents into absolute (pt, eta, phi) ones and clusters
each event with anti-kt (eval/lhco_utils.py); `--metrics` then compares
W1(mjj) and the per-jet features with the real signal region.

`generate_lhco_events` returns the payload in memory; `write_h5` writes it
as the JAX script does, through data/utils.py::import_h5py (the CLI asks
for h5py before it generates). The runs load through utils/run_io.py::
load_run with their EMA weights, on the card unless `--device cpu`; stage 2
generates through eval/generation.py::generate_data, so on the card the
EPiC networks fold and run the fused EPiC kernel. Stage-1 batch i draws its
noise from a generator seeded `serving.chunk_seed(seed, i)`; stage 2 seeds
its batches as generate_data does, from seed 0 for each jet, as the JAX
script hands both jets generate_data's default key.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch


@dataclasses.dataclass
class Stage:
    """A model, the network to sample with and its datamodule (set up)."""

    model: object
    net: torch.nn.Module
    dm: object

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device


def load_stage(run_dir: str, device="cuda") -> Stage:
    """The best checkpoint of a training run, with its EMA weights."""
    from particle_fm_tpu_torch.utils.run_io import load_run

    _, dm, model, net = load_run(run_dir, ckpt="best", ema=True, device=device)
    return Stage(model, net, dm)


def sample_jet_features(stage1: Stage, n_samples: int, batch_size: int = 1024,
                        ode_steps: int = 100, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(physical dijet features (n, 10), the normalised mjj cond (n, 1)):
    the flat model sampled on the signal region's mjj, tiled to n."""
    from particle_fm_tpu_torch.data.utils import inverse_normalize_tensor
    from particle_fm_tpu_torch.serving import chunk_seed

    dm1, dev = stage1.dm, stage1.device
    cond_sr = dm1.tensor_conditioning_test_sr
    reps = int(np.ceil(n_samples / len(cond_sr)))
    cond_sr = np.tile(cond_sr, (reps, 1))[:n_samples]
    feats = []
    for i, lo in enumerate(range(0, n_samples, batch_size)):
        hi = min(lo + batch_size, n_samples)
        gen = torch.Generator(dev).manual_seed(chunk_seed(seed, i))
        out = stage1.model.sample(stage1.net, gen, n_samples=hi - lo,
                                  cond=torch.as_tensor(cond_sr[lo:hi], device=dev),
                                  ode_steps=ode_steps)
        feats.append(out.cpu().numpy())
    feats = np.concatenate(feats, axis=0)
    return inverse_normalize_tensor(feats, dm1.means, dm1.stds,
                                    getattr(dm1, "normalize_sigma", 5)), cond_sr


def sample_constituents(stage2: Stage, jets2: np.ndarray, jet_idx: int, batch_size: int = 1024,
                        ode_steps: int = 100) -> tuple[np.ndarray, np.ndarray, float]:
    """(constituents (n, N, 3), mask (n, N, 1), generation seconds) of jet
    `jet_idx` of each event, from its stage-1 features jets2 (n, 2, 5)."""
    from particle_fm_tpu_torch.data.utils import normalize_tensor
    from particle_fm_tpu_torch.eval.generation import generate_data

    dm2 = stage2.dm
    n = len(jets2)
    cond_dim = dm2.tensor_conditioning_train.shape[-1]
    cond = normalize_tensor(jets2[:, jet_idx, :cond_dim], dm2.cond_means, dm2.cond_stds,
                            getattr(dm2, "normalize_sigma", 5)).astype(np.float32)
    # the multiplicities set the masks
    mult = np.clip(np.round(jets2[:, jet_idx, 4]).astype(int), 1, dm2.num_particles)
    mask = (np.arange(dm2.num_particles)[None, :] < mult[:, None]).astype(np.float32)[..., None]
    consts, gen_time = generate_data(
        stage2.model, stage2.net, num_jet_samples=n, batch_size=batch_size, cond=cond,
        variable_set_sizes=True, mask=mask, normalized_data=dm2.means is not None,
        normalize_sigma=getattr(dm2, "normalize_sigma", 5), means=dm2.means, stds=dm2.stds,
        log_pt=getattr(dm2, "log_pt", False),
        pt_standardization=getattr(dm2, "pt_standardization", False), ode_steps=ode_steps,
        device=stage2.device,
    )
    return consts, mask, gen_time


def generate_lhco_events(stage1: Stage, stage2: Stage, stage2_y: Stage | None = None,
                         n_samples: int = 10000, ode_steps: int = 100, batch_size: int = 1024,
                         recluster: bool = False) -> tuple[dict, dict]:
    """The chain in memory: (payload, timings). The payload holds
    `jet_features` (physical, (n, 10): per jet pt, eta, phi, m,
    multiplicity), `constituents`, `mask`, `mjj_cond`; with `stage2_y`
    `constituents_y`, `mask_y`; with `recluster` `clustered_jets`,
    `clustered_constituents`, `clustered_mask`."""
    import time

    t0 = time.perf_counter()
    feats_phys, cond_sr = sample_jet_features(stage1, n_samples, batch_size, ode_steps)
    timings = {"stage1_s": time.perf_counter() - t0}
    jets2 = feats_phys.reshape(len(feats_phys), 2, 5)
    consts, mask, timings["stage2_generation_time"] = sample_constituents(
        stage2, jets2, 0, batch_size, ode_steps)
    payload = {"jet_features": feats_phys, "constituents": consts, "mask": mask,
               "mjj_cond": cond_sr}
    if stage2_y is not None:
        payload["constituents_y"], payload["mask_y"], timings["stage2_y_generation_time"] = (
            sample_constituents(stage2_y, jets2, 1, batch_size, ode_steps))
    if recluster:
        from particle_fm_tpu_torch.data.utils import get_nonrel_consts
        from particle_fm_tpu_torch.eval.lhco_utils import cluster_data

        t0 = time.perf_counter()
        # relative (eta, phi, pt) -> absolute (pt, eta, phi)
        nonrel = get_nonrel_consts(jets2[:, 0, :4], consts[..., [2, 0, 1]])
        if stage2_y is not None:  # the whole dijet event in one cloud
            nonrel_y = get_nonrel_consts(jets2[:, 1, :4], payload["constituents_y"][..., [2, 0, 1]])
            nonrel = np.concatenate([nonrel, nonrel_y], axis=1)
        jets_cl, consts_cl, mask_cl = cluster_data(nonrel, num_particles=stage2.dm.num_particles)
        payload.update(clustered_jets=jets_cl, clustered_constituents=consts_cl,
                       clustered_mask=mask_cl)
        timings["cluster_s"] = time.perf_counter() - t0
    return payload, timings


def chain_metrics(payload: dict, stage1: Stage, stage2: Stage) -> dict:
    """W1(mjj) of the reclustered generated events against the real signal
    region's, and the W1s of each jet's (pt, y, phi, m) against the
    stage-1 datamodule's held-out signal-region jets."""
    from particle_fm_tpu_torch.data.utils import get_mjj
    from particle_fm_tpu_torch.eval.metrics import (calculate_wasserstein_metrics_jets,
                                                    wasserstein_distance_batched)

    jets_cl = payload["clustered_jets"]
    mjj_gen = get_mjj(jets_cl[:, 0], jets_cl[:, 1])
    mjj_real = np.asarray(stage2.dm.mjj_sr, dtype=np.float64)
    ok = np.isfinite(mjj_gen)
    n_eval = int(min(ok.sum(), len(mjj_real), 5000))
    w1_kwargs = dict(num_eval_samples=n_eval, num_batches=40)
    metrics = {}
    metrics["w1_mjj_mean"], metrics["w1_mjj_std"] = wasserstein_distance_batched(
        mjj_real, mjj_gen[ok], **w1_kwargs)
    real_sr = np.asarray(stage1.dm.tensor_test_sr, dtype=np.float64).reshape(-1, 2, 5)
    for j, name in ((0, "x"), (1, "y")):
        wj = calculate_wasserstein_metrics_jets(real_sr[:, j, :4], jets_cl[:, j], **w1_kwargs)
        metrics.update({f"{k}_{name}": float(v) for k, v in wj.items()})
    return metrics


def write_h5(payload: dict, path: str) -> None:
    from particle_fm_tpu_torch.data.utils import import_h5py

    with import_h5py().File(path, "w") as f:
        for k, v in payload.items():
            f.create_dataset(k, data=v)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage1_run", required=True, help="jet-feature (flat) run directory")
    ap.add_argument("--stage2_run", required=True,
                    help="constituent run directory (both jets, or the x jet with --stage2_run_y)")
    ap.add_argument("--stage2_run_y", default=None, help="a separate y-jet constituent run")
    ap.add_argument("--n_samples", type=int, default=10000)
    ap.add_argument("--ode_steps", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=1024)
    ap.add_argument("--recluster", action="store_true", help="anti-kt recluster the events")
    ap.add_argument("--metrics", action="store_true",
                    help="with --recluster: W1(mjj) and per-jet feature W1s against the real "
                         "signal region")
    ap.add_argument("--out", default="lhco_generated.h5")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.metrics and not args.recluster:
        raise SystemExit("--metrics requires --recluster")
    from particle_fm_tpu_torch.data.utils import import_h5py

    import_h5py()  # before hours of generation, not after
    stage1 = load_stage(args.stage1_run, args.device)
    stage2 = load_stage(args.stage2_run, args.device)
    stage2_y = load_stage(args.stage2_run_y, args.device) if args.stage2_run_y else None
    payload, timings = generate_lhco_events(stage1, stage2, stage2_y, args.n_samples,
                                            args.ode_steps, args.batch_size, args.recluster)
    print(f"[lhco] stage-1 features {payload['jet_features'].shape}, constituents "
          f"{payload['constituents'].shape}; {timings}", flush=True)
    if args.metrics:
        import yaml

        metrics = chain_metrics(payload, stage1, stage2)
        out_yaml = os.path.splitext(args.out)[0] + "_metrics.yaml"
        with open(out_yaml, "w") as f:
            yaml.safe_dump({k: float(v) for k, v in metrics.items()}, f)
        print(f"[lhco] W1(mjj) = {metrics['w1_mjj_mean']:.2f} +- {metrics['w1_mjj_std']:.2f} "
              f"GeV -> {out_yaml}")
    write_h5(payload, args.out)
    print(f"[lhco] wrote {args.out}")
    return payload


if __name__ == "__main__":
    main(sys.argv[1:])
