"""Standalone full evaluation of a trained run; counterpart of
scripts/eval_ckpt.py.

    python -m particle_fm_tpu_torch.eval_ckpt --run_dir <run> [--ckpt best|last]
        [--n_samples N] [--ode_steps K] [--no-cache] [--device cpu] [--dtype bfloat16]
        [--write_classifier_h5]

Reload the run's saved config.yaml, restore the checkpoint's EMA weights
(served in `--dtype` when given, else in the run's `model.dtype`),
generate (or reuse the cached `.npz` of an earlier call with the same
checkpoint, sample count, guidance and type) samples against the test split,
postprocess them (clip generated features to the training range, argmax
particle-ID one-hots, round charge, drop sets with < 3 particles, or fewer than all where a set has
fewer than 3 slots), then
compute W1M/W1P/W1EFP, the substructure W1s (tau21, tau32, D2; 40 bootstrap
batches) and the reverse KLD per feature, and write eval_metrics.yaml into
the run directory. Generation, the EFPs and the energy correlators run on
the card unless `--device cpu` is given; without CUDA it raises. With
`--write_classifier_h5` the generated and the kept test sets, their masks
and cond, and their substructure are written as the classifier test's input
(`write_classifier_h5`, the JAX package's schema, read by
data/jetclass_classifier.py); it needs h5py and raises at once without it.

Not ported: the comparison plot.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import yaml

from particle_fm_tpu_torch.data.utils import import_h5py
from particle_fm_tpu_torch.models.flow_matching import SOLVERS

VARIABLES_TO_CLIP = ["part_etarel", "part_dphi", "part_ptrel"]


def postprocess(data_gen, mask_gen, cond_gen, names_part_features=None,
                min_max_train_dict=None):
    """Reference postprocessing chain (scripts/eval_ckpt.py:273-338)."""
    names = [
        n.decode() if isinstance(n, bytes) else str(n)
        for n in (names_part_features if names_part_features is not None else [])
    ]
    if min_max_train_dict:
        for i, var in enumerate(names):
            if var not in VARIABLES_TO_CLIP or var not in min_max_train_dict:
                continue
            sel = mask_gen[..., 0] != 0
            data_gen[sel, i] = np.clip(
                data_gen[sel, i],
                min_max_train_dict[var]["min"],
                min_max_train_dict[var]["max"],
            )
    is_idx = [i for i, n in enumerate(names) if n.startswith("part_is")]
    if is_idx:
        pid = data_gen[:, :, is_idx]
        arg = np.argmax(pid, axis=-1)
        onehot = np.zeros_like(pid)
        onehot[np.arange(pid.shape[0])[:, None], np.arange(pid.shape[1]), arg] = 1
        data_gen[:, :, is_idx] = onehot
        data_gen[mask_gen[..., 0] == 0, :] = 0
    if "part_charge" in names:
        i = names.index("part_charge")
        data_gen[:, :, i] = np.round(data_gen[:, :, i])
    keep = np.sum(mask_gen[:, :, 0], axis=1) >= min(3, mask_gen.shape[1])
    return data_gen[keep], mask_gen[keep], (cond_gen[keep] if cond_gen is not None else None)


def write_classifier_h5(path: str, dm, gen, mask_gen, cond_gen, real, mask_real, cond_real,
                        hl_gen: dict, hl_real: dict) -> None:
    """The classifier test's input in the JAX package's schema: `path` with
    part_data_{gen,sim} and cond_data_{gen,sim} (each with a `names`
    attribute), part_mask_{gen,sim}; its `_substructure.h5` twin with
    {tau1,tau2,tau3,tau21,tau32,d2}_{gen,sim}."""
    h5py = import_h5py()
    names_part = [n.decode() if isinstance(n, bytes) else str(n) for n in (
        getattr(dm, "names_particle_features", None)
        or ["part_etarel", "part_dphi", "part_ptrel"])]
    names_cond = [str(n) for n in (getattr(dm, "names_conditioning", None) or [])]
    cond_gen = cond_gen if cond_gen is not None else np.zeros((len(gen), 0))
    with h5py.File(path, "w") as f:
        for key, arr, names in (("part_data_gen", gen, names_part),
                                ("part_data_sim", real, names_part),
                                ("cond_data_gen", cond_gen, names_cond),
                                ("cond_data_sim", cond_real, names_cond)):
            f.create_dataset(key, data=np.asarray(arr, np.float32)).attrs["names"] = names
        f.create_dataset("part_mask_gen", data=np.asarray(mask_gen, np.float32))
        f.create_dataset("part_mask_sim", data=np.asarray(mask_real, np.float32))
    with h5py.File(path.replace(".h5", "_substructure.h5"), "w") as f:
        for key in ("tau1", "tau2", "tau3", "tau21", "tau32", "d2"):
            f.create_dataset(f"{key}_gen", data=np.asarray(hl_gen[key], np.float32))
            f.create_dataset(f"{key}_sim", data=np.asarray(hl_real[key], np.float32))
    print(f"[eval_ckpt] wrote {path} (+_substructure.h5)")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--run_dir", required=True)
    ap.add_argument("--ckpt", default="best", choices=["best", "last"])
    ap.add_argument("--n_samples", type=int, default=None)
    ap.add_argument("--ode_steps", type=int, default=100)
    ap.add_argument("--ode_solver", default="midpoint", choices=SOLVERS)
    ap.add_argument("--batch_size", type=int, default=1024)
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument(
        "--guidance_scale",
        type=float,
        default=None,
        help="classifier-free guidance weight (model must be trained with "
        "cond_dropout > 0); None/1.0 = plain conditional sampling",
    )
    ap.add_argument("--write_classifier_h5", action="store_true",
                    help="also write classifier_data.h5 and classifier_data_substructure.h5 "
                    "(the classifier test's input; needs h5py)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None,
                    help="compute type to sample in (float32 or bfloat16); default: the run's "
                    "model.dtype")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    if args.write_classifier_h5:
        import_h5py()  # before the generation: raise at once where h5py is missing

    from particle_fm_tpu_torch.eval.generation import generate_data
    from particle_fm_tpu_torch.eval.metrics import (
        calculate_all_wasserstein_metrics,
        reversed_kl_divergence_batched_bootstrapping,
        wasserstein_distance_batched,
    )
    from particle_fm_tpu_torch.eval.substructure import compute_substructure
    from particle_fm_tpu_torch.utils.device import resolve_device
    from particle_fm_tpu_torch.utils.run_io import load_run

    device = resolve_device(args.device)
    cfg, dm, model, net = load_run(args.run_dir, args.ckpt, ema=True, device=device,
                                   dtype=args.dtype)
    print(f"[eval_ckpt] restored {args.ckpt} checkpoint from {args.run_dir}")

    real = dm.tensor_test
    mask = dm.mask_test
    cond = dm.tensor_conditioning_test
    if mask is None:  # fixed-size sets without a mask (jet-feature sets): every row is real
        mask = np.ones(real.shape[:2] + (1,), np.float32)
    n = args.n_samples or len(real)
    n = min(n, len(real))

    gtag = "" if args.guidance_scale is None else f"_w{args.guidance_scale}"
    if model.compute_dtype is not None:
        gtag += "_bf16"
    cache = os.path.join(args.run_dir, f"generated_{args.ckpt}_{n}{gtag}.npz")
    if os.path.exists(cache) and not args.no_cache:
        print(f"[eval_ckpt] reusing cached samples {cache}")
        z = np.load(cache)
        gen, gen_time = z["gen"], float(z["time"])
    else:
        gen, gen_time = generate_data(
            model,
            net,
            num_jet_samples=n,
            batch_size=args.batch_size,
            cond=cond[:n] if cond is not None else None,
            variable_set_sizes=dm.variable_jet_sizes,
            mask=mask[:n],
            normalized_data=dm.means is not None,
            normalize_sigma=getattr(dm, "normalize_sigma", 5),
            means=dm.means,
            stds=dm.stds,
            ode_solver=args.ode_solver,
            ode_steps=args.ode_steps,
            guidance_scale=args.guidance_scale,
            device=device,
        )
        np.savez_compressed(cache, gen=gen, time=gen_time)

    mask_gen = (np.abs(gen).sum(-1, keepdims=True) > 0).astype(np.float32)
    gen, mask_gen, cond_gen = postprocess(
        gen.copy(), mask_gen, cond[:n] if cond is not None else None,
        names_part_features=getattr(dm, "names_particle_features", None),
        min_max_train_dict=getattr(dm, "min_max_train_dict", None),
    )
    keep_real = np.sum(mask[:n, :, 0], axis=1) >= min(3, mask.shape[1])
    real_k, mask_k = real[:n][keep_real], mask[:n][keep_real]

    metrics = calculate_all_wasserstein_metrics(real_k, gen, device=device)
    metrics["generation_time"] = gen_time
    hl_r = compute_substructure(real_k, device=device)
    hl_g = compute_substructure(gen, device=device)
    n_eval = min(len(gen), len(real_k), 10_000)
    # num_batches=40: the shared bootstrap protocol (FinalEvalCallback and
    # the reference's metrics.py:11-34 defaults)
    for key in ("tau21", "tau32", "d2"):
        m_, s_ = wasserstein_distance_batched(hl_r[key], hl_g[key], n_eval, 40)
        metrics[f"w1_{key}_mean"], metrics[f"w1_{key}_std"] = m_, s_
    for f in range(min(real_k.shape[-1], 3)):
        kld, _ = reversed_kl_divergence_batched_bootstrapping(
            real_k[..., f], gen[..., f],
            mask_target=mask_k[..., 0] > 0, mask_approx=mask_gen[..., 0] > 0,
            num_eval_samples=min(n_eval, 5000), num_batches=40,
        )
        metrics[f"rkld_feature_{f}"] = kld

    if args.write_classifier_h5:
        cond_sim = cond[:n][keep_real] if cond is not None else np.zeros((len(real_k), 0))
        write_classifier_h5(os.path.join(args.run_dir, "classifier_data.h5"), dm, gen, mask_gen,
                            cond_gen, real_k, mask_k, cond_sim, hl_g, hl_r)

    out = os.path.join(args.run_dir, "eval_metrics.yaml")
    with open(out, "w") as fh:
        yaml.safe_dump({k: float(v) for k, v in metrics.items()}, fh)
    print(f"[eval_ckpt] wrote {out}")
    for k, v in metrics.items():
        print(f"  {k}: {v:.6g}")
    return metrics


if __name__ == "__main__":
    main()
