"""Sweep the classifier-free guidance weight of a trained conditional run
through the PyTorch port (the counterpart of scripts/guidance_sweep.py):

    python3 scripts/torch_guidance_sweep.py --run_dir runs/fm_cfg_tops-30/<time> \
        --ws 0 1 1.25 1.5 2 [--n 5000] [--ode_steps 100] [--device cpu]

For each guidance weight w the script samples with the test split's
conditioning (models/flow_matching.py::make_drift with guidance_scale=w; w=1
is plain conditional sampling, as there) and reports side by side the
marginal match, W1M and W1P against the held-out jets, and the conditional
fidelity, the MAE and Pearson r between each generated jet's relative mass
and its target m/pt from the conditioning vector. Every w samples from the
same noise (seed 9999). Writes guidance_sweep.yaml into the run directory,
in the JAX script's schema. Sampling and the EFPs run on the card unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEED = 9999  # the noise every w samples from, as in the JAX script


def target_relative_mass(dm, cond: np.ndarray) -> np.ndarray:
    """m/pt of each conditioning row in raw units; the columns follow
    JetNetDataModule's conditioning: [type one-hots..., pt, eta?, mass, n?]."""
    from particle_fm_tpu_torch.data.utils import inverse_normalize_tensor

    if not (getattr(dm, "conditioning_pt", False) and getattr(dm, "conditioning_mass", False)):
        raise SystemExit("guidance_sweep needs a run conditioned on jet (pt, mass)")
    pt_i = len(dm.jet_type) if getattr(dm, "conditioning_type", False) else 0
    mass_i = pt_i + 1 + (1 if getattr(dm, "conditioning_eta", False) else 0)
    cond_raw = np.asarray(cond, dtype=np.float64)
    if getattr(dm, "cond_means", None) is not None:
        cond_raw = inverse_normalize_tensor(cond_raw, np.asarray(dm.cond_means),
                                            np.asarray(dm.cond_stds),
                                            getattr(dm, "normalize_sigma", 5))
    return cond_raw[:, mass_i] / np.clip(cond_raw[:, pt_i], 1e-6, None)


def sweep_row(real, gen, target_mrel, device) -> dict:
    """W1M/W1P of `gen` against `real`, and its relative masses' MAE and
    Pearson r against the targets."""
    from particle_fm_tpu_torch.eval.metrics import (
        calculate_all_wasserstein_metrics,
        jet_masses_from_rel,
    )

    n = len(gen)
    w1 = calculate_all_wasserstein_metrics(real, gen, num_batches=40,
                                           num_eval_samples=min(n, 5000), device=device)
    gen_mrel = jet_masses_from_rel(gen)
    return {"w1m": float(w1["w1m_mean"]), "w1p": float(w1["w1p_mean"]),
            "cond_mae_mrel": float(np.abs(gen_mrel - target_mrel).mean()),
            "cond_pearson_r": float(np.corrcoef(gen_mrel, target_mrel)[0, 1])}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--run_dir", required=True)
    ap.add_argument("--ckpt", default="best", choices=["best", "last"])
    ap.add_argument("--ws", type=float, nargs="+", default=[0.0, 1.0, 1.5, 2.0])
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--ode_steps", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import yaml

    from particle_fm_tpu_torch.eval.generation import generate_data
    from particle_fm_tpu_torch.eval.metrics import jet_masses_from_rel
    from particle_fm_tpu_torch.utils.device import resolve_device
    from particle_fm_tpu_torch.utils.run_io import load_run

    device = resolve_device(args.device)
    _cfg, dm, model, net = load_run(args.run_dir, args.ckpt, ema=True, device=device)
    if model.cond_dropout <= 0:
        print("[guidance_sweep] WARNING: model trained with cond_dropout=0 — the null branch "
              "was never trained; w != 1 is extrapolation")
    real, mask, cond = dm.tensor_test, dm.mask_test, dm.tensor_conditioning_test
    n = min(args.n, len(real))
    target_mrel = target_relative_mass(dm, cond[:n])

    # the floor: the real jets' own fidelity to their conditioning
    floor_mae = float(np.abs(jet_masses_from_rel(np.asarray(real[:n])) - target_mrel).mean())
    results = {"floor_real_mae": floor_mae, "ws": {}}
    print(f"[guidance_sweep] real-jet conditioning floor: MAE(m_rel) = {floor_mae:.5f}")
    for w in args.ws:
        gen, _ = generate_data(
            model, net, num_jet_samples=n, batch_size=args.batch_size,
            cond=cond[:n] if cond is not None else None,
            variable_set_sizes=dm.variable_jet_sizes,
            mask=mask[:n] if mask is not None else None,
            normalized_data=dm.means is not None,
            normalize_sigma=getattr(dm, "normalize_sigma", 5), means=dm.means, stds=dm.stds,
            ode_steps=args.ode_steps, num_points=int(real.shape[1]),
            guidance_scale=None if w == 1.0 else w, seed=SEED, device=device,
        )
        row = sweep_row(real[:n], gen, target_mrel, device)
        results["ws"][float(w)] = row
        print(f"[guidance_sweep] w={w:<5} W1M={row['w1m']:.5f} W1P={row['w1p']:.5f} "
              f"MAE(m_rel|target)={row['cond_mae_mrel']:.5f} r={row['cond_pearson_r']:.4f}")

    out = os.path.join(args.run_dir, "guidance_sweep.yaml")
    with open(out, "w") as f:
        yaml.safe_dump(results, f)
    print(f"[guidance_sweep] wrote {out}")
    return results


if __name__ == "__main__":
    main()
