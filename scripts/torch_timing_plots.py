"""Generation-timing study through the PyTorch port (the counterpart of
scripts/timing_plots.py): seconds per jet against particles per jet.

    python3 scripts/torch_timing_plots.py [--sizes 10 30 60 100 150] [--jets 1000]
        [--out plots/timing.png] [--run_dir <run> [--ckpt best|last]] [--device cpu]

One EPiC flow-matching model is built per jet size, its weights drawn from
`--seed` (or, with `--run_dir`, the run's EMA network serves every size: the
EPiC weights do not depend on the set size; a conditioned run raises), and
`measure` times its generation (midpoint, `--ode_steps` steps, 100 by
default as in the JAX script) through
eval/generation.py::measure_generation_timing, excluding the first batch.
Generation runs on the card (the EPiC kernel) unless `--device cpu` is given.
`main` then plots the curve with eval/plotting.py::plot_generation_timing,
which needs matplotlib; `measure` alone needs none.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_entries(sizes, hidden_dim: int = 128, layers: int = 6, seed: int = 0,
                  run_dir: str | None = None, ckpt: str = "best", device="cuda") -> list:
    """[(n_particles, model, network), ...]: one seeded EPiC model per size
    (the JAX script's configuration), or the run's network at each size."""
    from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel
    from particle_fm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if run_dir:
        from particle_fm_tpu_torch.utils.run_io import load_run

        _cfg, _dm, model, net = load_run(run_dir, ckpt, ema=True, device=dev)
        if model.model != "epic" or model.global_cond_dim or model.local_cond_dim:
            raise ValueError("the timing study samples an unconditioned EPiC run "
                             f"(got model={model.model!r}, cond dims "
                             f"{model.global_cond_dim}, {model.local_cond_dim})")
        return [(n, dataclasses.replace(model, num_particles=n), net) for n in sizes]
    entries = []
    for n in sizes:
        model = FlowMatchingModel(model="epic", features=3, num_particles=n,
                                  hidden_dim=hidden_dim, latent=10, layers=layers,
                                  frequencies=16, t_emb="cosine", loss_type="FM-OT")
        entries.append((n, model, model.init(seed=seed, device=dev)))
    return entries


def measure(sizes, jets: int = 1000, batch_size: int = 256, ode_steps: int = 100,
            hidden_dim: int = 128, layers: int = 6, seed: int = 0, run_dir: str | None = None,
            ckpt: str = "best", device="cuda") -> tuple[list, list]:
    """(sizes, seconds per jet) of the study."""
    from particle_fm_tpu_torch.eval.generation import measure_generation_timing

    entries = build_entries(sizes, hidden_dim, layers, seed, run_dir, ckpt, device)
    return measure_generation_timing(entries, jets_to_generate=jets, batch_size=batch_size,
                                     ode_steps=ode_steps)


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[10, 30, 60, 100, 150])
    ap.add_argument("--jets", type=int, default=1000)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--ode_steps", type=int, default=100)
    ap.add_argument("--hidden_dim", type=int, default=128)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--run_dir", default=None)
    ap.add_argument("--ckpt", default="best", choices=["best", "last"])
    ap.add_argument("--out", default="plots/timing.png")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from particle_fm_tpu_torch.eval.plotting import plot_generation_timing

    sizes, times = measure(args.sizes, args.jets, args.batch_size, args.ode_steps,
                           args.hidden_dim, args.layers, args.seed, args.run_dir, args.ckpt,
                           args.device)
    label = "EPiC-FM (cuda)" if "cuda" in str(args.device) else f"EPiC-FM ({args.device})"
    path = plot_generation_timing([(label, sizes, times)], save_path=args.out)
    print(f"[timing_plots] wrote {path}")
    for n, t in zip(sizes, times):
        print(f"  N={n}: {t * 1e3:.3f} ms/jet ({1.0 / t:.0f} jets/s)")
    return sizes, times


if __name__ == "__main__":
    main()
