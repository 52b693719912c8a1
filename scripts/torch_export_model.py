"""Export a trained run's sampler as a served artifact through the PyTorch
port (the counterpart of scripts/export_model.py):

    python3 scripts/torch_export_model.py --run_dir <run> [--ckpt best|last]
        [--batch_size 1024] [--ode_solver midpoint] [--ode_steps 100]
        [--dtype bfloat16] [--guidance_scale W] [--out <dir>] [--verify]
        [--device cpu]

The artifact directory (sampler.pt2 + meta.yaml, particle_fm_tpu_torch/
serving.py) loads with `serving.load_exported` and runs without model code:
the folded weights are the program's, the kernels its custom ops, the
inverse normalisation baked in; the outputs are physical-space particle
clouds. It runs on the device it was exported for (the card unless
`--device cpu`). `--verify` reloads the artifact, holds one batch against
the live model bit for bit on the same device, and reports sets/s through
the artifact.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--run_dir", required=True)
    ap.add_argument("--ckpt", default="best", choices=["best", "last"])
    ap.add_argument("--no-ema", action="store_true")
    ap.add_argument("--batch_size", type=int, default=1024)
    ap.add_argument("--ode_solver", default=None, help="default: the run's eval solver or midpoint")
    ap.add_argument("--ode_steps", type=int, default=None)
    ap.add_argument("--dtype", default=None, help="compute type to serve in (e.g. bfloat16)")
    ap.add_argument("--guidance_scale", type=float, default=None,
                    help="classifier-free guidance baked into the program (conditional "
                         "models trained with model.cond_dropout > 0)")
    ap.add_argument("--out", default=None, help="default: <run_dir>/exported")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--verify", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from particle_fm_tpu_torch import serving
    from particle_fm_tpu_torch.utils.run_io import load_run

    cfg, dm, model, net = load_run(args.run_dir, args.ckpt, ema=not args.no_ema,
                                   device=args.device, dtype=args.dtype)
    cb = (cfg.get("callbacks") or {}).get("jetnet_eval") or {}
    solver = args.ode_solver or cb.get("ode_solver", "midpoint")
    steps = args.ode_steps or int(cb.get("ode_steps", 100))
    mask = getattr(dm, "mask_test", None)
    cond = getattr(dm, "tensor_conditioning_test", None)
    use_mask = mask is not None
    num_points = int(mask.shape[1]) if use_mask else int(model.num_particles)
    cond_dim = int(cond.shape[-1]) if cond is not None and cond.ndim == 2 else None
    proto = dict(means=dm.means, stds=dm.stds, normalize_sigma=getattr(dm, "normalize_sigma", 5),
                 guidance_scale=args.guidance_scale)

    t0 = time.perf_counter()
    exported, meta = serving.export_sampler(
        model, net, batch_size=args.batch_size, num_points=num_points,
        features=int(model.features), cond_dim=cond_dim, use_mask=use_mask, ode_solver=solver,
        ode_steps=steps, **proto)
    export_s = time.perf_counter() - t0
    meta["provenance"] = {"run_dir": os.path.abspath(args.run_dir), "ckpt": args.ckpt,
                          "ema": not args.no_ema, "task_name": cfg.get("task_name")}
    out = args.out or os.path.join(args.run_dir, "exported")
    serving.save_exported(out, exported, meta)
    size = os.path.getsize(os.path.join(out, serving.ARTIFACT_NAME))
    print(f"[export_model] wrote {out} ({size / 1e6:.2f} MB in {export_s:.1f} s, "
          f"platforms={meta['platforms']}, solver={solver} steps={steps})")
    report = {"out": out, "export_s": export_s, "bytes": size}
    if not args.verify:
        return report

    fn, _ = serving.load_exported(out)
    n = args.batch_size
    rs = np.random.RandomState(0)
    call = []
    if cond_dim:
        call.append(np.asarray(cond)[rs.randint(0, len(cond), size=n)].astype(np.float32))
    if use_mask:
        call.append(np.asarray(mask)[rs.randint(0, len(mask), size=n)].astype(np.float32))
    live = serving.make_serve_fn(model, net, batch_size=n, ode_solver=solver, ode_steps=steps,
                                 num_points=num_points, has_cond=bool(cond_dim),
                                 has_mask=use_mask, **proto)
    got, want = fn(7, *call), live(7, *call)
    if not torch.equal(got, want):
        raise SystemExit(f"[export_model] verify: the artifact differs from the live model "
                         f"(max |diff| {float((got - want).abs().max()):.3e})")
    print("[export_model] verify: the artifact equals the live model bit for bit")
    reps = 3
    sync = torch.cuda.synchronize if got.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(100 + i, *call)
    sync()
    dt = time.perf_counter() - t0
    print(f"[export_model] serving: {reps * n / dt:,.0f} sets/s "
          f"({1e3 * dt / reps:.1f} ms a batch of {n})")
    return {**report, "sets_per_s": reps * n / dt}


if __name__ == "__main__":
    main()
