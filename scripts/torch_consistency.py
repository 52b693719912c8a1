"""Consistency distillation of a trained run for 1-2 step sampling, through
the PyTorch port (the counterpart of scripts/consistency.py):

    python3 scripts/torch_consistency.py --run_dir <teacher_run> [--steps 4000]
        [--mode direct|cd] [--eval_steps 1,2,4] [--device cpu]

The teacher (EMA weights) is distilled on its own training split
(training/consistency.py: `distill_direct` by default, regressing onto the
teacher's whole solves; `cd`, consistency distillation with an EMA target,
is unstable at small budgets on this workload and kept for experiments);
the student's k-step sampler and the teacher's ODE ladder are evaluated
against the real test split (W1M, W1P). The teacher's solves and the
sampling run on the EPiC kernel on the card. Writes
<out_dir>/consistency_metrics.yaml, the loss history and the student's
weights (student.pt, a state_dict of the teacher's network).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import yaml


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--run_dir", required=True, help="teacher run directory")
    ap.add_argument("--ckpt", default="best", choices=["best", "last"])
    ap.add_argument("--mode", default="direct", choices=["cd", "direct"],
                    help="direct (default): regress onto the teacher's whole ODE solves; "
                         "cd: EMA-target consistency distillation (unstable at small budgets)")
    ap.add_argument("--solver_steps", type=int, default=8,
                    help="teacher midpoint steps per target (direct mode)")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--n_grid", type=int, default=16)
    ap.add_argument("--curriculum", action="store_true",
                    help="two-stage grid: n_grid/2 for the first 40%% of steps, then n_grid")
    ap.add_argument("--target_ema", type=float, default=0.95)
    ap.add_argument("--huber_c", type=float, default=0.15)
    ap.add_argument("--eval_steps", default="1,2,4", help="consistency sampler NFE ladder")
    ap.add_argument("--teacher_nfes", default="100",
                    help="teacher ODE NFE baseline ladder ('' to skip)")
    ap.add_argument("--n_eval", type=int, default=5000)
    ap.add_argument("--eval_batch", type=int, default=2500)
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from particle_fm_tpu_torch.data.utils import inverse_normalize_tensor
    from particle_fm_tpu_torch.eval.generation import generate_data
    from particle_fm_tpu_torch.eval.metrics import calculate_all_wasserstein_metrics
    from particle_fm_tpu_torch.training.consistency import (consistency_sample,
                                                            distill_consistency, distill_direct)
    from particle_fm_tpu_torch.utils.run_io import load_run

    cfg, dm, teacher, tnet = load_run(args.run_dir, args.ckpt, ema=True, device=args.device)
    if getattr(dm, "log_pt", False) or getattr(dm, "pt_standardization", False):
        raise NotImplementedError("torch_consistency.py undoes plain sigma-normalisation only; "
                                  "log_pt/pt_standardization datamodules are not supported")
    out_dir = args.out_dir or os.path.join(
        args.run_dir, f"consistency_{time.strftime('%Y-%m-%d_%H-%M-%S')}")
    os.makedirs(out_dir, exist_ok=True)
    print(f"[consistency] teacher restored from {args.run_dir} -> {out_dir}")

    t0 = time.time()
    common = dict(mask=dm.mask_train if dm.variable_jet_sizes else None,
                  cond=dm.tensor_conditioning_train, batch_size=args.batch_size, lr=args.lr,
                  huber_c=args.huber_c, seed=args.seed, verbose=True)
    if args.mode == "direct":
        print(f"[consistency] mode=direct solver_steps={args.solver_steps} steps={args.steps}")
        res = distill_direct(teacher, tnet, dm.tensor_train, steps=args.steps,
                             warmup=min(args.warmup, args.steps // 2),
                             solver_steps=args.solver_steps, **common)
    else:
        print("[consistency] WARNING: mode=cd (EMA-target consistency distillation) degrades "
              "with more steps at small budgets on this workload; --mode direct is the "
              "default", file=sys.stderr)
        cut = int(args.steps * 0.4)
        stages = ([(args.n_grid // 2, cut), (args.n_grid, args.steps - cut)] if args.curriculum
                  else [(args.n_grid, args.steps)])
        res, init = None, None
        for n_grid, steps in stages:
            print(f"[consistency] stage: n_grid={n_grid} steps={steps}")
            res = distill_consistency(teacher, tnet, dm.tensor_train, steps=steps,
                                      warmup=min(args.warmup, steps // 2), n_grid=n_grid,
                                      target_ema=args.target_ema, init_net=init, **common)
            init = res.net
    print(f"[consistency] distilled {args.steps} steps in {time.time() - t0:.1f}s "
          f"(final loss {res.losses[-1]:.5f})")
    np.savez(os.path.join(out_dir, "student.npz"), loss_history=res.losses)
    torch.save(res.net.state_dict(), os.path.join(out_dir, "student.pt"))

    real, maskr, condr = dm.tensor_test, dm.mask_test, dm.tensor_conditioning_test
    n = min(args.n_eval, len(real))
    results = {"distill_steps": args.steps, "final_loss": float(res.losses[-1])}

    def undo(gen):
        if dm.means is not None:
            gen = inverse_normalize_tensor(gen, dm.means, dm.stds,
                                           sigma=getattr(dm, "normalize_sigma", 5))
        if maskr is not None:
            gen = gen * maskr[:n]
        return gen

    def as_t(a):
        return None if a is None else torch.as_tensor(a, dtype=torch.float32, device=args.device)

    def w1_row(gen, gtime):
        w1 = calculate_all_wasserstein_metrics(real[:n, :, :3], gen[..., :3],
                                               num_eval_samples=min(10_000, n),
                                               device=args.device)
        return {"w1m": float(w1["w1m_mean"]), "w1m_std": float(w1["w1m_std"]),
                "w1p": float(w1["w1p_mean"]), "gen_time_s": float(gtime)}

    def student_ladder(tag, net, ks):
        for k in ks:
            t0 = time.time()
            outs = []
            for s in range(0, n, args.eval_batch):
                e = min(s + args.eval_batch, n)
                g = consistency_sample(
                    teacher, net, torch.Generator(args.device).manual_seed(7 + s),
                    n_samples=e - s, cond=as_t(condr[s:e] if condr is not None else None),
                    mask=as_t(maskr[s:e] if maskr is not None else None), steps=k)
                outs.append(g.cpu().numpy())
            row = w1_row(undo(np.concatenate(outs)), time.time() - t0)
            results[f"{tag}_nfe{k}"] = row
            print(f"[consistency] {tag} NFE={k:<3d} W1M={row['w1m']:.4f}±{row['w1m_std']:.4f} "
                  f"W1P={row['w1p']:.4f} ({row['gen_time_s']:.2f}s)")

    ks = [int(s) for s in args.eval_steps.split(",") if s]
    # the undistilled map g(z, 1) is the teacher's one Euler jump: what the
    # distillation bought is the difference to this row
    student_ladder("init_euler", tnet, ks[:1])
    student_ladder("student", res.net, ks)
    if res.target_net is not res.net:
        student_ladder("student_ema", res.target_net, ks)
    for nfe in (int(s) for s in args.teacher_nfes.split(",") if s):
        gen, gtime = generate_data(
            teacher, tnet, n, batch_size=args.eval_batch,
            cond=condr[:n] if condr is not None else None,
            variable_set_sizes=dm.variable_jet_sizes,
            mask=maskr[:n] if maskr is not None else None, normalized_data=dm.means is not None,
            means=dm.means, stds=dm.stds, ode_solver="midpoint", ode_steps=nfe // 2 + 1, seed=7,
            device=args.device)
        row = w1_row(gen, gtime)
        results[f"teacher_nfe{nfe}"] = row
        print(f"[consistency] teacher NFE={nfe:<4d} W1M={row['w1m']:.4f}"
              f"±{row['w1m_std']:.4f} W1P={row['w1p']:.4f} ({gtime:.2f}s)")

    with open(os.path.join(out_dir, "consistency_metrics.yaml"), "w") as f:
        yaml.safe_dump(results, f, sort_keys=False)
    print(f"[consistency] wrote {out_dir}/consistency_metrics.yaml")
    return results


if __name__ == "__main__":
    main()
