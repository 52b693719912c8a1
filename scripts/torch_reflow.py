"""ReFlow distillation of a trained run for few-step sampling, through the
PyTorch port (the counterpart of scripts/reflow.py):

    python3 scripts/torch_reflow.py --run_dir <teacher_run> [--n_pairs 100000]
        [--epochs 400] [--eval_nfes 1,2,4,8,100] [--device cpu]

The teacher (EMA weights) integrates its ODE from fresh prior noise, on the
EPiC kernel on the card, keeping both ends of each trajectory
(training/reflow.py::generate_pairs); the same architecture is trained on
that coupling (loss_type reflow, from the teacher's weights unless
--fresh_init) with the Trainer; teacher and student are evaluated at an NFE
ladder against the real test split (W1M, W1P). The student directory is a
run (config.yaml, checkpoints/) that the port's evaluate.py and eval_ckpt.py
read; the metrics go to <out_dir>/reflow_metrics.yaml.
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
    ap.add_argument("--n_pairs", type=int, default=100_000)
    ap.add_argument("--teacher_steps", type=int, default=100)
    ap.add_argument("--teacher_solver", default="midpoint")
    ap.add_argument("--epochs", type=int, default=400)
    ap.add_argument("--batch_size", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--warmup", type=int, default=20, help="warmup epochs")
    ap.add_argument("--ema_decay", type=float, default=0.999)
    ap.add_argument("--eval_nfes", default="1,2,4,8,100")
    ap.add_argument("--eval_solver", default="euler",
                    help="student solver for the NFE ladder (euler: NFE = steps-1)")
    ap.add_argument("--n_eval", type=int, default=5000)
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--pairs_cache", default=None, help="reuse/write the pairs npz at this path")
    ap.add_argument("--fresh_init", action="store_true",
                    help="train the student from scratch instead of from the teacher")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from particle_fm_tpu_torch.data.pairs import ReflowPairsDataModule
    from particle_fm_tpu_torch.eval.generation import generate_data
    from particle_fm_tpu_torch.eval.metrics import calculate_all_wasserstein_metrics
    from particle_fm_tpu_torch.training.lr_schedules import build_lr
    from particle_fm_tpu_torch.training.reflow import generate_pairs, straightness, student_model
    from particle_fm_tpu_torch.training.step import create_train_state, make_optimizer
    from particle_fm_tpu_torch.training.trainer import Trainer
    from particle_fm_tpu_torch.utils.run_io import load_run

    cfg, dm, teacher, tnet = load_run(args.run_dir, args.ckpt, ema=True, device=args.device)
    out_dir = args.out_dir or os.path.join(args.run_dir,
                                           f"reflow_{time.strftime('%Y-%m-%d_%H-%M-%S')}")
    os.makedirs(out_dir, exist_ok=True)
    print(f"[reflow] teacher restored from {args.run_dir} -> {out_dir}")

    pairs_path = args.pairs_cache or os.path.join(out_dir, "pairs.npz")
    if os.path.exists(pairs_path):
        print(f"[reflow] reusing cached pairs {pairs_path}")
    else:
        t0 = time.time()
        x1, x0, mask, cond = generate_pairs(
            teacher, tnet, args.n_pairs, mask=dm.train.mask if dm.variable_jet_sizes else None,
            cond=dm.train.cond, batch_size=args.batch_size, ode_solver=args.teacher_solver,
            ode_steps=args.teacher_steps, verbose=True)
        extras = {k: getattr(dm, k) for k in ("means", "stds", "cond_means", "cond_stds")
                  if getattr(dm, k, None) is not None}
        np.savez(pairs_path, x1=x1, x0=x0, **({"mask": mask} if mask is not None else {}),
                 **({"cond": cond} if cond is not None else {}), **extras)
        print(f"[reflow] {len(x1)} pairs in {time.time() - t0:.1f}s -> {pairs_path}")

    pdm = ReflowPairsDataModule(pairs_path=pairs_path, batch_size=args.batch_size)
    pdm.setup()
    student = student_model(teacher)
    lr = build_lr({"lr": args.lr}, {"name": "cosine_warmup", "warmup": args.warmup,
                                    "max_iters": args.epochs}, pdm.steps_per_epoch)
    optimizer = make_optimizer(lr=lr, grad_clip=(cfg.get("trainer") or {}).get("grad_clip", 0.5))
    state = create_train_state(student, optimizer, device=args.device)
    if not args.fresh_init:
        state.net.load_state_dict(tnet.state_dict())
        with torch.no_grad():
            for e, p in zip(state.ema_params, state.net.parameters()):
                e.copy_(p)
        print("[reflow] student initialized from teacher weights")

    # the student directory is a run of its own; its data stays the teacher's
    # datamodule, so that offline evaluation compares with the real test split
    student_cfg = dict(cfg, model=dict(cfg["model"], loss_type="reflow"),
                       task_name=f"reflow_{cfg.get('task_name', 'student')}")
    with open(os.path.join(out_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(student_cfg, f, sort_keys=False)

    feats = pdm.val.x.shape[-1] // 2
    val = (pdm.tensor_val, pdm.val.x[..., feats:], pdm.mask_val, pdm.tensor_conditioning_val)
    s0 = straightness(teacher, tnet, *val)
    trainer = Trainer(model=student, datamodule=pdm, optimizer=optimizer,
                      max_epochs=args.epochs, ema_decay=args.ema_decay,
                      ckpt_dir=os.path.join(out_dir, "checkpoints"), log_dir=out_dir,
                      check_val_every_n_epoch=10, device=args.device)
    state = trainer.fit(initial_state=state)
    snet = state.ema_network()
    s1 = straightness(student, snet, *val)
    print(f"[reflow] straightness S(Z): teacher {s0:.4f} -> student {s1:.4f}")

    real, maskr, condr = dm.tensor_test, dm.mask_test, dm.tensor_conditioning_test
    n = min(args.n_eval, len(real))
    results = {"straightness_teacher": float(s0), "straightness_student": float(s1)}

    def ladder(tag, model, net):
        for nfe in (int(s) for s in args.eval_nfes.split(",") if s):
            solver = args.eval_solver if nfe < args.teacher_steps else args.teacher_solver
            # euler/ab2/ab3: NFE = steps - 1; midpoint: NFE = 2 (steps - 1)
            steps = nfe + 1 if solver in ("euler", "ab2", "ab3") else nfe // 2 + 1
            gen, gtime = generate_data(
                model, net, n, batch_size=args.batch_size,
                cond=condr[:n] if condr is not None else None,
                variable_set_sizes=dm.variable_jet_sizes,
                mask=maskr[:n] if maskr is not None else None,
                normalized_data=dm.means is not None, means=dm.means, stds=dm.stds,
                ode_solver=solver, ode_steps=steps, seed=7, device=args.device)
            w1 = calculate_all_wasserstein_metrics(real[:n, :, :3], gen[..., :3],
                                                   num_eval_samples=min(10_000, n),
                                                   device=args.device)
            row = {"solver": solver, "steps": steps, "w1m": float(w1["w1m_mean"]),
                   "w1m_std": float(w1["w1m_std"]), "w1p": float(w1["w1p_mean"]),
                   "gen_time_s": float(gtime)}
            results[f"{tag}_nfe{nfe}"] = row
            print(f"[reflow] {tag} NFE={nfe:<4d} W1M={row['w1m']:.4f}±{row['w1m_std']:.4f} "
                  f"W1P={row['w1p']:.4f} ({solver}, {gtime:.2f}s)")

    ladder("teacher", teacher, tnet)
    ladder("student", student, snet)
    with open(os.path.join(out_dir, "reflow_metrics.yaml"), "w") as f:
        yaml.safe_dump(results, f, sort_keys=False)
    print(f"[reflow] wrote {out_dir}/reflow_metrics.yaml")
    return results


if __name__ == "__main__":
    main()
