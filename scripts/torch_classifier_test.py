"""Generated-against-real classifier test of a trained run through the
PyTorch port (the counterpart of scripts/classifier_test.py):

    python3 scripts/torch_classifier_test.py --run_dir <run>
        [--arch epic|transformer|part|particlenet]
        [--n_samples 20000] [--epochs 20] [--device cpu]
    python3 scripts/torch_classifier_test.py --run_dir <run> --data_file classifier_data.h5
        [--arch epic|...|hl] [--used_flavor Tbqq]
    python3 scripts/torch_classifier_test.py --run_dir <stage2_run> --gen_h5 lhco_events.h5
        [--control]

Three modes, as in the JAX script:
- from a run (the default): sample the run's EMA network with the test
  split's conditioning and masks (eval/generation.py::generate_data; on the
  card the EPiC kernel), mix the samples with the held-out real sets
  (data/classifier.py::GenVsRealDataModule) and train a set classifier
  (models/classifiers.py::SetClassifierModel) to tell them apart;
- `--data_file`: the JetClass gen/sim classifier h5 that
  `eval_ckpt --write_classifier_h5` writes (data/jetclass_classifier.py),
  with the high-level-feature classifier under `--arch hl`;
- `--gen_h5`: the LHCO signal-region test. The generated dijet events are
  the h5 that lhco_chain.py writes with a second stage-2 run
  (`constituents_y`, `mask_y`); the real signal-region events (3.3 < mjj <
  3.7 TeV) come from the stage-2 run's datamodule; an EPiC discriminator
  pools each event's two jets (num_sup_sets=2). `--control` splits the real
  events in two instead (a healthy test reads AUC ~ 0.5).

The classifier trains with the port's Trainer (AdamW, warmup-cosine
learning rate), and ClassifierEvalCallback reports its accuracy and AUROC on
the test split every epoch; the EPiC discriminator predicts through the
folded EPiC layer (the kernel with no per-set MLP on the card). The last
epoch's values are written to `classifier_test.yaml` (the LHCO mode:
`classifier_test_sr_{sr,control}.yaml`) in the run directory, under the
JAX script's keys. `--load_weights_from` fine-tunes from a classifier
checkpoint: its weights (training/checkpoint.py::load_weights_from), the
head drawn anew (`SetClassifierModel.reinit_head`). AUC ~ 0.5 means the
classifier cannot tell the generated sets from the real ones. Everything
runs on the card unless `--device cpu` is given; the h5 modes need h5py and
raise at once without it.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import yaml

SR_WINDOW = (3300.0, 3700.0)  # the LHCO signal region in mjj (GeV)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--run_dir", required=True)
    ap.add_argument("--ckpt", default="best", choices=["best", "last"])
    ap.add_argument("--arch", default="epic",
                    choices=["epic", "transformer", "part", "particlenet", "hl"])
    ap.add_argument("--data_file", default=None,
                    help="JetClass classifier h5 (from eval_ckpt --write_classifier_h5)")
    ap.add_argument("--used_flavor", default="Tbqq")
    ap.add_argument("--load_weights_from", default=None,
                    help="classifier checkpoint to fine-tune from (the head is drawn anew)")
    ap.add_argument("--gen_h5", default=None,
                    help="LHCO signal-region mode: the xy events of lhco_chain.py; --run_dir is "
                    "the stage-2 run, whose datamodule gives the real events")
    ap.add_argument("--control", action="store_true",
                    help="with --gen_h5: real against real (AUC ~ 0.5 calibrates the test)")
    ap.add_argument("--n_samples", type=int, default=20000)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--lr", type=float, default=1e-3,
                    help="classifier learning rate (the deep ParT net prefers ~3e-4)")
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--ode_steps", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    from particle_fm_tpu_torch.data.utils import import_h5py

    if args.data_file or args.gen_h5:
        import_h5py()  # before any work: raise at once where h5py is missing
    if args.data_file:
        return _jetclass_mode(args)
    if args.gen_h5:
        return _lhco_sr_mode(args)
    return _generated_mode(args)


def _jetclass_mode(args) -> dict:
    from particle_fm_tpu_torch.data.jetclass_classifier import JetClassClassifierDataModule
    from particle_fm_tpu_torch.models.classifiers import HLClassifierModel, SetClassifierModel

    cdm = JetClassClassifierDataModule(
        data_file=args.data_file, batch_size=args.batch_size, used_flavor=args.used_flavor,
        kin_only=args.arch != "hl", use_hl_features=args.arch == "hl",
        set_energy_equal_to_p=True,
    )
    cdm.setup()
    if args.arch == "hl":
        clf = HLClassifierModel(features=cdm.train.x.shape[-1])
    else:
        clf = SetClassifierModel(arch=args.arch, n_classes=2, num_particles=cdm.train.x.shape[1],
                                 features=cdm.train.x.shape[-1])
    return _fit_and_report(args, clf, cdm)


def _generated_mode(args) -> dict:
    from particle_fm_tpu_torch.data.classifier import GenVsRealDataModule
    from particle_fm_tpu_torch.eval.generation import generate_data
    from particle_fm_tpu_torch.models.classifiers import SetClassifierModel
    from particle_fm_tpu_torch.utils.device import resolve_device
    from particle_fm_tpu_torch.utils.run_io import load_run

    device = resolve_device(args.device)
    _cfg, dm, model, net = load_run(args.run_dir, args.ckpt, device=device)
    real, mask, cond = dm.tensor_test, dm.mask_test, dm.tensor_conditioning_test
    n = min(args.n_samples, len(real))
    gen, _ = generate_data(
        model, net, num_jet_samples=n, batch_size=1024,
        cond=cond[:n] if cond is not None else None, variable_set_sizes=dm.variable_jet_sizes,
        mask=mask[:n] if mask is not None else None, normalized_data=dm.means is not None,
        normalize_sigma=getattr(dm, "normalize_sigma", 5), means=dm.means, stds=dm.stds,
        ode_steps=args.ode_steps, device=device,
    )
    gen_mask = (np.abs(gen).sum(-1, keepdims=True) > 0).astype(np.float32)
    cdm = GenVsRealDataModule(real=real[:n], real_mask=mask[:n], gen=gen, gen_mask=gen_mask,
                              batch_size=args.batch_size)
    cdm.setup()
    net_config = {}
    if args.arch == "part":
        # the generative runs store (etarel, phirel, ptrel), pt already
        # linear: the z-score statistics let ParT's pair features be computed
        # from raw kinematics
        net_config = {"pt_transform": "identity",
                      "kin_means": tuple(np.asarray(cdm.means).reshape(-1).tolist()),
                      "kin_stds": tuple(np.asarray(cdm.stds).reshape(-1).tolist())}
    clf = SetClassifierModel(arch=args.arch, n_classes=1, num_particles=real.shape[1],
                             features=real.shape[-1], net_config=net_config)
    return _fit_and_report(args, clf, cdm)


def lhco_sr_events(dm2) -> tuple[np.ndarray, np.ndarray]:
    """The real signal-region events of a stage-2 LHCO datamodule as jet rows
    (2i, 2i+1) of event i, constituents (eta, phi, pt) relative, masked:
    (x (2E, N, 3), mask (2E, N, 1)). Read from the raw per-event arrays (the
    datamodule's splits shuffle the jets and would break the pairs)."""
    from particle_fm_tpu_torch.data.utils import get_mjj

    n_p = dm2.num_particles
    jets, consts, mask = dm2._load()
    mjj = get_mjj(jets[:, 0], jets[:, 1])
    sr = (mjj > SR_WINDOW[0]) & (mjj < SR_WINDOW[1])
    consts, mask = consts[sr][:, :, :n_p, :], mask[sr][:, :, :n_p, :]
    consts = consts[..., [1, 2, 0]] * mask
    return (consts.reshape(-1, n_p, consts.shape[-1]).astype(np.float32),
            mask.reshape(-1, n_p, 1).astype(np.float32))


def _lhco_sr_mode(args) -> dict:
    from particle_fm_tpu_torch.data.classifier import GenVsRealDataModule
    from particle_fm_tpu_torch.data.utils import import_h5py
    from particle_fm_tpu_torch.models.classifiers import SetClassifierModel
    from particle_fm_tpu_torch.utils.run_io import load_run

    _cfg, dm2, _model, _net = load_run(args.run_dir, args.ckpt, device=args.device)
    n_p = dm2.num_particles
    real, real_mask = lhco_sr_events(dm2)
    if args.control:
        # real against real: the signal-region events split in halves
        n_ev = len(real) // 2 // 2
        gen, gen_mask = real[2 * n_ev:4 * n_ev], real_mask[2 * n_ev:4 * n_ev]
        real, real_mask = real[:2 * n_ev], real_mask[:2 * n_ev]
    else:
        with import_h5py().File(args.gen_h5, "r") as f:
            if "constituents_y" not in f:
                raise SystemExit("--gen_h5 needs the xy events of lhco_chain.py (a stage-2 run "
                                 "for each jet: --stage2_run_y, one run may serve both)")
            gx, gy = np.asarray(f["constituents"]), np.asarray(f["constituents_y"])
            mx, my = np.asarray(f["mask"]), np.asarray(f["mask_y"])
        gen = np.stack([gx, gy], axis=1).reshape(-1, gx.shape[1], gx.shape[2])
        gen_mask = np.stack([mx, my], axis=1).reshape(-1, mx.shape[1], 1)
        gen = (gen[:, :n_p] * gen_mask[:, :n_p]).astype(np.float32)
        gen_mask = gen_mask[:, :n_p].astype(np.float32)

    n = min(len(real), len(gen), 2 * args.n_samples)
    n -= n % 2  # whole events
    cdm = GenVsRealDataModule(real=real[:n], real_mask=real_mask[:n], gen=gen[:n],
                              gen_mask=gen_mask[:n], batch_size=args.batch_size, num_sup_sets=2)
    cdm.setup()
    clf = SetClassifierModel(arch="epic", n_classes=1, num_particles=n_p,
                             features=real.shape[-1], net_config={"num_sup_sets": 2})
    tag = "control" if args.control else "sr"
    print(f"[classifier_test] LHCO SR mode ({tag}): {n} jets ({n // 2} events) per side")
    return _fit_and_report(args, clf, cdm, out_name=f"classifier_test_sr_{tag}.yaml")


def _fit_and_report(args, clf, cdm, out_name: str = "classifier_test.yaml") -> dict:
    import torch

    from particle_fm_tpu_torch.eval.callbacks import ClassifierEvalCallback
    from particle_fm_tpu_torch.training.lr_schedules import warmup_cosine_decay_schedule
    from particle_fm_tpu_torch.training.step import create_train_state, make_optimizer
    from particle_fm_tpu_torch.training.trainer import Trainer

    # warmup-cosine: the deep ParT net stalls at chance under a cold constant
    # rate; the shallow nets do not mind the schedule
    steps_per_epoch = max(1, len(cdm.train.x) // args.batch_size)
    total_steps = max(args.epochs * steps_per_epoch, 2)
    lr = warmup_cosine_decay_schedule(0.0, args.lr,
                                      warmup_steps=max(1, min(total_steps // 10, 500)),
                                      decay_steps=total_steps)
    trainer = Trainer(model=clf, datamodule=cdm, optimizer=make_optimizer(lr=lr),
                      max_epochs=args.epochs, callbacks=[ClassifierEvalCallback(every_n_epochs=1)],
                      verbose=True, device=args.device)
    state = None
    if args.load_weights_from and hasattr(clf, "reinit_head"):
        # fine-tuning: the checkpoint's weights, the head drawn anew
        from particle_fm_tpu_torch.training.checkpoint import load_weights_from

        state = create_train_state(clf, trainer.optimizer, seed=0, device=trainer.device)
        load_weights_from(args.load_weights_from, state)
        clf.reinit_head(state.net, seed=1)
        with torch.no_grad():
            for e, p in zip(state.ema_params, state.net.parameters(), strict=True):
                e.copy_(p)
    trainer.fit(initial_state=state)
    final = trainer.metrics_history[-1]
    out = {"classifier_auc": float(final["auroc"]),
           "classifier_accuracy": float(final["accuracy"])}
    path = os.path.join(args.run_dir, out_name)
    with open(path, "w") as f:
        yaml.safe_dump(out, f)
    print(f"[classifier_test] AUC={out['classifier_auc']:.4f} (0.5 = indistinguishable) -> {path}")
    return out


if __name__ == "__main__":
    main()
