"""Evaluation callbacks: mid-training generation and physics metrics;
counterpart of particle_fm_tpu/eval/callbacks.py's `JetNetEvalCallback`
(JetNet, JetClass and LHCO jets, with the `*_sr` splits of LHCO),
`FinalEvalCallback`, `WholeEventEvalCallback` (LHCO whole events, clustered
into their two leading jets) and `CaloEvalCallback` (CaloChallenge
showers), with the same fields, defaults and metric names.

Skeleton: on a logging schedule -> fixed seed -> EMA weights ->
generate_data (batched, timed excluding warm-up) -> inverse-normalize -> W1
metrics -> returned to the trainer, which logs them and feeds them to the
metric-keyed checkpoints. Generation, the EFPs and the energy correlators
run on the trainer's device.

A callback works on a copy of the network (`trainer.state.ema_network()`
with `use_ema`, else a copy of the live one) with its own generators, so it
leaves the training run as it found it: the live network unfolded, its
parameters and the optimizer untouched.

`ClassifierEvalCallback` serves the gen-vs-real classifiers
(models/classifiers.py): accuracy and AUROC of the test split's
probabilities, computed on the host without sklearn; an EPiC
discriminator's copy is folded once, so its predictions run the fused EPiC
kernel on the card.

`FlatEvalCallback` and `GenChallengeEvalCallback` evaluate the flat models
(models/flow_matching_flat.py: LHCO stage 1, GenChallenge): the W1 of each
feature and their mean between generated and held-out vectors, under
`metric_prefix` (`sr_` for a signal-region twin), and the generation time;
batch i draws its noise from a generator seeded `serving.chunk_seed(seed,
i)`, as `generate_data` seeds a batch.

With `make_plots` the callbacks draw the JAX callbacks' figures through
eval/plotting.py, which is imported only then: where matplotlib is missing,
plotting raises an ImportError that names it, and a run never skips its
plots without saying so. Not ported: `DeviceStatsCallback`; a config that
names it raises through config/core.py.
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import yaml

from particle_fm_tpu_torch.data.utils import get_mjj
from particle_fm_tpu_torch.eval.generation import generate_data
from particle_fm_tpu_torch.eval.metrics import (
    calculate_all_wasserstein_metrics,
    calculate_wasserstein_metrics_jets,
    wasserstein_distance_batched,
)
from particle_fm_tpu_torch.training.logging_scheduler import should_log


def _tile_to(a, n: int):
    """Tile conditioning/masks along the batch axis to cover n samples
    (oversampled generation, reference jetnet_final_eval.py semantics)."""
    if a is None:
        return None
    if len(a) >= n:
        return a[:n]
    reps = -(-n // len(a))
    return np.concatenate([a] * reps, axis=0)[:n]


def _hist_cdf_w1(real_vals, gen_vals, edges, weights_real=None, weights_gen=None):
    """The CaloChallenge W1 estimator: fill fixed-bin histograms, then the
    mean |CDF_gen - CDF_real| with both CDFs normalised to 1."""
    hr, _ = np.histogram(real_vals, bins=edges, weights=weights_real)
    hg, _ = np.histogram(gen_vals, bins=edges, weights=weights_gen)
    cr = hr.cumsum().astype(float)
    cg = hg.cumsum().astype(float)
    if cr[-1] == 0 or cg[-1] == 0:
        return float("nan")
    return float(np.mean(np.abs(cg / cg[-1] - cr / cr[-1])))


def eval_network(trainer, use_ema: bool):
    """A copy of the network to sample with: the EMA weights, or the live ones."""
    return trainer.state.ema_network() if use_ema else copy.deepcopy(trainer.state.net)


@dataclass
class JetNetEvalCallback:
    """In-training eval: W1M/W1P(/W1EFP) on generated vs held-out jets."""

    every_n_epochs: int | str = 10
    num_jet_samples: int = 10000
    generation_batch_size: int = 1024
    w1_kwargs: dict = field(default_factory=lambda: dict(num_batches=40, num_eval_samples=10000))
    calculate_efps: bool = False
    use_ema: bool = True
    ode_solver: str = "midpoint"
    ode_steps: int = 100
    split: str = "test"
    on_test: bool = False  # also run inside trainer.test()
    seed: int = 9999  # fixed eval seed, parity with the reference
    log_epoch_zero: bool = False  # parity: jetnet_eval.yaml log_epoch_zero
    per_type_w1: bool = False  # per-jet-type W1 breakdown (JetClass eval)
    # generate with the datamodule's generated-conditioning twins
    # (mask_gen / tensor_conditioning_gen) when present, else the split's own
    use_gen_conditioning: bool = True
    # external conditioning h5 with pt/mass/num_particles datasets
    # (reference jetnet_final_eval.py:149-175 cond_path): overrides both
    cond_path: Optional[str] = None
    # classifier-free guidance weight (requires a model trained with
    # cond_dropout > 0). None/1.0 = plain conditional sampling.
    guidance_scale: Optional[float] = None

    def _arrays(self, dm):
        real = getattr(dm, f"tensor_{self.split}")
        mask = getattr(dm, f"mask_{self.split}")
        cond = getattr(dm, f"tensor_conditioning_{self.split}")
        return real, mask, cond

    def _gen_conditioning(self, dm, cond, mask, n):
        """(cond, mask) to GENERATE with, tiled to n samples. Priority:
        cond_path h5 > datamodule gen-twins > the eval split's own arrays."""
        if self.cond_path is not None:
            import h5py

            from particle_fm_tpu_torch.data.utils import normalize_tensor

            with h5py.File(self.cond_path, "r") as f:
                pt_c = np.asarray(f["pt"])
                mass_c = np.asarray(f["mass"])
                num_particles_c = np.asarray(f["num_particles"]).squeeze()
            jet_size = int(mask.shape[1]) if mask is not None else int(
                getattr(dm, "num_particles", num_particles_c.max())
            )
            npart = np.clip(num_particles_c.astype(int), 1, jet_size)
            mask_c = np.tri(jet_size)[npart - 1][..., None].astype(np.float32)
            # the h5 supplies (pt, mass[, num_particles]) columns only, as in
            # the reference (jetnet_final_eval.py:168)
            if getattr(dm, "conditioning_type", False) or getattr(
                dm, "conditioning_eta", False
            ):
                raise ValueError(
                    "cond_path supplies only pt/mass/num_particles conditioning; "
                    "this run conditions on jet type and/or eta, which the h5 "
                    "cannot provide (reference jetnet_final_eval.py:168 TODO)"
                )
            cols = [pt_c.reshape(len(pt_c), -1), mass_c.reshape(len(mass_c), -1)]
            if getattr(dm, "conditioning_num_particles", False):
                cols.append(
                    num_particles_c.reshape(len(num_particles_c), -1).astype(np.float32)
                )
            cond_means = getattr(dm, "cond_means", None)
            if cond is not None and cond_means is not None:
                # the sigma-scaled z-score the datamodule applied to its own
                # conditioning
                cond_stds = np.asarray(dm.cond_stds)
                cond_means = np.asarray(cond_means)
                sigma = getattr(dm, "normalize_sigma", 5)
                cols = [
                    normalize_tensor(c, cond_means[i], cond_stds[i], sigma)
                    for i, c in enumerate(cols)
                ]
            cond_c = np.concatenate(cols, axis=-1).astype(np.float32)
            if cond is not None and cond_c.shape[1] != cond.shape[1]:
                raise ValueError(
                    f"cond_path built {cond_c.shape[1]} conditioning columns but "
                    f"the run's model consumes {cond.shape[1]}"
                )
            return _tile_to(cond_c, n), _tile_to(mask_c, n)
        mask_gen = getattr(dm, "mask_gen", None)
        if self.use_gen_conditioning and mask_gen is not None:
            return (
                _tile_to(getattr(dm, "tensor_conditioning_gen", None), n),
                _tile_to(mask_gen, n),
            )
        return _tile_to(cond, n), _tile_to(mask, n)

    def _should_run(self, trainer) -> bool:
        if getattr(trainer, "testing", False):
            return True
        if trainer.epoch == 0 and not self.log_epoch_zero:
            return False
        return should_log(self.every_n_epochs, trainer.epoch)

    def _generate(self, trainer, n: int):
        """Generate n sets against the eval split; returns (real, gen, gen_time)."""
        dm = trainer.datamodule
        real, mask, cond = self._arrays(dm)
        cond_n, mask_n = self._gen_conditioning(dm, cond, mask, n)
        gen, gen_time = generate_data(
            trainer.model,
            eval_network(trainer, self.use_ema),
            num_jet_samples=n,
            batch_size=self.generation_batch_size,
            cond=cond_n,
            variable_set_sizes=dm.variable_jet_sizes,
            mask=mask_n,
            normalized_data=dm.means is not None,
            normalize_sigma=getattr(dm, "normalize_sigma", 5),
            means=dm.means,
            stds=dm.stds,
            log_pt=getattr(dm, "log_pt", False),
            pt_standardization=getattr(dm, "pt_standardization", False),
            ode_solver=self.ode_solver,
            ode_steps=self.ode_steps,
            seed=self.seed,
            # fixed-size datasets (no mask): generate the DATA's set size, not
            # the model default (guards a model/data num_particles mismatch)
            num_points=int(real.shape[1]),
            guidance_scale=self.guidance_scale,
            device=trainer.device,
        )
        return real, gen, gen_time

    def _generate_vs_real(self, trainer):
        """Shared generation block: returns (real, gen, n, gen_time)."""
        real = self._arrays(trainer.datamodule)[0]
        # reference semantics: negative num_jet_samples = |n| x the dataset
        # size, with conditioning/masks tiled to cover the oversample
        if self.num_jet_samples < 0:
            n = abs(self.num_jet_samples) * len(real)
        else:
            n = self.num_jet_samples
        real, gen, gen_time = self._generate(trainer, n)
        return real, gen, n, gen_time

    def __call__(self, trainer) -> Optional[dict]:
        if not self._should_run(trainer):
            return None
        real, gen, n, gen_time = self._generate_vs_real(trainer)
        w1 = calculate_all_wasserstein_metrics(
            real[:n],
            gen,
            calculate_efps=self.calculate_efps,
            device=trainer.device,
            **self.w1_kwargs,
        )
        w1["generation_time"] = gen_time
        if self.per_type_w1:
            w1.update(self._per_type_w1(trainer.datamodule, real, gen, n))
        return w1

    def _per_type_w1(self, dm, real, gen, n) -> dict:
        """Per-jet-type W1M (reference jetclass_eval.py:214-420 per-type
        breakdown) for datamodules exposing one-hot `labels_<split>` +
        `used_jet_types` (JetClass)."""
        labels = getattr(dm, f"labels_{self.split}", None)
        names = getattr(dm, "used_jet_types", None)
        if labels is None:
            return {}
        # oversampled generation: break down over the label-paired prefix
        m = min(n, len(labels), len(real))
        if m < 16:
            return {}
        idx = np.argmax(labels[:m], axis=1)
        names = names or [str(i) for i in range(labels.shape[1])]
        out = {}
        for t, name in enumerate(names):
            sel = idx == t
            if sel.sum() < 8:
                continue
            w1 = calculate_all_wasserstein_metrics(
                real[:m][sel], gen[:m][sel], calculate_efps=False, **self.w1_kwargs
            )
            out[f"w1m_mean_{name}"] = w1["w1m_mean"]
            out[f"w1p_mean_{name}"] = w1["w1p_mean"]
        return out


@dataclass
class FinalEvalCallback(JetNetEvalCallback):
    """Post-training final evaluation: oversampled generation, W1 metrics,
    substructure W1 (tau21/tau32/d2), FPD/KPD on the EFPs, saved arrays.

    Parity: callbacks/jetnet_final_eval.py:37-438 (the on_test_end skeleton:
    best/last EMA checkpoint selection happens in trainer.test()). With
    `make_plots`: the substructure, the master comparison grid, the
    single-jet grids of both samples and, where the datamodule has one-hot
    labels, one grid per jet type, beside the saved arrays.
    """

    every_n_epochs: int | str = 1_000_000_000  # effectively test-only
    num_samples_factor: float = 1.0  # N x dataset size (reference: -N)
    save_dir: Optional[str] = None
    compute_substructure: bool = True
    compute_fpd_kpd: bool = True
    make_plots: bool = True
    on_test: bool = True

    def __call__(self, trainer) -> Optional[dict]:
        if not getattr(trainer, "testing", False) and not should_log(
            self.every_n_epochs, max(trainer.epoch, 1)
        ):
            return None
        from particle_fm_tpu_torch.eval.efp import efps
        from particle_fm_tpu_torch.eval.metrics import (
            fpd_infinite,
            kpd,
            wasserstein_distance_batched,
        )
        from particle_fm_tpu_torch.eval.substructure import compute_substructure

        device = trainer.device
        real = self._arrays(trainer.datamodule)[0]
        n = max(int(len(real) * self.num_samples_factor), 1)
        real, gen, gen_time = self._generate(trainer, n)
        out_dir = self.save_dir or trainer.artifacts_dir
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, "final_generated_data.npy"), gen)

        metrics = calculate_all_wasserstein_metrics(
            real[:n], gen, calculate_efps=self.calculate_efps, device=device, **self.w1_kwargs
        )
        metrics["generation_time"] = gen_time

        if self.compute_substructure:
            hlvs_real = compute_substructure(real[:n], device=device)
            hlvs_gen = compute_substructure(gen, device=device)
            n_eval = min(len(gen), 10_000)
            for key in ("tau21", "tau32", "d2"):
                mean, std = wasserstein_distance_batched(
                    hlvs_real[key], hlvs_gen[key], num_eval_samples=n_eval, num_batches=40
                )
                metrics[f"w1_{key}_mean"] = mean
                metrics[f"w1_{key}_std"] = std
            if self.make_plots:
                from particle_fm_tpu_torch.eval.plotting import plot_substructure

                plot_substructure(hlvs_real, hlvs_gen, os.path.join(out_dir, "substructure.png"))
        if self.compute_fpd_kpd:
            # FPD/KPD on the EFP feature set
            e_real = efps(real[:n], device=device)
            e_gen = efps(gen, device=device)
            # official jetnet protocol: extrapolate the O(1/N) bias away
            fpd_val, fpd_err = fpd_infinite(e_real, e_gen)
            metrics["fpd"] = fpd_val
            metrics["fpd_err"] = fpd_err
            kpd_med, kpd_std = kpd(e_real, e_gen)
            metrics["kpd_median"] = kpd_med
            metrics["kpd_std"] = kpd_std

        if self.make_plots:
            from particle_fm_tpu_torch.eval.plotting import (plot_data, plot_data_per_type,
                                                             plot_single_jets)

            plot_data(real[:n], gen, os.path.join(out_dir, "final_comparison.png"))
            plot_single_jets(gen, save_path=os.path.join(out_dir, "single_jets_gen.png"))
            plot_single_jets(real[:n], color="#1A52E2",
                             save_path=os.path.join(out_dir, "single_jets_real.png"))
            dm = trainer.datamodule
            labels = getattr(dm, f"labels_{self.split}", None)
            if labels is not None and len(labels) >= n:
                plot_data_per_type(real[:n], gen, labels[:n],
                                   type_names=getattr(dm, "used_jet_types", None),
                                   save_dir=out_dir)

        with open(os.path.join(out_dir, "final_eval_metrics.yml"), "w") as f:
            yaml.safe_dump({k: float(v) for k, v in metrics.items()}, f)
        return metrics


@dataclass
class WholeEventEvalCallback(JetNetEvalCallback):
    """Whole-event LHCO eval: generated event clouds are clustered with the
    native anti-kt into their two leading jets and compared per jet
    (constituent-level W1M/W1P and jet-feature W1), plus W1(mjj), against
    held-out real events clustered the same way."""

    cluster_R: float = 1.0
    cluster_num_particles: int = 279

    def __call__(self, trainer) -> Optional[dict]:
        if not self._should_run(trainer):
            return None
        from particle_fm_tpu_torch.eval.lhco_utils import cluster_data

        real, gen, n, gen_time = self._generate_vs_real(trainer)
        real = real[:n]

        def cluster(events_ephipt):
            # datamodule layout (eta, phi, pt) -> the clusterer's (pt, eta, phi)
            ev = np.asarray(events_ephipt)[..., [2, 0, 1]]
            jets, consts, _ = cluster_data(
                ev, num_particles=self.cluster_num_particles, R=self.cluster_R)
            return jets, consts

        jets_g, consts_g = cluster(gen)
        jets_r, consts_r = cluster(real)

        metrics = {"generation_time": gen_time}
        for j, name in ((0, "x"), (1, "y")):
            w1 = calculate_all_wasserstein_metrics(
                consts_r[:, j][..., [1, 2, 0]],  # back to (eta, phi, pt)
                consts_g[:, j][..., [1, 2, 0]],
                calculate_efps=self.calculate_efps,
                device=trainer.device,
                **self.w1_kwargs,
            )
            metrics.update({f"{k}_{name}": v for k, v in w1.items()})
            wj = calculate_wasserstein_metrics_jets(jets_r[:, j], jets_g[:, j], **self.w1_kwargs)
            metrics.update({f"{k}_{name}": v for k, v in wj.items()})

        mjj_r = get_mjj(jets_r[:, 0], jets_r[:, 1])
        mjj_g = get_mjj(jets_g[:, 0], jets_g[:, 1])
        ok_r, ok_g = np.isfinite(mjj_r), np.isfinite(mjj_g)
        if ok_r.any() and ok_g.any():
            mean, std = wasserstein_distance_batched(mjj_r[ok_r], mjj_g[ok_g], **self.w1_kwargs)
            metrics["w1_mjj_mean"], metrics["w1_mjj_std"] = mean, std
        return metrics


@dataclass
class CaloEvalCallback:
    """CaloChallenge in-training eval with the challenge's histogram protocol:
    fixed-binning histograms of the raw hit values (E: Regular(100, 0,
    6500); z, alpha, R: one bin per integer, 45/16/9 bins), each W1 the mean
    absolute CDF difference, plus energy-weighted z/alpha/R variants and the
    sum(E)/E_inc response on Regular(100, 0.6, 1.1). Metric names:
    features_E, features_z, features_alpha, features_R, features_*_weighted,
    weighted_z, w1p_mean, w1_response, generation_time. With `make_plots`,
    point-cloud grids of the generated and the real showers under
    `callback_images/`."""

    every_n_epochs: int | str = 10
    num_showers: int = 2000
    generation_batch_size: int = 256
    use_ema: bool = True
    ode_solver: str = "midpoint"
    ode_steps: int = 100
    split: str = "test"
    on_test: bool = False
    seed: int = 9999
    log_epoch_zero: bool = False
    feature_names: tuple = ("E", "z", "alpha", "R")
    e_hist: tuple = (100, 0.0, 6500.0)
    int_bins: tuple = (45, 16, 9)  # z, alpha, R integer axes
    response_hist: tuple = (100, 0.6, 1.1)
    make_plots: bool = False

    def __call__(self, trainer) -> Optional[dict]:
        if not getattr(trainer, "testing", False):
            if trainer.epoch == 0 and not self.log_epoch_zero:
                return None
            if not should_log(self.every_n_epochs, trainer.epoch):
                return None
        dm = trainer.datamodule
        real = getattr(dm, f"tensor_{self.split}")
        mask = getattr(dm, f"mask_{self.split}")
        cond = getattr(dm, f"tensor_conditioning_{self.split}")
        n = min(self.num_showers, len(real))
        gen, gen_time = generate_data(
            trainer.model,
            eval_network(trainer, self.use_ema),
            num_jet_samples=n,
            batch_size=self.generation_batch_size,
            cond=cond[:n] if cond is not None else None,
            variable_set_sizes=True,
            mask=mask[:n],
            normalized_data=dm.means is not None,
            normalize_sigma=getattr(dm, "normalize_sigma", 5),
            means=dm.means,
            stds=dm.stds,
            ode_solver=self.ode_solver,
            ode_steps=self.ode_steps,
            seed=self.seed,
            device=trainer.device,
        )
        # the W1 protocol runs in raw space (E in MeV, integer z/alpha/R);
        # the datamodule stores scaler-transformed hits, so invert both sides
        real_raw, gen_raw = real[:n], gen
        scaler = getattr(dm, "scaler", None)
        if scaler is not None:
            real_raw = scaler.inverse_transform(np.asarray(real_raw).copy())
            gen_raw = scaler.inverse_transform(np.asarray(gen_raw).copy())

        out = {"generation_time": gen_time}
        keep = mask[:n, :, 0] > 0
        rr, gg = real_raw[keep], gen_raw[keep]
        e_r, e_g = rr[:, 0], gg[:, 0]

        w1ps = []
        nb, lo, hi = self.e_hist
        w1 = _hist_cdf_w1(e_r, e_g, np.linspace(lo, hi, int(nb) + 1))
        out["features_E"] = w1
        w1ps.append(w1)
        for f, (name, nbins) in enumerate(zip(self.feature_names[1:], self.int_bins), start=1):
            if f >= rr.shape[-1]:
                break
            edges = np.arange(0, nbins + 1)
            w1 = _hist_cdf_w1(rr[:, f], gg[:, f], edges)
            out[f"features_{name}"] = w1
            w1ps.append(w1)
            w1w = _hist_cdf_w1(rr[:, f], gg[:, f], edges, weights_real=e_r, weights_gen=e_g)
            out[f"features_{name}_weighted"] = w1w
            if name == "z":
                out["weighted_z"] = w1w
        out["w1p_mean"] = float(np.nanmean(w1ps))

        # energy response sum(E_hits)/E_inc on the challenge's fixed axis
        if cond is not None:
            e_inc = np.exp(np.asarray(cond[:n]).reshape(-1) + 10.0)
            resp_r = (real_raw[..., 0] * mask[:n, :, 0]).sum(axis=1) / e_inc
            resp_g = (gen_raw[..., 0] * mask[:n, :, 0]).sum(axis=1) / e_inc
            nb, lo, hi = self.response_hist
            out["w1_response"] = _hist_cdf_w1(resp_r, resp_g, np.linspace(lo, hi, int(nb) + 1))
        if self.make_plots:
            from particle_fm_tpu_torch.eval.plotting import plot_calo_showers

            out_dir = os.path.join(trainer.artifacts_dir, "callback_images")
            plot_calo_showers(gen_raw, mask[:n], save_path=os.path.join(
                out_dir, f"showers_gen_epoch{trainer.epoch}.png"))
            plot_calo_showers(np.asarray(real_raw), mask[:n], save_path=os.path.join(
                out_dir, f"showers_real_epoch{trainer.epoch}.png"))
        return out


@dataclass
class FlatEvalCallback:
    """Eval for the flat models (LHCO stage-1 jet features, GenChallenge):
    the W1 of each feature between generated and held-out vectors, each
    logged as `<prefix>w1_<label>_mean`/`_std`, their mean
    `<prefix>w1_features_mean`, and `<prefix>generation_time`, the clock
    started after the first batch. The generated vectors are un-normalised
    with the datamodule's statistics and `normalize_sigma`. With
    `make_plots`, per-feature histograms with ratio panels, the cond columns
    first (un-normalised) when `plot_cond` is set."""

    every_n_epochs: int | str = 10
    num_samples: int = 10000
    generation_batch_size: int = 1024
    w1_num_batches: int = 40
    use_ema: bool = True
    ode_steps: int = 100
    split: str = "test"
    on_test: bool = False
    seed: int = 9999
    log_epoch_zero: bool = False
    log_times: bool = True
    make_plots: bool = False
    plot_cond: bool = False
    feature_labels: Optional[tuple] = None
    metric_prefix: str = ""  # e.g. "sr_" for signal-region twins

    def __call__(self, trainer) -> Optional[dict]:
        if not getattr(trainer, "testing", False):
            if trainer.epoch == 0 and not self.log_epoch_zero:
                return None
            if not should_log(self.every_n_epochs, trainer.epoch):
                return None
        import time

        import torch

        from particle_fm_tpu_torch.data.utils import inverse_normalize_tensor
        from particle_fm_tpu_torch.serving import chunk_seed

        dm = trainer.datamodule
        real = getattr(dm, f"tensor_{self.split}")
        cond = getattr(dm, f"tensor_conditioning_{self.split}")
        n = min(self.num_samples, len(real))
        net = eval_network(trainer, self.use_ema)
        dev = next(net.parameters()).device
        chunks = []
        t0 = None  # the clock starts after the first (warm-up) batch
        for i, lo in enumerate(range(0, n, self.generation_batch_size)):
            hi = min(lo + self.generation_batch_size, n)
            c = None if cond is None else torch.as_tensor(cond[lo:hi], device=dev)
            gen = torch.Generator(dev).manual_seed(chunk_seed(self.seed, i))
            out = trainer.model.sample(net, gen, n_samples=hi - lo, cond=c,
                                       ode_steps=self.ode_steps)
            chunks.append(out.cpu().numpy())  # the copy to the host is the fence
            if t0 is None:
                t0 = time.perf_counter()
        gen_time = (time.perf_counter() - t0) if t0 is not None else 0.0
        gen = np.concatenate(chunks, axis=0)
        if dm.means is not None:
            gen = inverse_normalize_tensor(gen, dm.means, dm.stds,
                                           getattr(dm, "normalize_sigma", 5))
        n_eval = min(n, len(real))
        labels = self.feature_labels or [f"feature_{f}" for f in range(real.shape[-1])]
        p = self.metric_prefix
        metrics, w1s = {}, []
        for f in range(real.shape[-1]):
            mean, std = wasserstein_distance_batched(
                real[:n, f], gen[:, f], num_eval_samples=min(n_eval, 5000),
                num_batches=self.w1_num_batches)
            metrics[f"{p}w1_{labels[f]}_mean"] = mean
            metrics[f"{p}w1_{labels[f]}_std"] = std
            w1s.append(mean)
        metrics[f"{p}w1_features_mean"] = float(np.mean(w1s))
        if self.log_times:
            metrics[f"{p}generation_time"] = gen_time
        if self.make_plots:
            from particle_fm_tpu_torch.eval.plotting import plot_feature_ratios

            real_p, gen_p, lab_p = real[:n], gen, list(labels)
            if self.plot_cond and cond is not None:
                cond_true = np.asarray(cond[:n])
                if getattr(dm, "cond_means", None) is not None:
                    cond_true = inverse_normalize_tensor(cond_true, dm.cond_means, dm.cond_stds,
                                                         getattr(dm, "normalize_sigma", 5))
                # [cond | features]: panel 0 is the conditioning variable
                real_p = np.concatenate([cond_true, real_p], axis=1)
                gen_p = np.concatenate([cond_true, gen_p], axis=1)
                lab_p = [f"cond_{i}" for i in range(cond_true.shape[1])] + lab_p
            plot_feature_ratios(real_p, gen_p, os.path.join(
                trainer.artifacts_dir, "callback_images", f"{p}features_epoch{trainer.epoch}.png"),
                labels=lab_p)
        return metrics


@dataclass
class GenChallengeEvalCallback(FlatEvalCallback):
    """GenChallenge eval: dijet features generated conditioned on mjj
    against the held-out sideband split, or with split='<split>_sr' and
    metric_prefix='sr_' against its signal-region twin (the mjj window the
    model never trained on). Plots by default, the mjj panel first."""

    make_plots: bool = True
    plot_cond: bool = True
    split: str = "val"
    feature_labels: Optional[tuple] = ("mj1", "delta_mj", "tau41_j1", "tau41_j2")


@dataclass
class ClassifierEvalCallback:
    """Accuracy and AUROC on the test split for the classifier models (the
    gen-vs-real classifier test). Binary probabilities give both; a
    two-class softmax gives both on P(class 1); more classes give the
    accuracy only. `batch_size` is kept for the config and unused: the test
    split is taken in the datamodule's batches, as in the JAX package."""

    every_n_epochs: int | str = 1
    batch_size: int = 1024
    on_test: bool = True
    use_ema: bool = False

    def __call__(self, trainer) -> Optional[dict]:
        if not should_log(self.every_n_epochs, trainer.epoch):
            return None
        import torch

        from particle_fm_tpu_torch.models.classifiers import binary_metrics

        model, dev = trainer.model, trainer.device
        net = model.inference_network(eval_network(trainer, self.use_ema))
        probs, labels = [], []
        for x, mask, cond in trainer.datamodule.test_batches():
            p = model.predict(net, torch.as_tensor(x, device=dev),
                              None if mask is None else torch.as_tensor(mask, device=dev))
            probs.append(p.float().cpu().numpy())
            labels.append(np.asarray(cond).reshape(-1))
        probs, labels = np.concatenate(probs), np.concatenate(labels)
        if probs.ndim > 1 and probs.shape[-1] == 2:
            return binary_metrics(probs[:, 1], labels)
        if probs.ndim > 1:
            return {"accuracy": float((probs.argmax(-1) == labels).mean())}
        return binary_metrics(probs, labels)
