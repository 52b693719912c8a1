"""Plotting suite (host-side matplotlib); counterpart of
particle_fm_tpu/eval/plotting.py, drawing the same histograms and lines.

The master data-comparison grid (particle features, jet features,
multiplicity, selected-particle pT), substructure comparisons, loss curves,
single-jet and calorimeter-shower point clouds, per-jet-type grids,
generation timing, and per-feature ratio panels. matplotlib is imported at
the top with the Agg backend, as in the JAX module: every caller imports
this module only when it plots, so a run without matplotlib raises an
ImportError that names it there and nowhere else. The EFPs of
`prepare_data_for_plotting` and the generation of `measure_generation_timing`
run on the device of the port's eval/efp.py and eval/generation.py: the
given `device`, or the network's own (`measure_generation_timing` lives in
eval/generation.py, which imports without matplotlib, and is named here).

Each function saves its figure to `save_path` (its directory made) and
returns the path, or returns the figure when no path is given.
"""

from __future__ import annotations

import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

from particle_fm_tpu_torch.data.utils import (  # noqa: E402
    calculate_jet_features,
    get_pt_of_selected_particles,
)
from particle_fm_tpu_torch.eval.generation import measure_generation_timing  # noqa: E402,F401

FEATURE_LABELS = [r"$\eta^{rel}$", r"$\phi^{rel}$", r"$p_T^{rel}$"]
JET_LABELS = [r"jet $p_T$", "jet $y$", r"jet $\phi$", "jet mass"]


def apply_mpl_styles() -> None:
    """The house style of every figure."""
    plt.rcParams.update(
        {
            "figure.dpi": 110,
            "axes.grid": True,
            "grid.alpha": 0.3,
            "font.size": 11,
            "legend.frameon": False,
            "hist.bins": 100,
        }
    )


def _finish(fig, save_path: str | None, **savefig_kwargs):
    """Save and close the figure and return the path, or return the figure."""
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, **savefig_kwargs)
        plt.close(fig)
        return save_path
    return fig


def _hist_pair(ax, real, gen, bins=100, label_real="real", label_gen="generated",
               log=False, xlabel=""):
    lo = min(np.nanmin(real), np.nanmin(gen))
    hi = max(np.nanmax(real), np.nanmax(gen))
    if lo == hi:
        hi = lo + 1.0
    edges = np.linspace(lo, hi, bins + 1)
    ax.hist(real, bins=edges, histtype="stepfilled", alpha=0.4, label=label_real, density=True)
    ax.hist(gen, bins=edges, histtype="step", lw=1.5, label=label_gen, density=True)
    if log:
        ax.set_yscale("log")
    ax.set_xlabel(xlabel)
    ax.legend()


def prepare_data_for_plotting(data: np.ndarray, calculate_efps: bool = False,
                              device="cuda") -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """(B, N, [eta, phi, pt]) -> (jet features, multiplicities, EFPs or None)."""
    jets = calculate_jet_features(data)
    mult = np.count_nonzero(data[..., 2], axis=1)
    efps = None
    if calculate_efps:
        from particle_fm_tpu_torch.eval.efp import efps as efps_fn

        efps = efps_fn(data, device=device)
    return jets, mult, efps


def plot_data(
    real: np.ndarray,
    gen: np.ndarray,
    save_path: str | None = None,
    plot_efps: bool = False,
    selected_particles: tuple = (1, 3, 10),
    suffix: str = "",
    device="cuda",
):
    """Master comparison grid: per-feature particle histograms, jet
    features, multiplicity, selected-particle pT (and 4 EFPs)."""
    apply_mpl_styles()
    n_feat = min(real.shape[-1], 3)
    rows = 3 + (1 if plot_efps else 0)
    fig, axes = plt.subplots(rows, 4, figsize=(18, 4 * rows))

    for f in range(n_feat):  # row 0: particle features, real particles only
        rm = real[..., f][np.abs(real).sum(-1) > 0]
        gm = gen[..., f][np.abs(gen).sum(-1) > 0]
        _hist_pair(axes[0, f], rm, gm, xlabel=FEATURE_LABELS[f], log=(f == 2))
    axes[0, 3].axis("off")

    jets_r, mult_r, efps_r = prepare_data_for_plotting(real, plot_efps, device)
    jets_g, mult_g, efps_g = prepare_data_for_plotting(gen, plot_efps, device)
    for f in range(4):  # row 1: jet features
        _hist_pair(axes[1, f], jets_r[:, f], jets_g[:, f], xlabel=JET_LABELS[f])

    # row 2: multiplicity and selected-particle pT
    _hist_pair(axes[2, 0], mult_r, mult_g, bins=40, xlabel="multiplicity")
    pt_r = get_pt_of_selected_particles(real, selected_particles)
    pt_g = get_pt_of_selected_particles(gen, selected_particles)
    for i, k in enumerate(selected_particles[:3]):
        _hist_pair(axes[2, i + 1], pt_r[i], pt_g[i], xlabel=rf"$p_T^{{rel}}$ of particle {k}",
                   log=True)

    if plot_efps and efps_r is not None:
        for f in range(min(4, efps_r.shape[-1])):
            _hist_pair(axes[3, f], efps_r[:, f], efps_g[:, f], xlabel=f"EFP {f}", log=True)

    fig.suptitle(f"real vs generated {suffix}")
    fig.tight_layout()
    return _finish(fig, save_path)


def create_and_plot_data(real, gen, save_folder: str, plot_name: str = "plot", **kwargs):
    """`plot_data` into `<save_folder>/<plot_name>.png`."""
    return plot_data(real, gen, os.path.join(save_folder, f"{plot_name}.png"), **kwargs)


def plot_substructure(hlvs_real: dict, hlvs_gen: dict, save_path: str | None = None):
    """tau21 / tau32 / d2 / jet mass comparison."""
    apply_mpl_styles()
    keys = ["tau21", "tau32", "d2", "jet_mass"]
    fig, axes = plt.subplots(1, len(keys), figsize=(4.5 * len(keys), 4))
    for ax, k in zip(axes, keys):
        _hist_pair(ax, hlvs_real[k], hlvs_gen[k], bins=60, xlabel=k)
    fig.tight_layout()
    return _finish(fig, save_path)


def plot_loss_curves(metrics_history: list[dict], save_path: str | None = None,
                     keys: tuple = ("train_loss", "val_loss")):
    """Loss curves from the trainer's metric history."""
    apply_mpl_styles()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    epochs = [m.get("epoch", i) for i, m in enumerate(metrics_history)]
    for k in keys:
        ax.plot(epochs, [m.get(k, np.nan) for m in metrics_history], label=k)
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.legend()
    fig.tight_layout()
    return _finish(fig, save_path)


def plot_single_jets(data: np.ndarray, color: str = "#E2001A", save_path: str | None = None,
                     n_jets: int = 16, seed: int = 0):
    """Grid of randomly picked jets as (eta, phi) point clouds, marker size
    proportional to pt."""
    apply_mpl_styles()
    side = int(np.ceil(np.sqrt(n_jets)))
    fig, axes = plt.subplots(side, side, figsize=(4 * side, 4 * side))
    rs = np.random.RandomState(seed)
    for i, ax in enumerate(np.asarray(axes).ravel()):
        if i >= n_jets:
            ax.axis("off")
            continue
        pts = data[rs.randint(len(data))]
        real = np.abs(pts).sum(-1) > 0
        ax.scatter(pts[real, 0], pts[real, 1], s=5000 * np.abs(pts[real, 2]), color=color,
                   alpha=0.5)
        ax.set_xlabel(r"$\eta$")
        ax.set_ylabel(r"$\phi$")
        ax.set_xlim(-0.3, 0.3)
        ax.set_ylim(-0.3, 0.3)
    fig.tight_layout()
    return _finish(fig, save_path, bbox_inches="tight")


def plot_data_per_type(real: np.ndarray, gen: np.ndarray, labels: np.ndarray,
                       type_names: list | None = None, save_dir: str | None = None,
                       **plot_kwargs) -> list:
    """One master comparison grid per jet type (the one-hot `labels` pick
    the type; types with fewer than 8 jets are skipped). Returns the saved
    paths or the figures."""
    idx = np.argmax(labels, axis=1)
    names = type_names or [str(i) for i in range(labels.shape[1])]
    out = []
    for t, name in enumerate(names):
        sel = idx[: len(gen)] == t
        if sel.sum() < 8:
            continue
        path = os.path.join(save_dir, f"comparison_{name}.png") if save_dir else None
        out.append(plot_data(real[: len(gen)][sel], gen[sel], path, suffix=f"({name})",
                             **plot_kwargs))
    return out


def plot_calo_showers(x: np.ndarray, mask: np.ndarray | None = None,
                      save_path: str | None = None, n_showers: int = 9, seed: int = 0):
    """Calorimeter showers as point clouds: hits in the (z, r) plane, marker
    size and colour by hit energy (features (E, z, alpha, r))."""
    apply_mpl_styles()
    side = int(np.ceil(np.sqrt(n_showers)))
    fig, axes = plt.subplots(side, side, figsize=(4 * side, 3.5 * side))
    rs = np.random.RandomState(seed)
    for i, ax in enumerate(np.asarray(axes).ravel()):
        if i >= n_showers:
            ax.axis("off")
            continue
        idx = rs.randint(len(x))
        hits = x[idx]
        keep = mask[idx, :, 0] > 0 if mask is not None else np.abs(hits).sum(-1) > 0
        h = hits[keep]
        if len(h) == 0:
            continue
        e = np.abs(h[:, 0])
        sc = ax.scatter(h[:, 1], h[:, 3], s=3 + 40 * e / max(e.max(), 1e-9), c=e,
                        cmap="viridis", alpha=0.7)
        ax.set_xlabel("z layer")
        ax.set_ylabel("r bin")
        fig.colorbar(sc, ax=ax, label="E")
    fig.tight_layout()
    return _finish(fig, save_path)


def plot_generation_timing(curves: list, save_path: str | None = None,
                           xscale_log: bool = False):
    """Generation seconds per jet against particles per jet, one curve per
    model: `curves` = [(label, particles_per_jet, seconds_per_jet), ...]."""
    apply_mpl_styles()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for label, sizes, row in curves:
        ax.plot(list(sizes), list(row), marker="o", label=label)
    ax.set_xlabel("Particles per Jet")
    ax.set_ylabel("Generation time per jet [s]")
    if xscale_log:
        ax.set_xscale("log")
    ax.legend()
    fig.tight_layout()
    return _finish(fig, save_path)


def plot_feature_ratios(real: np.ndarray, gen: np.ndarray, save_path: str | None = None,
                        labels: list | None = None):
    """Per-feature histograms over the real range (60 bins, densities) with
    gen/real ratio panels."""
    apply_mpl_styles()
    n_feat = real.shape[-1]
    labels = labels or [f"feature {i}" for i in range(n_feat)]
    fig, axes = plt.subplots(2, n_feat, figsize=(4.5 * n_feat, 6), height_ratios=[3, 1],
                             sharex="col")
    if n_feat == 1:
        axes = axes.reshape(2, 1)
    for f in range(n_feat):
        r = real[..., f].ravel()
        g = gen[..., f].ravel()
        lo, hi = np.nanmin(r), np.nanmax(r)
        edges = np.linspace(lo, hi if hi > lo else lo + 1, 61)
        hr, _ = np.histogram(r, bins=edges, density=True)
        hg, _ = np.histogram(g, bins=edges, density=True)
        centers = 0.5 * (edges[1:] + edges[:-1])
        axes[0, f].stairs(hr, edges, fill=True, alpha=0.4, label="real")
        axes[0, f].stairs(hg, edges, lw=1.5, label="generated")
        axes[0, f].legend()
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(hr > 0, hg / hr, np.nan)
        axes[1, f].plot(centers, ratio, ".")
        axes[1, f].axhline(1.0, color="k", lw=0.8)
        axes[1, f].set_ylim(0.5, 1.5)
        axes[1, f].set_xlabel(labels[f])
        axes[1, f].set_ylabel("gen/real")
    fig.tight_layout()
    return _finish(fig, save_path)
