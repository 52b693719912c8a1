"""Physics evaluation metrics: bootstrapped Wasserstein-1, KLD, FPD/KPD;
counterpart of particle_fm_tpu/eval/metrics.py (numpy and scipy, on the
host), function for function. Only `w1efp` touches the device: its EFPs
come from `eval/efp.py::efps` on `device` (CUDA unless the caller asks for
the CPU).

Parity: particle_fm/data/components/metrics.py. The jetnet.evaluation
w1m/w1p/w1efp functions are re-implemented here (the package is not a
dependency): same bootstrap protocol — num_batches random subsets of
num_eval_samples jets each, scipy W1 per subset, mean ± std.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import wasserstein_distance

from particle_fm_tpu_torch.data.utils import ms_from_p4s, p4s_from_ptyphims
from particle_fm_tpu_torch.eval.efp import efps

# the bootstrap's generator, unseeded as in the JAX package; the tests pin it
_rng = np.random.default_rng()


def jet_masses_from_rel(jets: np.ndarray) -> np.ndarray:
    """Relative jet mass from (etarel, phirel, ptrel) clouds (massless sum)."""
    pd = jets[..., [2, 0, 1]]  # -> (pt, y, phi)
    return ms_from_p4s(np.sum(p4s_from_ptyphims(pd), axis=-2))


def wasserstein_distance_batched(
    data1: np.ndarray, data2: np.ndarray, num_eval_samples: int, num_batches: int,
    rng: np.random.Generator | None = None,
):
    """Bootstrap W1: num_batches random subsets, scipy W1 each, mean/std."""
    rng = rng or _rng
    w1 = []
    for _ in range(num_batches):
        s1 = data1[rng.choice(len(data1), size=num_eval_samples)]
        s2 = data2[rng.choice(len(data2), size=num_eval_samples)]
        w1.append(wasserstein_distance(s1, s2))
    return float(np.mean(w1)), float(np.std(w1))


def calculate_wasserstein_metrics_jets(
    jet_data1: np.ndarray,
    jet_data2: np.ndarray,
    num_eval_samples: int = 50_000,
    num_batches: int = 40,
    **kwargs,
):
    """W1 of the jet coordinates (pt, eta, phi, mass)."""
    out = {}
    for i, name in enumerate(["pt", "eta", "phi", "mass"]):
        mean, std = wasserstein_distance_batched(
            jet_data1[:, i], jet_data2[:, i], num_eval_samples, num_batches
        )
        out[f"w1{name}_jet_mean"] = mean
        out[f"w1{name}_jet_std"] = std
    return out


def w1m(jets1, jets2, num_eval_samples=50_000, num_batches=40, rng=None):
    """W1 between jet-mass distributions (jetnet.evaluation.w1m equivalent)."""
    m1 = jet_masses_from_rel(np.asarray(jets1))
    m2 = jet_masses_from_rel(np.asarray(jets2))
    return wasserstein_distance_batched(m1, m2, num_eval_samples, num_batches, rng)


def _real_particles(jets: np.ndarray, mask: np.ndarray | None) -> np.ndarray:
    """(B, N, F) -> (P, F) keeping real particles (mask or exclude-zeros)."""
    if mask is not None:
        keep = mask[..., 0] > 0 if mask.ndim == 3 else mask > 0
    else:
        keep = np.abs(jets[..., :3]).sum(axis=-1) != 0
    return jets[keep]


def w1p(
    jets1,
    jets2,
    mask1=None,
    mask2=None,
    num_eval_samples=50_000,
    num_batches=40,
    rng=None,
):
    """Per-feature particle W1 averaged over bootstrap batches.

    Returns (means (F,), stds (F,)) like jetnet.evaluation.w1p(return_std=True).
    """
    rng = rng or _rng
    jets1, jets2 = np.asarray(jets1), np.asarray(jets2)
    mask1 = np.asarray(mask1) if mask1 is not None else None
    mask2 = np.asarray(mask2) if mask2 is not None else None
    nf = jets1.shape[-1]
    w1s = []
    for _ in range(num_batches):
        i1 = rng.choice(len(jets1), size=num_eval_samples)
        i2 = rng.choice(len(jets2), size=num_eval_samples)
        p1 = _real_particles(jets1[i1], mask1[i1] if mask1 is not None else None)
        p2 = _real_particles(jets2[i2], mask2[i2] if mask2 is not None else None)
        w1s.append(
            [wasserstein_distance(p1[:, f], p2[:, f]) for f in range(nf)]
        )
    w1s = np.asarray(w1s)
    return w1s.mean(axis=0), w1s.std(axis=0)


def w1efp(jets1, jets2, num_eval_samples=50_000, num_batches=40, rng=None, efp_jobs=None,
          device="cuda"):
    """W1 on energy-flow polynomials (n==4, d==4), per-EFP bootstrap; the
    EFPs are computed on `device`."""
    rng = rng or _rng
    e1 = efps(np.asarray(jets1), device=device)
    e2 = efps(np.asarray(jets2), device=device)
    k = e1.shape[-1]
    w1s = []
    for _ in range(num_batches):
        s1 = e1[rng.choice(len(e1), size=num_eval_samples)]
        s2 = e2[rng.choice(len(e2), size=num_eval_samples)]
        w1s.append([wasserstein_distance(s1[:, f], s2[:, f]) for f in range(k)])
    w1s = np.asarray(w1s)
    return w1s.mean(axis=0), w1s.std(axis=0)


def calculate_all_wasserstein_metrics(
    jets1,
    jets2,
    mask1=None,
    mask2=None,
    num_eval_samples: int = 50_000,
    num_batches: int = 40,
    calculate_efps: bool = True,
    use_masks: bool = False,
    device="cuda",
):
    """w1m / w1p / w1efp with stds — the headline quality metrics; the EFPs
    of w1efp on `device`.

    Parity: data/components/metrics.py:83-159 (feature order (eta, phi, pt))."""
    jets1 = np.asarray(jets1)[..., :3]
    jets2 = np.asarray(jets2)[..., :3]
    num_eval_samples = min(num_eval_samples, len(jets1), len(jets2))
    w1m_mean, w1m_std = w1m(jets1, jets2, num_eval_samples, num_batches)
    w1p_mean, w1p_std = w1p(
        jets1, jets2,
        mask1 if use_masks else None,
        mask2 if use_masks else None,
        num_eval_samples, num_batches,
    )
    w1efp_mean, w1efp_std = (0.0, 0.0)
    if calculate_efps:
        w1efp_mean, w1efp_std = w1efp(jets1, jets2, num_eval_samples, num_batches, device=device)
    return {
        "w1m_mean": w1m_mean,
        "w1m_std": w1m_std,
        "w1p_mean": float(np.mean(w1p_mean)),
        "w1p_std": float(np.mean(w1p_std)),
        "w1efp_mean": float(np.mean(w1efp_mean)),
        "w1efp_std": float(np.mean(w1efp_std)),
    }


# --------------------------------------------------------------- FPD / KPD


def _frechet_gaussian_distance(r: np.ndarray, g: np.ndarray) -> float:
    """||mu1-mu2||^2 + Tr(C1 + C2 - 2 sqrt(C1 C2)) on already-standardized
    feature sets."""
    from scipy import linalg

    mu1, mu2 = r.mean(axis=0), g.mean(axis=0)
    c1 = np.cov(r, rowvar=False)
    c2 = np.cov(g, rowvar=False)
    covmean = linalg.sqrtm(c1 @ c2)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(np.sum((mu1 - mu2) ** 2) + np.trace(c1 + c2 - 2.0 * covmean))


def _standardize_pair(real_features, gen_features):
    mu_r = real_features.mean(axis=0)
    sd_r = real_features.std(axis=0) + 1e-12
    return (real_features - mu_r) / sd_r, (gen_features - mu_r) / sd_r


def fpd(real_features: np.ndarray, gen_features: np.ndarray) -> float:
    """Frechet physics distance between standardized feature sets.

    Gaussian-approximation Frechet distance ||mu1-mu2||^2 +
    Tr(C1 + C2 - 2 sqrt(C1 C2)); features standardized by the real set's
    mean/std (the convention of the FPD paper used by jetnet.evaluation.fpd).
    This is the plain finite-sample value; `fpd_infinite` extrapolates the
    sample-size bias away like the official jetnet protocol.
    """
    r, g = _standardize_pair(real_features, gen_features)
    return _frechet_gaussian_distance(r, g)


def fpd_infinite(
    real_features: np.ndarray,
    gen_features: np.ndarray,
    min_samples: int = 5000,
    max_samples: int = 50000,
    num_batches: int = 20,
    num_points: int = 10,
    seed: int = 42,
) -> tuple[float, float]:
    """FPD extrapolated to infinite sample size (the official protocol of
    jetnet.evaluation.fpd / the FPD paper, arXiv:2211.10295).

    The Gaussian Frechet distance has an O(1/N) finite-sample bias, so the
    protocol measures the mean FD over `num_batches` random subsets at
    `num_points` subset sizes spaced uniformly in 1/N between `min_samples`
    and `max_samples`, fits a line in 1/N, and reports the intercept
    (value at N -> infinity) with its fit standard error.
    """
    n_avail = min(len(real_features), len(gen_features))
    max_samples = min(max_samples, n_avail)
    min_samples = min(min_samples, max_samples // 2 if max_samples >= 2 else 1)
    min_samples = max(min_samples, real_features.shape[-1] + 2)  # cov needs N > d
    r_all, g_all = _standardize_pair(real_features, gen_features)
    if min_samples > max_samples:
        # too few samples for the subset protocol (the d+2 floor exceeds the
        # available set): fall back to the plain full-set value
        return _frechet_gaussian_distance(r_all, g_all), float("nan")

    rng = np.random.default_rng(seed)
    inv_n = np.linspace(1.0 / min_samples, 1.0 / max_samples, num_points)
    sizes = np.unique((1.0 / inv_n).astype(int))
    xs, ys = [], []
    for n in sizes:
        vals = [
            _frechet_gaussian_distance(
                r_all[rng.choice(len(r_all), size=n, replace=False)],
                g_all[rng.choice(len(g_all), size=n, replace=False)],
            )
            for _ in range(num_batches)
        ]
        xs.append(1.0 / n)
        ys.append(float(np.mean(vals)))
    if len(xs) < 3:  # too little data to fit: fall back to the full-set value
        return _frechet_gaussian_distance(r_all, g_all), float("nan")
    params, cov = np.polyfit(xs, ys, 1, cov=True)
    return float(params[1]), float(np.sqrt(np.diag(cov)[1]))


def kpd(real_features: np.ndarray, gen_features: np.ndarray, num_batches: int = 10,
        batch_size: int = 5000, seed: int = 42) -> tuple[float, float]:
    """Kernel physics distance: unbiased MMD^2 with the cubic polynomial
    kernel k(x,y) = (x.y/dim + 1)^3 on standardized features; median over
    random batches (the KPD protocol)."""
    rng = np.random.default_rng(seed)
    mu = real_features.mean(axis=0)
    sd = real_features.std(axis=0) + 1e-12
    r_all = (real_features - mu) / sd
    g_all = (gen_features - mu) / sd
    d = r_all.shape[-1]

    def k(a, b):
        return (a @ b.T / d + 1.0) ** 3

    vals = []
    for _ in range(num_batches):
        r = r_all[rng.choice(len(r_all), size=min(batch_size, len(r_all)))]
        g = g_all[rng.choice(len(g_all), size=min(batch_size, len(g_all)))]
        n, m = len(r), len(g)
        krr = k(r, r)
        kgg = k(g, g)
        krg = k(r, g)
        mmd = (
            (krr.sum() - np.trace(krr)) / (n * (n - 1))
            + (kgg.sum() - np.trace(kgg)) / (m * (m - 1))
            - 2.0 * krg.mean()
        )
        vals.append(mmd)
    return float(np.median(vals)), float(np.std(vals))


# ------------------------------------------------------------------- KLD


def kl_divergence(p, q, rescale: bool = False, verbose: bool = False):
    """KLD(P||Q) over discrete bins, zeros excluded. Parity: metrics.py:162-197."""
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    if rescale:
        if not np.isclose(p.sum(), 1):
            p = p / p.sum()
        if not np.isclose(q.sum(), 1):
            q = q / q.sum()
    zero = np.logical_or(p == 0, q == 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.sum(np.where(zero, 0, p * np.log(p / q))))


def histedges_equalN(x, nbin):
    """Edges of nbin equiprobable bins. Parity: metrics.py:200-221."""
    n = len(x)
    return np.interp(np.linspace(0, n, nbin + 1), np.arange(n), np.sort(x))


def calc_reverse_kld(
    target,
    approx,
    nbins: int = 100,
    return_pi_qi_bins: bool = False,
    clip_approx: bool = False,
    rescale_pq: bool = False,
    verbose: bool = False,
):
    """Reverse KLD KL(Q||P) on equiprobable-binned histograms. Parity: :224-273."""
    bins = histedges_equalN(target, nbins)
    p_i = np.histogram(target, bins=bins)[0] / len(target)
    if clip_approx:
        approx = np.clip(approx, bins[0], bins[-1])
    q_i = np.histogram(approx, bins=bins)[0] / len(approx)
    kld = kl_divergence(p=q_i, q=p_i, rescale=rescale_pq, verbose=verbose)
    if return_pi_qi_bins:
        return kld, p_i, q_i, bins
    return kld


def reversed_kl_divergence_batched_bootstrapping(
    target,
    approx,
    mask_target=None,
    mask_approx=None,
    num_eval_samples: int = 50_000,
    num_batches: int = 10,
    nbins: int = 100,
    clip_approx: bool = False,
    rescale_pq: bool = False,
    verbose: bool = False,
):
    """Bootstrapped reverse KLD (jets sampled, then particles flattened).
    Parity: metrics.py:276-357 (fixed seed 42)."""
    rng = np.random.default_rng(42)
    vals = []
    for _ in range(num_batches):
        r1 = rng.choice(len(target), size=num_eval_samples)
        r2 = rng.choice(len(approx), size=num_eval_samples)
        t = target[r1]
        a = approx[r2]
        if t.ndim > 1:
            t = t[mask_target[r1]] if mask_target is not None else t
            t = t.flatten()
        if a.ndim > 1:
            a = a[mask_approx[r2]] if mask_approx is not None else a
            a = a.flatten()
        vals.append(
            calc_reverse_kld(t, a, nbins=nbins, clip_approx=clip_approx, rescale_pq=rescale_pq)
        )
    return float(np.mean(vals)), float(np.std(vals))


def reversed_kl_divergence_batched(
    target,
    approx,
    mask_target=None,
    mask_approx=None,
    num_batches: int = 10,
    nbins: int = 100,
    clip_approx: bool = False,
    rescale_pq: bool = False,
    verbose: bool = False,
):
    """Chunked (non-bootstrap) reverse KLD. Parity: metrics.py:360-442."""
    t_b = np.array_split(target, num_batches)
    a_b = np.array_split(approx, num_batches)
    mt_b = np.array_split(mask_target, num_batches) if mask_target is not None else None
    ma_b = np.array_split(mask_approx, num_batches) if mask_approx is not None else None
    vals = []
    for i in range(num_batches):
        t, a = t_b[i], a_b[i]
        if t.ndim > 1:
            t = t[mt_b[i]] if mt_b is not None else t
            t = t.flatten()
        if a.ndim > 1:
            a = a[ma_b[i]] if ma_b is not None else a
            a = a.flatten()
        vals.append(
            calc_reverse_kld(t, a, nbins=nbins, clip_approx=clip_approx, rescale_pq=rescale_pq)
        )
    return float(np.mean(vals)), float(np.std(vals))
