"""Hyperparameter-search samplers, random and TPE (Tree-structured Parzen
Estimator); the port's copy of particle_fm_tpu/training/hparam.py (numpy
only).

Parity: the reference delegates adaptive search to Optuna's TPESampler via
the hydra sweeper (configs/hparams_search/mnist_optuna.yaml,
`sampler: _target_: optuna.samplers.TPESampler`); the port does not depend
on optuna, so the sampler half is implemented here with Optuna's
semantics:

  * first `n_startup_trials` proposals are random (seeded),
  * afterwards completed trials are split at the gamma-quantile of the
    objective into "good" (l) and "bad" (g) sets,
  * continuous (log-uniform) dims: 1-D Parzen windows (Gaussian KDE in log
    space, bandwidth by the good/bad set spread) — candidates are drawn from
    l and ranked by the acquisition ratio l(x)/g(x),
  * categorical dims: smoothed (add-one) category frequencies in l and g,
    ranked by the same ratio,
  * the joint proposal scores candidates by the product of per-dim ratios
    (TPE's independence approximation).

Search-space grammar matches scripts/torch_hparam_search.py: categorical dims are
lists of strings, continuous dims are (lo, hi) log-uniform floats.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np


@dataclasses.dataclass
class TrialRecord:
    params: dict
    value: float


def _is_better(a: float, b: float, mode: str) -> bool:
    return a < b if mode == "min" else a > b


class RandomSampler:
    """Uniform over categoricals, log-uniform over continuous ranges."""

    def __init__(self, cat_space: Mapping[str, Sequence], log_space: Mapping[str, tuple],
                 seed: int = 0):
        self.cat_space = dict(cat_space)
        self.log_space = dict(log_space)
        self.rs = np.random.RandomState(seed)

    def suggest(self, history: Sequence[TrialRecord]) -> dict:  # noqa: ARG002
        picks = {
            k: choices[self.rs.randint(len(choices))]
            for k, choices in self.cat_space.items()
        }
        picks.update(
            {
                k: float(np.exp(self.rs.uniform(np.log(lo), np.log(hi))))
                for k, (lo, hi) in self.log_space.items()
            }
        )
        return picks


class TPESampler(RandomSampler):
    """Independent 1-D Parzen-estimator TPE (Bergstra et al., NeurIPS 2011)."""

    def __init__(self, cat_space, log_space, seed: int = 0, mode: str = "min",
                 n_startup_trials: int = 4, gamma: float = 0.25,
                 n_candidates: int = 24):
        super().__init__(cat_space, log_space, seed=seed)
        self.mode = mode
        self.n_startup_trials = int(n_startup_trials)
        self.gamma = float(gamma)
        self.n_candidates = int(n_candidates)

    # -- per-dim densities --------------------------------------------------
    def _split(self, history: Sequence[TrialRecord]):
        finite = [t for t in history if np.isfinite(t.value)]
        values = np.array([t.value for t in finite])
        order = np.argsort(values if self.mode == "min" else -values)
        n_good = max(1, int(np.ceil(self.gamma * len(finite))))
        good_idx = set(order[:n_good].tolist())
        good = [finite[i] for i in range(len(finite)) if i in good_idx]
        bad = [finite[i] for i in range(len(finite)) if i not in good_idx]
        return good, bad

    @staticmethod
    def _kde_logpdf(x: np.ndarray, centers: np.ndarray, bw: float,
                    lo: float, hi: float) -> np.ndarray:
        """Mixture of Gaussians at `centers` with shared bandwidth, plus a
        uniform-over-range prior component (Optuna's 'prior' kernel) so the
        density never vanishes inside the search box."""
        # (n_x, n_centers)
        z = (x[:, None] - centers[None, :]) / bw
        comp = -0.5 * z**2 - np.log(bw * np.sqrt(2 * np.pi))
        prior = -np.log(hi - lo)
        all_comp = np.concatenate([comp, np.full((len(x), 1), prior)], axis=1)
        m = all_comp.max(axis=1, keepdims=True)
        return (m[:, 0] + np.log(np.exp(all_comp - m).mean(axis=1)))

    def _continuous_scores(self, key, good, bad, cands: np.ndarray) -> np.ndarray:
        lo, hi = self.log_space[key]
        llo, lhi = np.log(lo), np.log(hi)

        def centers(trials):
            return np.log([float(t.params[key]) for t in trials])

        def bw(c):
            spread = c.max() - c.min() if len(c) > 1 else 0.0
            return max(spread / max(len(c), 1), (lhi - llo) / 20.0)

        cg, cb = centers(good), centers(bad)
        lx = np.log(cands)
        l_log = self._kde_logpdf(lx, cg, bw(cg), llo, lhi)
        g_log = (
            self._kde_logpdf(lx, cb, bw(cb), llo, lhi)
            if len(cb)
            else np.full(len(lx), -np.log(lhi - llo))
        )
        return l_log - g_log

    def _continuous_candidates(self, key, good) -> np.ndarray:
        lo, hi = self.log_space[key]
        llo, lhi = np.log(lo), np.log(hi)
        cg = np.log([float(t.params[key]) for t in good])
        spread = cg.max() - cg.min() if len(cg) > 1 else 0.0
        bw = max(spread / max(len(cg), 1), (lhi - llo) / 20.0)
        out = []
        for _ in range(self.n_candidates):
            # sample from l: one extra slot is the uniform prior component
            j = self.rs.randint(len(cg) + 1)
            x = (
                self.rs.uniform(llo, lhi)
                if j == len(cg)
                else cg[j] + bw * self.rs.randn()
            )
            out.append(float(np.clip(x, llo, lhi)))
        return np.exp(np.array(out))

    def _categorical_scores(self, key, good, bad, cands: list) -> np.ndarray:
        choices = list(self.cat_space[key])

        def logp(trials):
            counts = np.ones(len(choices))  # add-one smoothing = uniform prior
            for t in trials:
                counts[choices.index(str(t.params[key]))] += 1
            return np.log(counts / counts.sum())

        lp_good, lp_bad = logp(good), logp(bad)
        idx = np.array([choices.index(c) for c in cands])
        return lp_good[idx] - lp_bad[idx]

    def _categorical_candidates(self, key, good) -> list:
        choices = list(self.cat_space[key])
        counts = np.ones(len(choices))
        for t in good:
            counts[choices.index(str(t.params[key]))] += 1
        p = counts / counts.sum()
        idx = self.rs.choice(len(choices), size=self.n_candidates, p=p)
        return [choices[i] for i in idx]

    # -- proposal -----------------------------------------------------------
    def suggest(self, history: Sequence[TrialRecord]) -> dict:
        finite = [t for t in history if np.isfinite(t.value)]
        if len(finite) < self.n_startup_trials or not (self.cat_space or self.log_space):
            return super().suggest(history)
        good, bad = self._split(finite)

        score = np.zeros(self.n_candidates)
        cand_by_key: dict = {}
        for key in self.log_space:
            cands = self._continuous_candidates(key, good)
            cand_by_key[key] = cands
            score += self._continuous_scores(key, good, bad, cands)
        for key in self.cat_space:
            cands = self._categorical_candidates(key, good)
            cand_by_key[key] = cands
            score += self._categorical_scores(key, good, bad, cands)

        best = int(np.argmax(score))
        out = {}
        for key in self.cat_space:
            out[key] = cand_by_key[key][best]
        for key in self.log_space:
            out[key] = float(cand_by_key[key][best])
        return out


def make_sampler(name: str, cat_space, log_space, seed: int = 0,
                 mode: str = "min", **kw):
    if name == "random":
        return RandomSampler(cat_space, log_space, seed=seed)
    if name == "tpe":
        return TPESampler(cat_space, log_space, seed=seed, mode=mode, **kw)
    raise ValueError(f"unknown sampler {name!r} (random|tpe)")
