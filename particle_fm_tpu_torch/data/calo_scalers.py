"""CaloChallenge preprocessing scalers (per-feature pipelines over flat hit
arrays); counterpart of particle_fm_tpu/data/calo_scalers.py in numpy only.

The JAX package builds its pipelines from sklearn's `Pipeline` and
`StandardScaler`. This module carries its own two with sklearn's arithmetic,
so that a machine without sklearn trains and evaluates the same way:

- `StandardScaler` fits the mean and the population variance with float64
  accumulators and the corrected two-pass formula, and takes a scale of 1
  where a feature is constant within the rounding bound of that formula
  (sklearn's `_is_constant_feature` and `_handle_zeros_in_scale`);
  `transform` is (x - mean) / scale, `inverse_transform` x * scale + mean.
- `Pipeline.fit` fits each step but the last on the output of the previous
  one (`fit(X).transform(X)`), then fits the last; `inverse_transform` runs
  the steps backwards.

`DQ` draws its dequantisation noise from one `RandomState(seed)` whose state
moves on with every `transform` (and the `fit` of a pipeline that holds it):
the stream matches the JAX package's only when the calls come in the same
order, which the datamodule keeps. Inputs are finite (no NaN handling).
"""

from __future__ import annotations

import numpy as np


class _Transformer:
    """fit is a no-op unless a subclass learns something."""

    def fit(self, X, y=None):
        return self


class LogitTransformer(_Transformer):
    """x -> log(x / (1-x)); inverse is the sigmoid."""

    def transform(self, X, y=None):
        return np.log(X / (1.0 - X))

    def inverse_transform(self, X, y=None):
        return 1.0 / (1.0 + np.exp(-X))


class SqrtTransformer(_Transformer):
    def transform(self, X, y=None):
        return np.sqrt(X)

    def inverse_transform(self, X, y=None):
        return np.square(X)


class DQ(_Transformer):
    """Dequantisation: add U[0,1) noise; the inverse floors back to the grid."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rs = np.random.RandomState(seed)

    def transform(self, X, y=None):
        return X + self._rs.rand(*np.shape(X))

    def inverse_transform(self, X, y=None):
        return np.floor(X)


class DQLinear(DQ):
    """Dequantisation with the same uniform noise (the JAX package's variant)."""


class LogitScaler(_Transformer):
    """MinMax to (eps, 1-eps), then logit; for bounded features."""

    def __init__(self, eps: float = 1e-6):
        self.eps = eps
        self._min = None
        self._max = None

    def fit(self, X, y=None):
        self._min = np.min(X, axis=0)
        self._max = np.max(X, axis=0)
        return self

    def transform(self, X, y=None):
        z = (X - self._min) / np.maximum(self._max - self._min, 1e-30)
        z = np.clip(z, self.eps, 1 - self.eps)
        return np.log(z / (1 - z))

    def inverse_transform(self, X, y=None):
        z = 1.0 / (1.0 + np.exp(-X))
        return z * (self._max - self._min) + self._min


class LogTransformer(_Transformer):
    """x -> log(x + eps) for strictly positive heavy-tailed features (hit
    energies in MeV); the inverse is exp - eps."""

    def __init__(self, eps: float = 1e-8):
        self.eps = eps

    def transform(self, X, y=None):
        return np.log(np.maximum(X, 0.0) + self.eps)

    def inverse_transform(self, X, y=None):
        return np.exp(X) - self.eps


def _float_copy(X) -> np.ndarray:
    """A copy in X's float dtype (float32 or float64), else in float64."""
    X = np.asarray(X)
    return np.array(X, dtype=X.dtype if X.dtype in (np.float32, np.float64) else np.float64)


class StandardScaler:
    """Per-column z-score with sklearn's fit (see the module docstring)."""

    def fit(self, X, y=None):
        X = np.asarray(X)
        if X.dtype not in (np.float32, np.float64):
            X = X.astype(np.float64)
        n = X.shape[0]
        count = np.full(X.shape[1], float(n))
        self.mean_ = np.sum(X, axis=0, dtype=np.float64) / count
        temp = X - self.mean_
        correction = np.sum(temp, axis=0, dtype=np.float64)
        temp **= 2
        unnormalised = np.sum(temp, axis=0, dtype=np.float64)
        unnormalised -= correction**2 / count
        self.var_ = unnormalised / count
        eps = np.finfo(np.float64).eps
        constant = self.var_ <= n * eps * self.var_ + (n * self.mean_ * eps) ** 2
        self.scale_ = np.sqrt(self.var_)
        self.scale_[constant] = 1.0
        self.n_samples_seen_ = n
        return self

    def transform(self, X, y=None):
        X = _float_copy(X)
        X -= self.mean_
        X /= self.scale_
        return X

    def inverse_transform(self, X, y=None):
        X = _float_copy(X)
        X *= self.scale_
        X += self.mean_
        return X


class Pipeline:
    """Named steps applied in order (see the module docstring)."""

    def __init__(self, steps: list):
        self.steps = steps

    def fit(self, X, y=None):
        for _, step in self.steps[:-1]:
            X = step.fit(X).transform(X)
        self.steps[-1][1].fit(X)
        return self

    def transform(self, X, y=None):
        for _, step in self.steps:
            X = step.transform(X)
        return X

    def inverse_transform(self, X, y=None):
        for _, step in reversed(self.steps):
            X = step.inverse_transform(X)
        return X


class ScalerBase:
    """Per-feature transformer pipeline over flat (P, F) point arrays."""

    def __init__(self, transfs: list, featurenames: list[str] | None = None):
        self.transfs = transfs
        self.featurenames = featurenames or [f"f{i}" for i in range(len(transfs))]
        self.n_features = len(transfs)
        self.fitted_ = False

    def _check(self, pcs: np.ndarray) -> None:
        if pcs.shape[-1] != self.n_features:
            raise ValueError(f"expected {self.n_features} features, got shape {pcs.shape}")

    def fit(self, pcs: np.ndarray) -> "ScalerBase":
        if pcs.ndim != 2:
            raise ValueError(f"fit takes flat (P, F) points, got shape {pcs.shape}")
        self._check(pcs)
        for i, tr in enumerate(self.transfs):
            tr.fit(pcs[:, i : i + 1])
        self.fitted_ = True
        return self

    def _apply(self, pcs: np.ndarray, method: str) -> np.ndarray:
        self._check(pcs)
        shape = pcs.shape
        flat = pcs.reshape(-1, self.n_features).astype(np.float64)
        out = np.hstack(
            [getattr(tr, method)(flat[:, i : i + 1]) for i, tr in enumerate(self.transfs)]
        )
        return out.reshape(shape).astype(np.float32)

    def transform(self, pcs: np.ndarray) -> np.ndarray:
        return self._apply(pcs, "transform")

    def inverse_transform(self, pcs: np.ndarray) -> np.ndarray:
        return self._apply(pcs, "inverse_transform")


def default_calo_scaler(seed: int = 0) -> ScalerBase:
    """The training-space scaler of CaloChallenge (E, z, alpha, r) hits: E
    (MeV, heavy-tailed) -> log + standardise; the integer voxel coordinates
    -> dequantise (uniform noise; the inverse floors back to the grid) +
    standardise. The datamodule fits it on the train split's hits."""

    def dq_std(s):
        return Pipeline([("dq", DQ(seed=s)), ("std", StandardScaler())])

    return ScalerBase(
        [
            Pipeline([("log", LogTransformer()), ("std", StandardScaler())]),
            dq_std(seed),
            dq_std(seed + 1),
            dq_std(seed + 2),
        ],
        featurenames=["E", "z", "alpha", "r"],
    )
