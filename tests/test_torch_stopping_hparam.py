"""PyTorch port, `training/stopping.py` and `training/hparam.py` held against
the JAX package's on the same metric sequences and seeds: `EarlyStopping`
stops at the same epoch with the same best value and wait count (plateaus,
improvements by less than min_delta, max mode, a non-finite value with and
without check_finite), `MedianPruner` and `PruningCallback` prune at the
same epochs, and `RandomSampler`, `TPESampler` and `make_sampler` make the
same suggestions, trial after trial, over categorical, log-uniform and mixed
spaces with failed (NaN) trials among them. Importing both modules loads no
JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

from particle_fm_tpu.training import hparam as jhparam
from particle_fm_tpu.training import stopping as jstopping
from particle_fm_tpu_torch.training import hparam as phparam
from particle_fm_tpu_torch.training import stopping as pstopping

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeTrainer:
    def __init__(self):
        self.epoch = 0
        self.last_metrics = {}
        self.should_stop = False


SEQUENCES = {
    "plateau": ([1.0, 0.9, 0.91, 0.92, 0.93, 0.94], dict(patience=3)),
    "improvements reset": ([1.0, 0.99, 1.1, 0.5, 0.6, 0.55, 0.7, 0.8], dict(patience=2)),
    "min_delta": ([1.0, 0.995, 0.99, 0.985, 0.98, 0.5], dict(patience=3, min_delta=0.01)),
    "max mode": ([0.1, 0.3, 0.2, 0.25, 0.29, 0.3], dict(patience=3, mode="max")),
    "nan stops": ([1.0, 0.9, float("nan"), 0.8], dict(patience=100)),
    "nan kept": ([1.0, float("nan"), float("nan"), 0.9, 1.2, 1.3],
                 dict(patience=2, check_finite=False)),
    "missing metric": ([1.0, None, None, 1.1, 1.2], dict(patience=2)),
}


def stop_trace(module, values, kw):
    tr, es = FakeTrainer(), module.EarlyStopping(monitor="val_loss", **kw)
    trace = []
    for epoch, v in enumerate(values):
        tr.epoch = epoch
        tr.last_metrics = {} if v is None else {"val_loss": v}
        es(tr)
        trace.append((tr.should_stop, es.wait, repr(es.best)))
        if tr.should_stop:
            break
    return trace


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_early_stopping_stops_where_jax_stops(name):
    values, kw = SEQUENCES[name]
    assert stop_trace(pstopping, values, kw) == stop_trace(jstopping, values, kw)


def prune_trace(module, curves, **kw):
    pruner = module.MedianPruner(**kw)
    out = []
    for curve in curves:
        tr, cb = FakeTrainer(), module.PruningCallback(pruner, monitor="val_loss")
        for epoch, v in enumerate(curve):
            tr.epoch, tr.last_metrics = epoch, {"val_loss": v}
            cb(tr)
            if tr.should_stop:
                break
        out.append((cb.pruned, tr.epoch, dict(cb.history)))
        if not cb.pruned:
            pruner.complete(cb.history)
    return out, pruner.completed


@pytest.mark.parametrize("kw", [dict(), dict(n_startup_trials=1, n_warmup_epochs=2),
                                dict(mode="max", n_startup_trials=3)])
def test_median_pruner_prunes_where_jax_prunes(kw):
    rs = np.random.RandomState(0)
    curves = [list(np.cumsum(rs.rand(6)) * (1 + 0.3 * rs.randn())) for _ in range(8)]
    curves[5] = curves[2]  # a tie with the median
    assert prune_trace(pstopping, curves, **kw) == prune_trace(jstopping, curves, **kw)


SPACES = {
    "mixed": ({"model.hidden_dim": ["64", "128", "256"], "model.layers": ["4", "6", "8"]},
              {"model.optimizer.lr": (1e-4, 3e-3), "trainer.ema.decay": (0.9, 0.9999)}),
    "categorical only": ({"a": ["x", "y"], "b": ["1", "2", "3", "4"]}, {}),
    "log-uniform only": ({}, {"lr": (1e-5, 1e-1)}),
}


def suggestions(module, name, cat, log, seed, n=14):
    sampler = module.make_sampler(name, cat, log, seed=seed, mode="min",
                                  **({"n_startup_trials": 4} if name == "tpe" else {}))
    history, out = [], []
    for i in range(n):
        picks = sampler.suggest(history)
        out.append(picks)
        # a deterministic objective of the picks; every fifth trial fails
        value = float("nan") if i % 5 == 4 else sum(
            np.log(float(v)) if k in log else float(len(str(v)) + ord(str(v)[0]) % 7)
            for k, v in sorted(picks.items()))
        history.append(module.TrialRecord(params=picks, value=value))
    return out


@pytest.mark.parametrize("sampler", ["random", "tpe"])
@pytest.mark.parametrize("space", list(SPACES))
def test_samplers_suggest_what_jax_suggests(sampler, space):
    cat, log = SPACES[space]
    for seed in (0, 3):
        assert suggestions(phparam, sampler, cat, log, seed) == \
            suggestions(jhparam, sampler, cat, log, seed)
    with pytest.raises(ValueError, match="unknown sampler"):
        phparam.make_sampler("grid", cat, log)


def test_importing_stopping_and_hparam_loads_no_jax():
    code = ("import sys, particle_fm_tpu_torch.training.stopping, "
            "particle_fm_tpu_torch.training.hparam; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'particle_fm_tpu')]; assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)
