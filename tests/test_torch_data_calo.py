"""PyTorch port, the CaloChallenge path on the CPU: the scalers
(`data/calo_scalers.py`, numpy only), the datamodule (`data/calo.py`), the
prefetch (`data/prefetch.py`) and the Trainer's streaming path, held against
the JAX package (whose scalers are sklearn's).

- `default_calo_scaler` fitted, then transform twice and inverse, on seeded
  hits and on hits with a constant energy column (sklearn's zero-variance
  rule gives it a scale of 1): within 1e-12 relative of the JAX package's
  sklearn pipelines; the port's `StandardScaler` alone against sklearn's on
  float32 and float64 columns, one of them constant (mean, variance, scale,
  transform, inverse), within 1e-12 relative.
- `DQ` with one seed: three successive transforms equal to the JAX
  package's, bit for bit.
- The datamodule's arrays, and the bucketed, alpha-rotated train batches of
  two epochs (with and without a token budget) and the val/test batches:
  the same shapes and masks, values within 1e-6.
- The Trainer's streaming path (not device-cacheable: host batches through
  the prefetch worker) on a small MDMA (2 layers, width 32) with the JAX
  weights and the draws pinned alike: three steps whose losses are within
  1e-5 relative of the JAX trainer's streaming path.
- A worker's exception surfaces in the consumer: from `prefetch_to_device`
  and through `Trainer.fit`.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from sklearn.preprocessing import StandardScaler as SkStandardScaler

from particle_fm_tpu.data import calo as jcalo
from particle_fm_tpu.data import calo_scalers as jsc
from particle_fm_tpu.data.synthetic import synthetic_calo
from particle_fm_tpu.parallel import train as jtrain
from particle_fm_tpu.parallel.mesh import make_mesh
from particle_fm_tpu.training.trainer import Trainer as JaxTrainer
from particle_fm_tpu_torch.data import calo as pcalo
from particle_fm_tpu_torch.data import calo_scalers as psc
from particle_fm_tpu_torch.data.prefetch import prefetch_to_device
from particle_fm_tpu_torch.training import step as pstep
from particle_fm_tpu_torch.training.trainer import Trainer
from tests.test_torch_train_step import _port_state
from tests.torch_port_helpers import MDMA_SMALL, model_pair, pin_draws_on_demand

RTOL = 1e-12


def hits(constant_energy: bool = False) -> np.ndarray:
    x, mask, _ = synthetic_calo(120, 64, seed=3)
    h = x[mask[..., 0] > 0]
    if constant_energy:
        h[:, 0] = 250.0
    return h


@pytest.mark.parametrize("constant_energy", [False, True])
def test_default_scaler_matches_sklearn(constant_energy):
    h = hits(constant_energy)
    out = {}
    for name, mod in (("jax", jsc), ("port", psc)):
        s = mod.default_calo_scaler(seed=2).fit(h)
        a = s.transform(h)
        b = s.transform(h[:50])
        out[name] = (a, b, s.inverse_transform(a), s.transfs[0].steps[1][1].scale_)
    for got, want in zip(out["port"], out["jax"]):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert (out["port"][3] == 1.0) == constant_energy  # the zero-variance rule


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_standard_scaler_matches_sklearn(dtype):
    rs = np.random.RandomState(0)
    x = np.stack([rs.randn(500) * 3 + 7, np.full(500, 0.1), rs.exponential(2.0, 500)],
                 axis=1).astype(dtype)
    sk, port = SkStandardScaler().fit(x), psc.StandardScaler().fit(x)
    for key in ("mean_", "var_", "scale_"):
        np.testing.assert_allclose(getattr(port, key), getattr(sk, key), rtol=RTOL, atol=0,
                                   err_msg=key)
    assert port.scale_[1] == sk.scale_[1] == 1.0
    y = x.astype(np.float64)
    for method in ("transform", "inverse_transform"):
        got, want = getattr(port, method)(y), getattr(sk, method)(y)
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, err_msg=method)


def test_dq_stream_matches_jax():
    x = hits()[:, 1:2].astype(np.float64)
    jdq, pdq = jsc.DQ(seed=5), psc.DQ(seed=5)
    for _ in range(3):
        np.testing.assert_array_equal(pdq.transform(x), jdq.transform(x))
    np.testing.assert_array_equal(pdq.inverse_transform(x + 0.5), jdq.inverse_transform(x + 0.5))


def calo_pair(**kw):
    out = []
    for mod, scalers in ((jcalo, jsc), (pcalo, psc)):
        dm = mod.CaloChallengeDataModule(synthetic=True, scaler=scalers.default_calo_scaler(),
                                         rotate_alpha=True, **kw)
        dm.setup()
        out.append(dm)
    return out


def assert_same_batches(got, want) -> None:
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[0].shape == w[0].shape
        np.testing.assert_array_equal(g[1], w[1])  # masks
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(g[2], w[2], rtol=0, atol=1e-6)


@pytest.mark.parametrize("max_tokens", [None, 600])
def test_bucketed_rotated_batches_match_jax(max_tokens):
    jdm, pdm = calo_pair(synthetic_num_showers=200, max_hits=200, batch_size=16,
                         bucket_multiple=16, max_tokens_per_batch=max_tokens)
    assert not pdm.device_cacheable and pdm.steps_per_epoch == jdm.steps_per_epoch
    for split in ("train", "val", "test"):
        for key in (f"tensor_{split}", f"mask_{split}", f"tensor_conditioning_{split}"):
            np.testing.assert_array_equal(getattr(pdm, key), getattr(jdm, key), err_msg=key)
    for epoch_seed in (5, 6):  # the DQ stream moves on from epoch to epoch
        assert_same_batches(pdm.train_batches(seed=epoch_seed), jdm.train_batches(seed=epoch_seed))
    assert_same_batches(pdm.val_batches(), jdm.val_batches())
    assert_same_batches(pdm.test_batches(), jdm.test_batches())
    lengths = {b[0].shape[1] for b in pdm.train_batches(seed=7)}
    assert len(lengths) > 1 and all(n % 16 == 0 or n == 200 for n in lengths)


def test_streaming_trainer_matches_jax(monkeypatch):
    """24 train showers in 3 batches of 8 (one epoch), rotated, of one
    length (the JAX side runs op by op, so that it takes its pinned draws at
    each step, and compiles each operation once a shape)."""
    jdm, pdm = calo_pair(synthetic_num_showers=30, max_hits=16, batch_size=8,
                         bucket_multiple=16)
    assert pdm.steps_per_epoch == 3
    jm, variables, pm, _ = model_pair(MDMA_SMALL, fill=0.1)
    params = variables["params"]
    jopt = jtrain.make_optimizer(lr=1e-3, weight_decay=5e-5, grad_clip=0.5)
    jstate = jtrain.TrainState(params=params, norm_stats={},
                               ema_params=jax.tree_util.tree_map(np.copy, params),
                               opt_state=jopt.init(params), step=np.zeros((), np.int32))
    popt = pstep.make_optimizer(lr=1e-3, weight_decay=5e-5, grad_clip=0.5)
    pstate = _port_state(pm, popt, jstate)
    common = dict(max_epochs=1, check_val_every_n_epoch=100, verbose=False, seed=3)
    jtrainer = JaxTrainer(model=jm, datamodule=jdm, optimizer=jopt, scan_epochs=False,
                          mesh=make_mesh(devices=jax.devices()[:1]), **common)
    trainer = Trainer(pm, pdm, popt, device="cpu", **common)
    assert trainer._maybe_cache_train_data() is None  # the streaming path

    losses = {"jax": [], "port": []}

    def recording(owner, key):
        step = owner.train_step

        def run(*args):
            out = step(*args)
            loss = out[1] if isinstance(out, tuple) else out
            losses[key].append(float(np.asarray(loss.detach() if key == "port" else loss)))
            return out
        owner.train_step = run

    recording(jtrainer, "jax")
    recording(trainer, "port")
    pin_draws_on_demand(monkeypatch, seed=6)
    with jax.disable_jit():
        jtrainer.fit(initial_state=jstate)
    trainer.fit(initial_state=pstate)
    assert len(losses["port"]) == len(losses["jax"]) == 3
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)
    assert trainer.state.step == 3


def test_prefetch_reraises_the_worker_exception():
    def items():
        yield 1
        yield 2
        raise RuntimeError("the host batch failed")

    got = []
    with pytest.raises(RuntimeError, match="the host batch failed"):
        for item in prefetch_to_device(items(), lambda a: a * 10, depth=2):
            got.append(item)
    assert got == [10, 20]


def test_streaming_fit_raises_the_worker_exception():
    _, pdm = calo_pair(synthetic_num_showers=30, max_hits=64, batch_size=8, bucket_multiple=16)

    def broken(seed=0):
        yield next(iter(pcalo.CaloChallengeDataModule.train_batches(pdm, seed)))
        raise ValueError("shower file truncated")

    pdm.train_batches = broken
    _, _, pm, _ = model_pair(MDMA_SMALL)
    trainer = Trainer(pm, pdm, pstep.make_optimizer(lr=1e-3), device="cpu", verbose=False,
                      max_epochs=1)
    with pytest.raises(ValueError, match="shower file truncated"):
        trainer.fit()


def test_the_cache_follows_the_jax_rule():
    """A device-cacheable split under the limit is placed on the device;
    the bucketed calo split never is; a split over the limit streams."""
    _, pdm = calo_pair(synthetic_num_showers=30, max_hits=64, batch_size=8, bucket_multiple=16)
    from particle_fm_tpu_torch.data.jetnet import JetNetDataModule

    jets = JetNetDataModule(synthetic=True, synthetic_num_jets=200, jet_type=["t"],
                            num_particles=30, batch_size=32)
    jets.setup()
    _, _, pm, _ = model_pair(MDMA_SMALL)

    def cached(dm, **kw):
        t = Trainer(pm, dm, pstep.make_optimizer(), device="cpu", verbose=False, **kw)
        return t._maybe_cache_train_data() is not None

    assert cached(jets) and not cached(pdm)
    assert not cached(jets, device_cache_limit_mb=0)


def test_streamed_accumulation_stacks_the_host_batches():
    """With accumulate_grad_batches=2 the streaming path yields each pair of
    host batches stacked (2, B, ...), as the JAX trainer does (one length, so
    that a pair stacks)."""
    dm = pcalo.CaloChallengeDataModule(synthetic=True, scaler=psc.default_calo_scaler(),
                                       synthetic_num_showers=50, max_hits=16, batch_size=8,
                                       bucket_multiple=16)
    dm.setup()
    _, _, pm, _ = model_pair(MDMA_SMALL)
    trainer = Trainer(pm, dm, pstep.make_optimizer(), device="cpu", verbose=False, seed=2,
                      accumulate_grad_batches=2)
    want = list(dm.train_batches(seed=2 + 1))
    got = list(trainer._epoch_batches(None, 1))
    assert len(want) == 5 and len(got) == 2  # the fifth batch fills no pair
    for g, pair in zip(got, (want[0:2], want[2:4])):
        for j in range(3):
            np.testing.assert_array_equal(g[j].numpy(), np.stack([b[j] for b in pair]))
