"""PyTorch port, training and sampling across two processes on the CPU
(gloo), the counterpart of tests/test_multihost.py's four scenarios plus
the checkpoint scenario through the Trainer.

Two ranks (tests/helpers/torch_parallel_worker.py) run every case of one
setup; the JAX package's `dp` runs here on a mesh of two of the test run's
virtual CPU devices (data=2), as tests/test_fsdp_sp.py builds its mesh,
with t and the noise pinned to the same arrays on every side (the jitted
JAX step takes its draws once, at its trace: every side takes the same ones
every step). The masks are ragged and the two halves of each global batch
hold different numbers of real particles, so a loss normalised per rank
would show.

- train: 3 steps at W=2 against JAX dp at data=2 and the port in one
  process: the loss 1e-6, parameters and EMA 1e-5; with and without
  `use_normaliser` (whose statistics are then held at 1e-6); with
  accumulation (2 microbatches) against one process; the plain DDP
  reduction (the mean of the ranks' local means) misses the loss.
- fsdp: against dp at rtol 1e-3, atol 1e-5 (tests/test_fsdp_sp.py::
  test_fsdp_matches_dp's tolerance), with accumulation too; every rank holds fewer elements than
  the whole of each leaf JAX's `fsdp_spec` shards, of the parameter, its
  EMA and its Adam moments, and all of each leaf it replicates.
- ckpt: Trainer runs at W=2 (dp and fsdp) with checkpoints written by rank
  0: a run resumed from its `last.pt` equals the uninterrupted one, both
  equal one process, and a single-process `Trainer.test` loads the files;
  streamed batches (no device cache) at W=2 equal one process.
- sample: rank-split sampling equals local sampling at 1e-4 on each rank.

The training CLI under torchrun is in tests/test_torch_parallel.py.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.losses import flow_matching as jloss
from particle_fm_tpu.models.flow_matching import FlowMatchingModel as JaxModel
from particle_fm_tpu.parallel import train as jtrain
from particle_fm_tpu.parallel.fsdp import fsdp_spec
from particle_fm_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel as PortModel
from particle_fm_tpu_torch.training import step as pstep
from particle_fm_tpu_torch.training.trainer import Trainer
from particle_fm_tpu_torch.utils.from_jax import state_dict_from_flax
from tests.torch_port_helpers import YAML_FLAGSHIP, cloud, filled

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "helpers", "torch_parallel_worker.py")
B, N, STEPS, LR = 8, 16, 3, 1e-3
# sincos time: the jitted JAX step rounds the cosine ladder's products otherwise
# than the port, and that field is chaotic in t
CFG = dict(YAML_FLAGSHIP, t_emb="sincos", frequencies=6)
DIFF = {"max_sr": 0.999, "min_sr": 0.02}  # configs/model/fm_droid_transformer.yaml's diff_config
NORMED = dict(CFG, use_normaliser=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(rank: int | None = None, port: int | None = None) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    if rank is not None:
        env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
    return env


def _run_workers(cases: list, workdir: str) -> list[dict]:
    torch.save(cases, os.path.join(workdir, "setup.pt"))
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, WORKER, workdir], env=_env(r, port), cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(2)]


def _batches(n: int, b: int = B, seed: int = 20, scaled: bool = False):
    out = []
    for i in range(n):
        x, m, c, _ = cloud(b=b, n=N, seed=seed + i)
        if scaled:  # away from mean 0, variance 1, for the normaliser
            x, c = (x * (2.0 + i) + 1.5) * m, c * 3.0 - 0.7
        out.append((x, m, c))
    return out


def _initial(cfg):
    """(jax model, variables with norm_stats where the model has them, port
    state dict of the same parameters and statistics)."""
    jm = JaxModel(**cfg)
    params = filled(jax.eval_shape(jm.init, jax.random.PRNGKey(0))["params"], 0, 0.1)
    fresh = PortModel(**cfg).init(device="cpu")
    norm_stats = {name: {leaf: getattr(getattr(fresh, name), leaf).numpy()
                         for leaf in ("means", "m2", "vars", "n")}
                  for name in ("normaliser", "ctxt_normaliser") if hasattr(fresh, name)}
    sd = fresh.state_dict()
    sd.update(state_dict_from_flax(params))
    for name, leaves in norm_stats.items():
        for leaf, v in leaves.items():
            sd[f"{name}.{leaf}"] = torch.from_numpy(np.array(v))
    return jm, params, norm_stats, sd


def _draws(shape, seed=5):
    rs = np.random.RandomState(seed)
    return rs.rand(shape[0]).astype(np.float32), rs.randn(*shape).astype(np.float32)


def _jax_dp(jm, params, norm_stats, batches, t_arr, z_arr, mp: pytest.MonkeyPatch):
    mp.setattr(jloss, "_sample_t", lambda _r, size, _w: jnp.asarray(t_arr))
    mp.setattr(jloss, "_normal", lambda _r, shape, _w: jnp.asarray(z_arr))
    mesh = make_mesh(data=2, model=1, devices=jax.devices()[:2])
    jopt = jtrain.make_optimizer(lr=LR)
    state = replicate(jtrain.TrainState(
        params=params, norm_stats=jax.tree_util.tree_map(jnp.asarray, norm_stats),
        ema_params=jax.tree_util.tree_map(jnp.copy, params), opt_state=jopt.init(params),
        step=jnp.zeros((), jnp.int32)), mesh)
    step = jtrain.make_train_step(jm, jopt, ema_decay=0.9, mesh=mesh)
    losses = []
    for batch in batches:
        state, loss = step(state, jax.random.PRNGKey(0), *shard_batch(batch, mesh))
        losses.append(float(loss))
    state = jax.device_get(state)
    return losses, state_dict_from_flax(state.params), state_dict_from_flax(state.ema_params), \
        state.norm_stats


def _port_single(cfg, sd, batches, t_arr, z_arr, mp: pytest.MonkeyPatch, accum=1):
    from particle_fm_tpu_torch.losses import flow_matching as ploss

    mp.setattr(ploss, "_sample_t", lambda _g, size, dev: torch.from_numpy(t_arr.copy()))
    mp.setattr(ploss, "_normal", lambda _g, shape, dev: torch.from_numpy(z_arr.copy()))
    model = PortModel(**cfg)
    state = pstep.create_train_state(model, pstep.make_optimizer(lr=LR), device="cpu")
    state.net.load_state_dict(sd)
    state.ema_params = [p.detach().clone() for p in state.net.parameters()]
    step = pstep.make_train_step(model, pstep.make_optimizer(lr=LR), ema_decay=0.9, accum=accum)
    losses = [float(step(state, torch.Generator(), *(torch.from_numpy(a) for a in batch)))
              for batch in batches]
    return losses, state


def _stack(batches, accum=2):
    return [tuple(a.reshape((accum, B) + a.shape[1:]) for a in batch) for batch in batches]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case once: the two ranks' results, the JAX dp runs and the
    port's single-process runs."""
    workdir = str(tmp_path_factory.mktemp("parallel"))
    cases, ref = [], {}
    mp = pytest.MonkeyPatch()
    try:
        for name, cfg, scaled in (("plain", CFG, False), ("normaliser", NORMED, True)):
            jm, params, norm_stats, sd = _initial(cfg)
            batches = _batches(STEPS, scaled=scaled)
            t_arr, z_arr = _draws(batches[0][0].shape)
            ref[name] = {"jax": _jax_dp(jm, params, norm_stats, batches, t_arr, z_arr, mp),
                         "single": _port_single(cfg, sd, batches, t_arr, z_arr, mp)}
            common = dict(kind="train", cfg=cfg, params=sd, batches=batches, t=t_arr, z=z_arr,
                          lr=LR)
            cases.append(dict(common, name=f"dp-{name}", strategy="dp"))
            if name == "plain":
                cases.append(dict(common, name="fsdp", strategy="fsdp"))
                cases.append(dict(common, name="plain-ddp", strategy="dp", plain_ddp=True))
                big = _batches(STEPS, b=2 * B, seed=40)
                t2, z2 = _draws((B,) + big[0][0].shape[1:], seed=6)
                for strategy in ("dp", "fsdp"):
                    cases.append(dict(common, name=f"{strategy}-accum", strategy=strategy,
                                      accum=2, batches=_stack(big), t=t2, z=z2))
                ref["accum"] = {"single": _port_single(cfg, sd, _stack(big), t2, z2, mp,
                                                       accum=2)}
    finally:
        mp.undo()
    jm, params, _, sd = _initial(CFG)
    mask = cloud(b=8, n=N, seed=3)[1]
    cases.append(dict(kind="sample", name="sample", cfg=CFG, params=sd, mask=mask,
                      cond=cloud(b=8, n=N, seed=3)[2], ode_steps=6))
    cases.append(dict(kind="sample", name="sample-em", cfg=dict(CFG, loss_type="diffusion",
                                                                diff_config=DIFF),
                      params=sd, mask=mask, cond=cloud(b=8, n=N, seed=3)[2], ode_steps=6,
                      solver="em"))
    arrays = {split: _arrays(48 if split == "train" else 20, seed)
              for split, seed in (("train", 60), ("val", 61))}
    for strategy in ("dp", "fsdp"):
        cases.append(dict(kind="trainer", name=f"trainer-{strategy}", cfg=CFG, lr=LR,
                          arrays=arrays, batch_size=B, epochs=4, strategy=strategy,
                          dir=os.path.join(workdir, strategy)))
    cases.append(dict(kind="trainer", name="trainer-dp-streamed", cfg=CFG, lr=LR, arrays=arrays,
                      batch_size=B, epochs=2, strategy="dp", streamed=True, resume=False,
                      dir=os.path.join(workdir, "streamed")))
    return _run_workers(cases, workdir), ref, cases, arrays


def _arrays(n: int, seed: int):
    x, m, c, _ = cloud(b=n, n=N, seed=seed)
    return x, m, c


def _close(a, b, rtol=0.0, atol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol, err_msg=msg)


def _ranks_agree(ranks, name):
    r0, r1 = ranks[0][name], ranks[1][name]
    assert r0["losses"] == r1["losses"]
    for k in r0["params"]:
        assert torch.equal(r0["params"][k], r1["params"][k]), k
    for a, b in zip(r0["ema"], r1["ema"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["plain", "normaliser"])
def test_dp_two_ranks_equal_jax_dp_and_one_process(runs, name):
    ranks, ref, _, _ = runs
    _ranks_agree(ranks, f"dp-{name}")
    got = ranks[0][f"dp-{name}"]
    j_losses, j_params, j_ema, j_stats = ref[name]["jax"]
    s_losses, s_state = ref[name]["single"]
    _close(got["losses"], j_losses, rtol=1e-6, atol=0, msg="loss vs jax")
    _close(got["losses"], s_losses, rtol=1e-6, atol=0, msg="loss vs one process")
    assert got["step"] == STEPS
    names = [n for n, _ in s_state.net.named_parameters()]
    for i, n in enumerate(names):
        _close(got["params"][n], j_params[n], msg=f"param {n} vs jax")
        _close(got["ema"][i], j_ema[n], msg=f"ema {n} vs jax")
        _close(got["params"][n], s_state.net.state_dict()[n], msg=f"param {n} vs one process")
        _close(got["ema"][i], s_state.ema_params[i], msg=f"ema {n} vs one process")
    for layer, leaves in j_stats.items():  # the normalisers' statistics of the global batch
        for leaf, v in leaves.items():
            np.testing.assert_allclose(got["params"][f"{layer}.{leaf}"].numpy(), v, rtol=1e-6)
    # the updates moved the parameters by far more than the tolerance
    start = next(c for c in runs[2] if c["name"] == f"dp-{name}")["params"]
    assert max(float((got["params"][n] - start[n]).abs().max()) for n in names) > 1e-4


def test_dp_accumulation_reduces_once_and_equals_one_process(runs):
    ranks, ref, _, _ = runs
    _ranks_agree(ranks, "dp-accum")
    got = ranks[0]["dp-accum"]
    s_losses, s_state = ref["accum"]["single"]
    _close(got["losses"], s_losses, rtol=1e-6, atol=0)
    for i, (n, p) in enumerate(s_state.net.named_parameters()):
        _close(got["params"][n], p.detach(), msg=n)
        _close(got["ema"][i], s_state.ema_params[i], msg=n)


def test_fsdp_accumulation_equals_dp_accumulation(runs):
    ranks, _, _, _ = runs
    _ranks_agree(ranks, "fsdp-accum")
    fs, dp = ranks[0]["fsdp-accum"], ranks[0]["dp-accum"]
    np.testing.assert_allclose(fs["losses"], dp["losses"], rtol=1e-3, atol=1e-5)
    for k, v in dp["params"].items():
        np.testing.assert_allclose(fs["params"][k].numpy(), v.numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    for a, b in zip(fs["ema"], dp["ema"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-5)


def test_streamed_batches_two_ranks_equal_one_process(runs):
    """The host-batched path (a split beyond the device cache): each rank
    streams its rows of the same global batches."""
    ranks, _, _, arrays = runs
    got = ranks[0]["trainer-dp-streamed"]["straight"]
    assert got["step"] == 2 * (48 // B)
    from tests.helpers.torch_parallel_worker import Arrays

    dm = Arrays(arrays, B, streamed=True)
    dm.setup()
    one = Trainer(model=PortModel(**CFG), datamodule=dm, optimizer=pstep.make_optimizer(lr=LR),
                  max_epochs=2, ema_decay=0.9, seed=3, device="cpu", verbose=False)
    assert one._maybe_cache_train_data() is None  # streamed
    one.fit()
    for k, v in one.state.net.state_dict().items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), atol=1e-5, err_msg=k)
    np.testing.assert_allclose([m["train_loss"] for m in got["history"]],
                               [m["train_loss"] for m in one.metrics_history], rtol=1e-6)


def test_plain_ddp_mean_of_local_means_misses(runs):
    """The reduction a DDP wrapper makes (every rank's loss normalised by its
    own mask count, the gradients averaged) is not the global loss."""
    ranks, ref, _, _ = runs
    got = ranks[0]["plain-ddp"]["losses"]
    j_losses = ref["plain"]["jax"][0]
    assert abs(got[0] - j_losses[0]) > 1e-3 * abs(j_losses[0])


def test_fsdp_two_ranks_equal_dp_and_shard_every_leaf_jax_shards(runs):
    ranks, _, cases, _ = runs
    _ranks_agree(ranks, "fsdp")
    fs, dp = ranks[0]["fsdp"], ranks[0]["dp-plain"]
    np.testing.assert_allclose(fs["losses"], dp["losses"], rtol=1e-3, atol=1e-5)
    for k, v in dp["params"].items():
        np.testing.assert_allclose(fs["params"][k].numpy(), v.numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    for a, b in zip(fs["ema"], dp["ema"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-5)
    for a, b in zip(fs["exp_avg"], dp["exp_avg"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-5)
    # the placement: JAX's fsdp_spec over the flax leaves, read in the port's names
    jm = JaxModel(**CFG)
    flax = state_dict_from_flax(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), jm.init(jax.random.PRNGKey(0))["params"]))
    spec = {}
    for k in flax:
        shape = tuple(flax[k].shape)
        transposed = k.rpartition(".")[2] in ("weight", "weight_v") and len(shape) == 2
        spec[k] = any(fsdp_spec(shape[::-1] if transposed else shape, 2))
    names = [n for n, _ in PortModel(**CFG).init(device="cpu").named_parameters()]
    assert sum(spec.values()) >= 0.5 * len(spec)  # most leaves shard at W=2
    for r in range(2):
        got = ranks[r]["fsdp"]
        for i, n in enumerate(names):
            whole = fs["params"][n].numel()
            for held in (got["held"][i], got["ema_held"][i], got["moment_held"][i]):
                assert (held < whole) if spec[n] else (held == whole), (r, n, held, whole)


def test_rank_split_sampling_equals_local(runs):
    ranks, _, _, _ = runs
    for r in range(2):
        split, local = ranks[r]["sample"]["split"], ranks[r]["sample"]["local"]
        assert split.shape == local.shape == (8, N, 3)
        np.testing.assert_allclose(split.numpy(), local.numpy(), atol=1e-4)
        assert float(local.abs().max()) > 0.1
    assert torch.equal(ranks[0]["sample"]["split"], ranks[1]["sample"]["split"])


def test_rank_split_em_sampling_equals_local(runs):
    """Euler-Maruyama rank-split: each rank draws every step's noise for the
    whole batch and keeps its rows, so the split sample is one process's."""
    ranks, _, _, _ = runs
    for r in range(2):
        split, local = ranks[r]["sample-em"]["split"], ranks[r]["sample-em"]["local"]
        assert split.shape == local.shape == (8, N, 3)
        np.testing.assert_allclose(split.numpy(), local.numpy(), atol=1e-4)
        assert float(local.abs().max()) > 0.1
    assert torch.equal(ranks[0]["sample-em"]["split"], ranks[1]["sample-em"]["split"])


@pytest.mark.parametrize("strategy", ["dp", "fsdp"])
def test_two_rank_checkpoints_resume_and_load_in_one_process(runs, strategy):
    ranks, _, cases, arrays = runs
    case = next(c for c in cases if c["name"] == f"trainer-{strategy}")
    r0, r1 = ranks[0][f"trainer-{strategy}"], ranks[1][f"trainer-{strategy}"]
    assert r0["straight"]["artifacts_dir"] is not None and r1["straight"]["artifacts_dir"] is None
    tol = dict(rtol=0, atol=1e-5) if strategy == "dp" else dict(rtol=1e-3, atol=1e-5)
    straight, resumed = r0["straight"], r0["resumed"]
    assert straight["step"] == resumed["step"] == 4 * (48 // B)
    for k, v in straight["params"].items():
        np.testing.assert_allclose(resumed["params"][k].numpy(), v.numpy(), **tol, err_msg=k)
        np.testing.assert_allclose(r1["straight"]["params"][k].numpy(), v.numpy(), atol=0)
    # one process at the same global batch
    from tests.helpers.torch_parallel_worker import Arrays

    dm = Arrays(arrays, B)
    dm.setup()
    model = PortModel(**CFG)
    one = Trainer(model=model, datamodule=dm, optimizer=pstep.make_optimizer(lr=LR),
                  max_epochs=4, ema_decay=0.9, seed=3, device="cpu", verbose=False)
    one.fit()
    for k, v in one.state.net.state_dict().items():
        np.testing.assert_allclose(straight["params"][k].numpy(), v.numpy(), **tol, err_msg=k)
    for a, b in zip(straight["ema"], one.state.ema_params):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)
    hist = [m["val_loss"] for m in straight["history"]]
    np.testing.assert_allclose(hist, [m["val_loss"] for m in one.metrics_history], rtol=1e-5)
    # only rank 0 wrote: one last.pt, one best checkpoint, one log
    run_dir = os.path.join(case["dir"], "straight")
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == ["last.pt", "val_loss"]
    assert len(os.listdir(os.path.join(run_dir, "checkpoints", "val_loss"))) == 1
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        assert len(f.readlines()) == 4
    # the files load into one process unchanged
    fresh = Trainer(model=model, datamodule=dm, optimizer=pstep.make_optimizer(lr=LR),
                    ckpt_dir=os.path.join(run_dir, "checkpoints"), seed=3, device="cpu",
                    verbose=False)
    fresh.test(ckpt="last")
    for k, v in straight["params"].items():
        assert torch.equal(fresh.state.net.state_dict()[k], v), k
    for a, b in zip(fresh.state.ema_params, straight["ema"]):
        assert torch.equal(a, b)
