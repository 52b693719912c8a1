"""PyTorch port, tensor, sequence and expert parallelism across four
processes on the CPU (gloo): a (data 2, model 2) mesh, held against the JAX
package's step at the same strategy on a (2, 2) mesh of the test run's
virtual CPU devices.

Four ranks (tests/helpers/torch_model_axis_worker.py) run every case of one
setup, with t and the noise pinned to the same arrays on every side (the
jitted JAX step takes its draws once, at its trace: every side takes the
same ones every step), from the JAX package's initial state (every leaf
re-drawn, carried by utils/from_jax.py). The masks are ragged.

- dp_tp on the EPiC model (`shard_state` with `epic_tp_rules`), sp on the
  EPiC model at 15 particles (8 and 7 a rank, the last padded), sp on the
  full transformer (`shard_batch_sp`) and dp_ep on the MoE transformer
  (`moe_ep_rules`): 3 AdamW steps. The losses within 1e-5 (relative) and
  the first step's gradients within 1e-5 of the largest, summed over the
  ranks that hold distinct data and gathered whole; the parameters and EMA
  within Adam's reach (every entry within 2 x steps x lr, since AdamW
  turns a rounding-sized gradient into a step of up to lr: tests/
  test_moe.py:140 uses SGD for that reason) and 99% of them within 1e-5.
  JAX's device_put refuses 15 particles over 2 model devices, so the sp
  case at 15 takes JAX's step with the batch placed over 'data' only
  (GSPMD's sp is a placement of the same program). All four ranks agree
  bit for bit; each holds only its part of every placed parameter, of its
  EMA and of its Adam moments.
- dp_tp and dp_ep through the Trainer with checkpoints: a run resumed from
  its `last.pt` equals the uninterrupted one, both agree with one process
  at the same global batch within Adam's reach (99% of the entries within
  1e-4 after 8 steps), and a single-process
  `Trainer.test` loads rank 0's file with the ranks' gathered state.
- In the group: a model axis that does not divide the world raises
  ValueError; sp on MDMA raises naming ROADMAP Queue 1 item 7; pp over fewer
  stages than ranks raises ValueError naming dp_pp (Queue 3 item 16), and
  dp_pp over stages that do not divide the layers ValueError, as in JAX.
- The training CLI under torchrun at `trainer.strategy=dp_tp
  trainer.model_axis_size=2` (two ranks: data 1 x model 2), whose
  `last.pt` one process loads and resumes.
- Pipeline parallelism over gloo processes (parallel/pp.py): pp at S=4,
  M=4 and dp_pp at (data 2, pipe 2), M=2 on tests/test_torch_parallel_pipeline.py's
  droid transformer, 3 AdamW steps held against the same steps on threads
  (which that file holds against JAX's `make_train_step_pp`) within its
  bounds, the ranks bit-equal; pp at S=4 through the Trainer with
  checkpoints (resumed, against one process, rank 0's file loaded in one
  process); dp_pp through `train.main` on the four ranks, whose `last.pt`
  one process loads and resumes.
"""

from __future__ import annotations

import copy
import glob
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
from particle_fm_tpu.parallel.mesh import make_mesh, replicate, shard_batch, shard_batch_sp
from particle_fm_tpu.parallel.tp import epic_tp_rules, moe_ep_rules, shard_state
from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel as PortModel
from particle_fm_tpu_torch.parallel import tp
from particle_fm_tpu_torch.training import step as pstep
from particle_fm_tpu_torch.training.trainer import Trainer
from particle_fm_tpu_torch.utils.from_jax import state_dict_from_flax
from tests.test_torch_parallel_mesh import EPIC, MDMA_SMALL, MOE, TRANSFORMER
from tests.test_torch_parallel_multiproc import _arrays, _draws
from tests.test_torch_parallel_pipeline import CLI as PIPE_CLI
from tests.test_torch_parallel_pipeline import DROID, batch, check_against, droid, thread_steps
from tests.torch_port_helpers import filled, grads_by_name

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "helpers", "torch_model_axis_worker.py")
W, STEPS, LR, B = 4, 3, 1e-3, 8
LOSS_RTOL = GRAD_TOL = PARAM_TOL = 1e-5
QUANTILE = 0.99
TRAINER_TOL = 1e-4  # the Trainer's 8 steps against one process (PR 18's W=2 card gate)


def _one_layer(cfg: dict) -> dict:
    """The config with one encoder layer (the JAX compiles stay short) and
    the sincos time embedding (the jitted JAX step rounds the cosine
    ladder's products otherwise than the port, and that field is chaotic in
    t: tests/test_torch_parallel_multiproc.py)."""
    cfg = copy.deepcopy(dict(cfg, t_emb="sincos"))
    if "net_config" in cfg:
        cfg["net_config"]["te_config"]["num_layers"] = 1
    else:
        cfg["layers"] = 1
    return cfg


EPIC1, TRANSFORMER1, MOE1 = _one_layer(EPIC), _one_layer(TRANSFORMER), _one_layer(MOE)
CASES = {  # name: (strategy, config, particles)
    "dp_tp-epic": ("dp_tp", EPIC1, 16),
    "sp-epic-odd": ("sp", EPIC1, 15),
    "sp-transformer": ("sp", TRANSFORMER1, 16),
    "dp_ep-moe": ("dp_ep", MOE1, 16),
}
PIPE_CASES = {"pp": (4, 4), "dp_pp": (2, 2)}  # strategy: (stages, microbatches)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(rank=None, port=None, world=W) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    if rank is not None:
        env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
    return env


def _batches_at(n: int, seed: int = 20):
    from tests.torch_port_helpers import cloud

    return [cloud(b=B, n=n, seed=seed + i)[:3] for i in range(STEPS)]


def _initial(cfg):
    """(jax model, its initial parameters with every leaf re-drawn, the port's
    state dict of them)."""
    jm = JaxModel(**cfg)
    params = filled(jax.jit(jm.init)(jax.random.PRNGKey(0))["params"], 0, 0.1)
    sd = PortModel(**cfg).init(device="cpu").state_dict()
    sd.update(state_dict_from_flax(params))
    return jm, params, sd


def _jax_run(strategy, jm, params, batches, t_arr, z_arr, mp):
    """JAX's first loss and gradients and its 3 steps at the strategy on a
    (2, 2) mesh."""
    mp.setattr(jloss, "_sample_t", lambda _r, size, _w: jnp.asarray(t_arr))
    mp.setattr(jloss, "_normal", lambda _r, shape, _w: jnp.asarray(z_arr))
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:W])
    jopt = jtrain.make_optimizer(lr=LR)
    state = jtrain.TrainState(params=params, norm_stats={},
                              ema_params=jax.tree_util.tree_map(jnp.copy, params),
                              opt_state=jopt.init(params), step=jnp.zeros((), jnp.int32))
    rules = {"dp_tp": epic_tp_rules, "dp_ep": moe_ep_rules}.get(strategy)
    state = shard_state(state, mesh, rules()) if rules else replicate(state, mesh)
    sp = strategy == "sp" and batches[0][0].shape[1] % 2 == 0
    place = (lambda b: shard_batch_sp(b, mesh)) if sp else (lambda b: shard_batch(b, mesh))

    def loss_fn(p, x, m, c):
        return jm.loss({"params": p}, jax.random.PRNGKey(0), x, mask=m, cond=c, train=True)[0]

    first_loss, first = jax.jit(jax.value_and_grad(loss_fn))(state.params, *place(batches[0]))
    step = jtrain.make_train_step(jm, jopt, ema_decay=0.9, mesh=mesh, sp=sp)
    losses = []
    for batch in batches:
        state, loss = step(state, jax.random.PRNGKey(0), *place(batch))
        losses.append(float(loss))
    state = jax.device_get(state)
    return {"first_loss": float(first_loss), "first_grads": grads_by_name(first),
            "losses": losses, "params": state_dict_from_flax(state.params),
            "ema": state_dict_from_flax(state.ema_params)}


def _one_process_trainer(cfg, arrays, strategy):
    from tests.helpers.torch_parallel_worker import Arrays

    dm = Arrays(arrays, B)
    dm.setup()
    one = Trainer(model=PortModel(**cfg), datamodule=dm, optimizer=pstep.make_optimizer(lr=LR),
                  max_epochs=2, ema_decay=0.9, seed=3, device="cpu", verbose=False)
    one.fit()
    return one


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on four ranks, started first; the JAX runs while they run."""
    workdir = str(tmp_path_factory.mktemp("model_axis"))
    cases, draws, initial = [], {}, {}
    for name, (strategy, cfg, n) in CASES.items():
        key = id(cfg)
        if key not in initial:
            initial[key] = _initial(cfg)
        jm, params, sd = initial[key]
        batches = _batches_at(n)
        t_arr, z_arr = _draws(batches[0][0].shape)
        draws[name] = (jm, params, batches, t_arr, z_arr)
        cases.append(dict(kind="train", name=name, cfg=cfg, params=sd, batches=batches,
                          t=t_arr, z=z_arr, lr=LR, strategy=strategy, model_axis_size=2))
    pipe_batches = [batch(seed=20 + i) for i in range(STEPS)]
    pipe_t, pipe_z = _draws(pipe_batches[0][0].shape)
    pipe_sd = _initial(DROID)[2]
    for strategy, (stages, micro) in PIPE_CASES.items():
        cases.append(dict(kind="train", name=strategy, cfg=DROID, params=pipe_sd,
                          batches=pipe_batches, t=pipe_t, z=pipe_z, lr=LR, strategy=strategy,
                          model_axis_size=stages, microbatches=micro))
    arrays = {split: _arrays(32 if split == "train" else 16, seed)
              for split, seed in (("train", 60), ("val", 61))}
    for strategy, cfg, kw in (("dp_tp", EPIC1, {}), ("dp_ep", MOE1, {}),
                              ("pp", DROID, {"model_axis_size": 4, "pp_microbatches": 2})):
        cases.append(dict(kind="trainer", name=f"trainer-{strategy}", cfg=cfg, lr=LR,
                          arrays=arrays, batch_size=B, epochs=2, strategy=strategy,
                          trainer_kw=kw, dir=os.path.join(workdir, strategy)))
    cases.append(dict(kind="cli", name="cli-dp_pp", argv=PIPE_CLI + [
        "trainer.strategy=dp_pp", "trainer.model_axis_size=2", "trainer.pp_microbatches=2",
        f"output_dir={os.path.join(workdir, 'cli_dp_pp')}"]))
    cases.append(dict(kind="refuse", name="refuse", arrays=arrays, constructions={
        "model axis 3 of 4": dict(cfg=EPIC, strategy="dp_tp", model_axis_size=3),
        "sp on MDMA": dict(cfg=MDMA_SMALL, strategy="sp"),
        "pp over 2 stages of 4 ranks": dict(cfg=DROID, strategy="pp"),
        "dp_pp, 3 layers over 2 stages": dict(cfg=droid(num_layers=3), strategy="dp_pp")}))
    torch.save(cases, os.path.join(workdir, "setup.pt"))
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, WORKER, workdir], env=_env(r, port), cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(W)]
    try:
        mp = pytest.MonkeyPatch()
        try:
            ref = {name: _jax_run(CASES[name][0], *draws[name], mp) for name in CASES}
        finally:
            mp.undo()
        one = {s: _one_process_trainer(cfg, arrays, s) for s, cfg in (("dp_tp", EPIC1),
                                                                      ("dp_ep", MOE1),
                                                                      ("pp", DROID))}
        pipe_net = PortModel(**DROID).init(device="cpu")
        pipe_net.load_state_dict(pipe_sd)
        mp = pytest.MonkeyPatch()
        try:
            for strategy, (stages, micro) in PIPE_CASES.items():
                ref[strategy] = thread_steps(DROID, pipe_net, pipe_batches, pipe_t, pipe_z,
                                             stages, 4 // stages, micro, mp)[0]
        finally:
            mp.undo()
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
             for r in range(W)]
    return ranks, ref, one, cases


def _held_to_tolerance(got: dict, want: dict, names, what: str, steps: int = STEPS,
                       tol: float = PARAM_TOL):
    """Every entry within Adam's reach of `steps`, QUANTILE of them within `tol`."""
    diffs = np.concatenate([np.abs(np.asarray(got[n]) - np.asarray(want[n])).ravel()
                            for n in names])
    assert diffs.max() <= 2 * steps * LR, f"{what}: {diffs.max()} beyond Adam's reach"
    assert np.quantile(diffs, QUANTILE) <= tol, (what, np.quantile(diffs, QUANTILE))


@pytest.mark.parametrize("name", list(CASES))
def test_model_axis_step_equals_jax_at_the_same_strategy(runs, name):
    ranks, ref, _, _ = runs
    strategy, cfg, _ = CASES[name]
    got, want = ranks[0][name], ref[name]
    for r in range(1, W):  # every rank: the same losses and the same gathered state
        assert ranks[r][name]["losses"] == got["losses"]
        for k, v in got["params"].items():
            assert torch.equal(ranks[r][name]["params"][k], v), (r, k)
    np.testing.assert_allclose(got["first_loss"], want["first_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    names = [n for n, _ in PortModel(**cfg).init(device="cpu").named_parameters()]
    scale = max(float(np.abs(g).max()) for g in want["first_grads"].values())
    for n, g in zip(names, got["first_grads"]):
        err = float(np.abs(g.numpy() - want["first_grads"][n]).max())
        assert err <= GRAD_TOL * scale, f"first gradient {n}: {err} against {scale}"
    assert got["step"] == STEPS
    _held_to_tolerance({n: got["params"][n].numpy() for n in names}, want["params"], names,
                       f"{name} parameters")
    _held_to_tolerance({n: e.numpy() for n, e in zip(names, got["ema"])}, want["ema"], names,
                       f"{name} EMA")
    start = next(c for c in runs[3] if c["name"] == name)["params"]
    assert max(float((got["params"][n] - start[n]).abs().max()) for n in names) > 100 * PARAM_TOL


@pytest.mark.parametrize("name", ["dp_tp-epic", "dp_ep-moe", "sp-transformer"])
def test_each_rank_holds_only_its_part(runs, name):
    ranks, _, _, _ = runs
    strategy, cfg, _ = CASES[name]
    net = PortModel(**cfg).init(device="cpu")
    rules = tp.STRATEGY_RULES.get(strategy)
    placed = tp.placements(net, rules, 2) if rules else {n: None for n, _ in
                                                          net.named_parameters()}
    assert any(pl is not None for pl in placed.values()) == (rules is not None)
    for r in range(W):
        held = ranks[r][name]["held"]
        for n, p in net.named_parameters():
            for count in held[n]:  # the parameter, its EMA, its first moment
                assert (count < p.numel()) if placed[n] is not None else (count == p.numel()), \
                    (r, n, count, p.numel())


@pytest.mark.parametrize("strategy", ["pp", "dp_pp"])
def test_pipeline_over_processes_equals_the_threads(runs, strategy):
    ranks, ref, _, _ = runs
    names = [n for n, _ in PortModel(**DROID).init(device="cpu").named_parameters()]
    check_against([r[strategy] for r in ranks], ref[strategy], names, strategy)
    for r in range(W):  # the state stays replicated: every rank holds it whole
        for n, (count, ema, moment) in ranks[r][strategy]["held"].items():
            assert count == ema == moment, (r, n)


def test_dp_pp_cli_checkpoint_loads_and_resumes_in_one_process(runs, tmp_path):
    ranks, _, _, _ = runs
    got = [r["cli-dp_pp"] for r in ranks]
    assert len({g["run_dir"] for g in got}) == 1 and all(g["step"] == got[0]["step"] for g in got)
    for g in got[1:]:
        for k, v in got[0]["params"].items():
            assert torch.equal(g["params"][k], v), k
    last = os.path.join(got[0]["run_dir"], "checkpoints", "last.pt")
    sd = torch.load(last, weights_only=True)
    for k, v in got[0]["params"].items():
        assert torch.equal(sd["params"][k], v), k
    from particle_fm_tpu_torch import train as ptrain

    metrics, objs = ptrain.main(PIPE_CLI[:-1] + ["trainer.max_epochs=3", f"ckpt_path={last}",
                                            f"output_dir={tmp_path / 'resumed'}"])
    assert objs["trainer"].state.step > sd["step"] and np.isfinite(metrics["train_loss"])


@pytest.mark.parametrize("strategy", ["dp_tp", "dp_ep", "pp"])
def test_checkpoints_resume_under_the_strategy_and_load_in_one_process(runs, strategy):
    ranks, _, one, cases = runs
    case = next(c for c in cases if c["name"] == f"trainer-{strategy}")
    r0 = ranks[0][f"trainer-{strategy}"]
    straight, resumed = r0["straight"], r0["resumed"]
    assert straight["step"] == resumed["step"] == 2 * (32 // B)
    assert r0["straight"]["artifacts_dir"] is not None
    assert ranks[1][f"trainer-{strategy}"]["straight"]["artifacts_dir"] is None
    for k, v in straight["params"].items():
        np.testing.assert_allclose(resumed["params"][k].numpy(), v.numpy(), atol=1e-6, err_msg=k)
        for r in range(1, W):
            assert torch.equal(ranks[r][f"trainer-{strategy}"]["straight"]["params"][k], v)
    want = {k: v.numpy() for k, v in one[strategy].state.net.state_dict().items()}
    names = [n for n, _ in one[strategy].state.net.named_parameters()]
    _held_to_tolerance({k: v.numpy() for k, v in straight["params"].items()}, want, names,
                       f"{strategy} trainer against one process", steps=straight["step"],
                       tol=TRAINER_TOL)
    # rank 0's file in one process: the ranks' gathered state
    run_dir = os.path.join(case["dir"], "straight")
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == ["last.pt", "val_loss"]
    from tests.helpers.torch_parallel_worker import Arrays

    dm = Arrays(case["arrays"], B)
    dm.setup()
    fresh = Trainer(model=PortModel(**case["cfg"]), datamodule=dm,
                    optimizer=pstep.make_optimizer(lr=LR),
                    ckpt_dir=os.path.join(run_dir, "checkpoints"), seed=3, device="cpu",
                    verbose=False)
    fresh.test(ckpt="last")
    for k, v in straight["params"].items():
        assert torch.equal(fresh.state.net.state_dict()[k], v), k
    for a, b in zip(fresh.state.ema_params, straight["ema"]):
        assert torch.equal(a, b)


def test_model_axis_refusals_in_a_group(runs):
    got = runs[0][0]["refuse"]
    assert got["model axis 3 of 4"][0] == "ValueError"
    assert "divisible by model_axis_size (3)" in got["model axis 3 of 4"][1]
    assert got["sp on MDMA"][0] == "NotImplementedError", got["sp on MDMA"]
    assert "Queue 1 item 7" in got["sp on MDMA"][1], got["sp on MDMA"]
    pp_world = got["pp over 2 stages of 4 ranks"]
    assert pp_world[0] == "ValueError" and "strategy=dp_pp" in pp_world[1], pp_world
    assert "Queue 3 item 16" in pp_world[1], pp_world
    layers = got["dp_pp, 3 layers over 2 stages"]
    assert layers[0] == "ValueError" and "divisible by pipeline stages (2)" in layers[1], layers


def test_torchrun_cli_dp_tp_writes_a_checkpoint_one_process_loads_and_resumes(tmp_path):
    from tests.test_torch_parallel_cli import CLI

    out = str(tmp_path / "tp")
    env = _env()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
         "--master_port", str(_free_port()), "-m", "particle_fm_tpu_torch.train", *CLI,
         "trainer.strategy=dp_tp", "trainer.model_axis_size=2", f"output_dir={out}"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("[train] run dir:") == 1
    runs_ = glob.glob(os.path.join(out, "*"))
    assert len(runs_) == 1, runs_
    last = os.path.join(runs_[0], "checkpoints", "last.pt")
    sd = torch.load(last, weights_only=True)
    assert sd["params"]["flows.0.net.epic_layer_0.fc_local1.weight_v"].shape[0] == 16  # whole
    from particle_fm_tpu_torch import train as ptrain
    from particle_fm_tpu_torch.utils.run_io import load_run

    _, _, _, net = load_run(runs_[0], "last", ema=True, device="cpu")
    for e, (name, p) in zip(sd["ema_params"], net.named_parameters()):
        assert torch.equal(p.detach(), e), name
    metrics, objs = ptrain.main(CLI[:-1] + ["trainer.max_epochs=3", f"ckpt_path={last}",
                                            f"output_dir={tmp_path / 'resumed'}"])
    assert objs["trainer"].state.step > sd["step"] and np.isfinite(metrics["train_loss"])
