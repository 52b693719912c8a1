"""PyTorch port, pipeline parallelism (parallel/pp.py; trainer.strategy=pp
and dp_pp) on the CPU, held against the JAX package's
`particle_fm_tpu/parallel/pp.py`.

The ranks are threads here: a `PipeAxis` whose hops are queues and whose
broadcast waits at a barrier, and the step's sums over the ranks (the
gradients over every rank, the loss over the data group) taken the same
way, so the port's own `pipeline_step_body` runs on S (or D x S) threads in
lockstep. The same schedule over gloo processes runs in the four-rank launch
of tests/test_torch_parallel_model_axis.py, whose tests hold it against
these threads (pytest-xdist gives each file a worker of its own, so a second
file reading that launch would start a second one).

The model is tests/test_pp.py's `_droid` (model_dim 32, 4 layers, 4 heads,
12 particles, cond 2) with the sincos time embedding (the jitted JAX step
rounds the cosine ladder otherwise than the port:
tests/test_torch_parallel_model_axis.py), every leaf of JAX's initial
state re-drawn and carried by utils/from_jax.py, ragged masks, and t and
the noise pinned to the same arrays on every side.

- The pipelined field equals the module (JAX's `test_pp_forward_matches_module`
  shapes) and JAX's `make_pp_vector_field` (2e-5, JAX's tolerance).
- Each rank's gradients are its part only (a layer's on its stage, the
  output embedder's and final norm's on the last stage, the node
  embedder's on stage 0), and their sum is one process's gradient: the
  embedders are not counted S times.
- `pp` at S=4, M=4 and `dp_pp` at (data 2, pipe 2), M=2 against JAX's
  `make_train_step_pp` on the virtual CPU mesh for 3 AdamW steps: losses
  1e-5 relative, first gradients within 1e-5 of the largest, parameters
  and EMA within Adam's reach with 99% within 1e-5; the ranks bit-equal.
- JAX's refusals with JAX's exception types, and the port's limit on pp's
  world (ROADMAP.md Queue 3 item 16).
- One process (S = 1) trains pp through the training CLI, writes a
  checkpoint and resumes from it.
"""

from __future__ import annotations

import copy
import functools
import glob
import json
import os
import queue
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.losses import flow_matching as jloss
from particle_fm_tpu.models.flow_matching import FlowMatchingModel as JaxModel
from particle_fm_tpu.parallel import train as jtrain
from particle_fm_tpu.parallel.mesh import replicate
from particle_fm_tpu.parallel.pp import make_pipe_mesh, make_pp_vector_field, make_train_step_pp
from particle_fm_tpu_torch.losses import flow_matching as ploss
from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel as PortModel
from particle_fm_tpu_torch.parallel import pp
from particle_fm_tpu_torch.parallel.dist import BatchShard
from particle_fm_tpu_torch.training import step as pstep
from particle_fm_tpu_torch.training import trainer as ptrainer
from particle_fm_tpu_torch.training.trainer import Trainer
from particle_fm_tpu_torch.utils.from_jax import state_dict_from_flax
from tests.torch_port_helpers import filled, grads_by_name

STEPS, LR, B, N = 3, 1e-3, 8, 12
LOSS_RTOL = GRAD_TOL = PARAM_TOL = 1e-5
QUANTILE = 0.99
FWD_TOL = 2e-5  # tests/test_pp.py's tolerance of the pipelined forward


def droid(num_layers: int = 4, cond_dim: int = 2, **kw) -> dict:
    """tests/test_pp.py's `_droid`, with sincos time."""
    return dict(dict(
        model="droid_fulltransformer", features=3, num_particles=N, frequencies=4,
        t_emb="sincos", add_time_to_input=True, loss_type="FM-OT", global_cond_dim=cond_dim,
        net_config=dict(
            te_config=dict(model_dim=32, num_layers=num_layers,
                           mha_config=dict(num_heads=4, do_layer_norm=True),
                           dense_config=dict(act_h="lrlu", nrm="layer")),
            node_embd_config=dict(act_h="lrlu", nrm="layer"),
            ctxt_embd_config=dict(outp_dim=16, act_h="lrlu", nrm="layer"),
            outp_embd_config=dict(act_h="lrlu", nrm="layer"))), **kw)


DROID = droid()


def batch(b: int = B, seed: int = 0, cond_dim: int = 2, masked: bool = True):
    """A ragged numpy batch (x, mask, cond)."""
    rs = np.random.RandomState(seed)
    real = rs.randint(N // 3, N + 1, size=(b, 1)) if masked else np.full((b, 1), N)
    mask = (np.arange(N)[None, :] < real).astype(np.float32)[..., None]
    x = rs.randn(b, N, 3).astype(np.float32) * mask
    cond = rs.randn(b, cond_dim).astype(np.float32) if cond_dim else None
    return x, mask, cond


@functools.lru_cache(maxsize=None)
def _jax_initial(key: str):
    cfg = json.loads(key)
    jm = JaxModel(**cfg)
    return jm, filled(jax.jit(jm.init)(jax.random.PRNGKey(0))["params"], 0, 0.1)


def initial(cfg: dict):
    """(jax model, its initial parameters with every leaf re-drawn, the port's
    network holding them)."""
    jm, params = _jax_initial(json.dumps(cfg, sort_keys=True))
    net = PortModel(**cfg).init(device="cpu")
    net.load_state_dict(dict(net.state_dict(), **state_dict_from_flax(params)))
    return jm, params, net


def port_net(cfg: dict, seed: int = 0):
    """The port's network with every parameter re-drawn (no JAX side)."""
    net = PortModel(**cfg).init(device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return net


# ------------------------------------------------------------- thread ranks
class Threads:
    """W ranks as threads: a sum over a group of them, every member taking
    the same sum (in rank order), and pipe axes over groups of them."""

    def __init__(self, world: int):
        self.world, self.lock, self.board, self.barriers = world, threading.Lock(), {}, {}
        self.queues = {}
        self.local = threading.local()

    def barrier(self, members) -> threading.Barrier:
        with self.lock:
            return self.barriers.setdefault(tuple(members), threading.Barrier(len(members)))

    def sum(self, t: torch.Tensor, members) -> torch.Tensor:
        me, wait = self.local.rank, self.barrier(members)
        self.board[(tuple(members), me)] = t.detach().clone()
        wait.wait(timeout=60)
        out = self.board[(tuple(members), members[0])].clone()
        for r in members[1:]:
            out += self.board[(tuple(members), r)]
        wait.wait(timeout=60)
        return out

    def axis(self, ranks: list[int], stage: int) -> pp.PipeAxis:
        me = ranks[stage]
        with self.lock:
            for a in ranks:
                for b in ranks:
                    self.queues.setdefault((a, b), queue.Queue())

        def send(t, j):
            self.queues[(me, ranks[j])].put(t.detach().clone())

        def recv(buf, j):
            return buf.copy_(self.queues[(ranks[j], me)].get(timeout=60))

        def broadcast(t, j):
            return t.copy_(self.sum(t if ranks[j] == me else torch.zeros_like(t), ranks))

        return pp.PipeAxis(stage, len(ranks), send, recv, broadcast)

    def run(self, fn) -> list:
        """fn(rank) on every rank's thread; their results."""
        out, errors = [None] * self.world, []

        def run(r):
            self.local.rank = r
            try:
                out[r] = fn(r)
            except BaseException as e:  # noqa: BLE001 - surfaced below
                errors.append(e)
                for b in self.barriers.values():
                    b.abort()

        threads = [threading.Thread(target=run, args=(r,)) for r in range(self.world)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        if errors:
            raise errors[0]
        assert not any(th.is_alive() for th in threads)
        return out


def layout(world: int, stages: int, rank: int):
    """(data coordinate, stage, the pipeline's ranks, the data group's ranks)
    of a rank on the (data, pipe) layout: rank r at (r // S, r % S)."""
    d, s = divmod(rank, stages)
    return d, s, [d * stages + j for j in range(stages)], list(range(s, world, stages))


def thread_steps(cfg, net0, batches, t_arr, z_arr, stages, data, microbatches, monkeypatch):
    """Every rank's first loss and gradients and its STEPS steps of
    `pipeline_step_body` on D x S threads."""
    world = stages * data
    threads = Threads(world)
    monkeypatch.setattr(ploss, "_sample_t", lambda _g, size, device: torch.from_numpy(t_arr.copy()))
    monkeypatch.setattr(ploss, "_normal", lambda _g, shape, device: torch.from_numpy(z_arr.copy()))
    monkeypatch.setattr(pstep.dist, "world_size", lambda: world)
    monkeypatch.setattr(pstep.dist, "all_reduce_tensors_", lambda ts, group=None: [
        threads.sum(t, list(range(world))) for t in ts])
    model = PortModel(**cfg)

    def rank(r):
        d, s, pipe_ranks, data_ranks = layout(world, stages, r)
        axis = threads.axis(pipe_ranks, s)
        shard = (None if data == 1 else
                 BatchShard(d, data, lambda t: threads.sum(t, data_ranks)))
        opt = pstep.make_optimizer(lr=LR)
        state = pstep.create_train_state(model, opt, device="cpu")
        state.net.load_state_dict(net0.state_dict())
        state.ema_params = [p.detach().clone() for p in state.net.parameters()]

        def mine(a):
            a = torch.from_numpy(a)
            return a if shard is None else shard.local(a)

        local = [tuple(mine(a) for a in bt) for bt in batches]
        loss, grads = pstep.pipelined_loss_and_grads(model, state.net, torch.Generator(),
                                                     *local[0], axis, microbatches, shard)
        step = pstep.make_train_step(model, opt, ema_decay=0.9, shard=shard, pipe=axis,
                                     microbatches=microbatches)
        losses = [float(step(state, torch.Generator(), *bt)) for bt in local]
        sd = state.state_dict()
        return {"first_loss": float(loss), "first_grads": [g.clone() for g in grads],
                "losses": losses, "params": {k: v.clone() for k, v in sd["params"].items()},
                "ema": [e.clone() for e in sd["ema_params"]], "step": state.step}

    return threads.run(rank)


def jax_steps(jm, params, batches, t_arr, z_arr, stages, data, microbatches, monkeypatch):
    """JAX's first loss and gradients (pipelined) and its STEPS steps of
    `make_train_step_pp` on the virtual CPU mesh."""
    monkeypatch.setattr(jloss, "_sample_t", lambda _r, size, _w: jnp.asarray(t_arr))
    monkeypatch.setattr(jloss, "_normal", lambda _r, shape, _w: jnp.asarray(z_arr))
    mesh = (make_pipe_mesh(stages=stages, with_data_axis=True) if data == 1
            else make_pipe_mesh(stages=stages, data=data))
    jopt = jtrain.make_optimizer(lr=LR)
    state = replicate(jtrain.TrainState(
        params=params, norm_stats={}, ema_params=jax.tree_util.tree_map(jnp.copy, params),
        opt_state=jopt.init(params), step=jnp.zeros((), jnp.int32)), mesh)
    vf = make_pp_vector_field(jm, mesh, microbatches=microbatches)

    def loss_fn(p, x, m, c):
        return jm.loss({"params": p}, jax.random.PRNGKey(0), x, mask=m, cond=c, train=True,
                       vf_fn=vf)[0]

    first_loss, first = jax.jit(jax.value_and_grad(loss_fn))(state.params, *batches[0])
    step = make_train_step_pp(jm, jopt, mesh, microbatches=microbatches, ema_decay=0.9)
    losses = []
    for bt in batches:
        state, loss = step(state, jax.random.PRNGKey(0), *bt)
        losses.append(float(loss))
    state = jax.device_get(state)
    return {"first_loss": float(first_loss), "first_grads": grads_by_name(first),
            "losses": losses, "params": state_dict_from_flax(state.params),
            "ema": state_dict_from_flax(state.ema_params)}


def held_to_tolerance(got: dict, want: dict, names, what: str, tol: float = PARAM_TOL):
    """Every entry within Adam's reach of STEPS steps, QUANTILE of them within tol."""
    diffs = np.concatenate([np.abs(np.asarray(got[n]) - np.asarray(want[n])).ravel()
                            for n in names])
    assert diffs.max() <= 2 * STEPS * LR, f"{what}: {diffs.max()} beyond Adam's reach"
    assert np.quantile(diffs, QUANTILE) <= tol, (what, np.quantile(diffs, QUANTILE))


def check_against(ranks: list[dict], want: dict, names: list[str], what: str) -> None:
    """The ranks bit-equal, and rank 0 within the bounds of `want` (JAX's
    run, or a thread run as flat lists and dicts)."""
    got = ranks[0]
    for r, other in enumerate(ranks[1:], 1):
        assert other["losses"] == got["losses"], (what, r)
        for k, v in got["params"].items():
            assert torch.equal(other["params"][k], v), (what, r, k)
        for a, b in zip(other["ema"], got["ema"]):
            assert torch.equal(a, b), (what, r)
    np.testing.assert_allclose(got["first_loss"], want["first_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    want_grads = want["first_grads"]
    if isinstance(want_grads, list):
        want_grads = dict(zip(names, (g.numpy() for g in want_grads)))
    scale = max(float(np.abs(g).max()) for g in want_grads.values())
    for n, g in zip(names, got["first_grads"]):
        err = float(np.abs(g.numpy() - want_grads[n]).max())
        assert err <= GRAD_TOL * scale, f"{what} first gradient {n}: {err} against {scale}"
    assert got["step"] == STEPS
    held_to_tolerance({n: got["params"][n].numpy() for n in names},
                      {n: np.asarray(want["params"][n]) for n in names}, names,
                      f"{what} parameters")
    want_ema = want["ema"]
    if isinstance(want_ema, list):
        want_ema = dict(zip(names, (e.numpy() for e in want_ema)))
    held_to_tolerance({n: e.numpy() for n, e in zip(names, got["ema"])}, want_ema, names,
                      f"{what} EMA")


# ------------------------------------------------------------------ forward
def thread_forward(net, stages, microbatches, t, x, cond, mask):
    threads = Threads(stages)

    def rank(r):
        field = pp.PipelinedField(net, threads.axis(list(range(stages)), r), microbatches)
        with torch.no_grad():
            return field(t, x, cond, mask)

    return threads.run(rank)


@pytest.mark.parametrize("stages,microbatches,num_layers", [(4, 4, 4), (2, 8, 4), (8, 2, 8),
                                                            (4, 4, 8)])
def test_pipelined_forward_matches_module(stages, microbatches, num_layers):
    net = port_net(droid(num_layers=num_layers))
    x, mask, cond = (torch.from_numpy(a) for a in batch(seed=1))
    t = torch.full((B,), 0.35)
    with torch.no_grad():
        ref = net(t, x, cond=cond, mask=mask)
    outs = thread_forward(net, stages, microbatches, t, x, cond, mask)
    for out in outs:  # every stage holds the last stage's output
        assert torch.equal(out, outs[-1])
    np.testing.assert_allclose(outs[0].numpy(), ref.numpy(), atol=FWD_TOL)
    assert float(ref.abs().max()) > 0.1


def test_pipelined_forward_uncond_unmasked_matches_jax():
    """cond None, no padding: JAX's `test_pp_forward_uncond_unmasked`
    against the JAX package's pipelined field on a 4-stage mesh."""
    cfg = droid(cond_dim=0)
    jm, params, net = initial(cfg)
    x, mask, _ = batch(seed=2, cond_dim=0, masked=False)
    t = np.full((B,), 0.7, np.float32)
    vf = make_pp_vector_field(jm, make_pipe_mesh(stages=4), microbatches=2)
    ref = np.asarray(jax.jit(vf)({"params": params}, jnp.asarray(t), jnp.asarray(x), None,
                                 jnp.asarray(mask)))
    outs = thread_forward(net, 4, 2, torch.from_numpy(t), torch.from_numpy(x), None,
                          torch.from_numpy(mask))
    np.testing.assert_allclose(outs[0].numpy(), ref, atol=FWD_TOL)


def test_each_rank_holds_only_its_part_and_the_sum_is_one_process(monkeypatch):
    """The factor-of-S guard: a layer's gradient on its stage only, the head's
    on the last stage, the node embedder's on stage 0, the context
    embedder's on every stage (each its own uses); summed, one process's."""
    _, _, net = initial(DROID)
    x, mask, cond = (torch.from_numpy(a) for a in batch(seed=3))
    t_arr = np.random.RandomState(4).rand(B).astype(np.float32)
    z_arr = np.random.RandomState(5).randn(B, N, 3).astype(np.float32)
    monkeypatch.setattr(ploss, "_sample_t", lambda _g, size, device: torch.from_numpy(t_arr))
    monkeypatch.setattr(ploss, "_normal", lambda _g, shape, device: torch.from_numpy(z_arr))
    model = PortModel(**DROID)
    loss = model.loss(net, torch.Generator(), x, mask, cond, train=True)
    want = torch.autograd.grad(loss, list(net.parameters()))
    threads, stages = Threads(4), 4

    def rank(r):
        local = copy.deepcopy(net)
        field = pp.PipelinedField(local, threads.axis(list(range(stages)), r), 4)
        got = model.loss(local, torch.Generator(), x, mask, cond, train=True, field=field)
        field.backward(got)
        return float(got.detach()), {n: (torch.zeros_like(p) if p.grad is None else p.grad)
                            for n, p in local.named_parameters()}

    parts = threads.run(rank)
    assert all(p[0] == parts[0][0] for p in parts)  # the same loss on every stage
    np.testing.assert_allclose(parts[0][0], float(loss), rtol=1e-6)
    names = [n for n, _ in net.named_parameters()]
    scale = max(float(g.abs().max()) for g in want)
    for n, g in zip(names, want):
        nonzero = [r for r in range(stages) if float(parts[r][1][n].abs().max()) > 0]
        if ".te.layer_" in n:
            assert nonzero == [int(n.split(".te.layer_")[1].split(".")[0])], (n, nonzero)
        elif ".outp_embd." in n or ".te.final_norm." in n:
            assert nonzero == [stages - 1], (n, nonzero)
        elif ".node_embd." in n:
            assert nonzero == [0], (n, nonzero)
        total = sum(parts[r][1][n] for r in range(stages))
        assert float((total - g).abs().max()) <= GRAD_TOL * scale, n


CASES = {"pp": (4, 1, 4), "dp_pp": (2, 2, 2)}  # strategy: (stages, data, microbatches)


@pytest.mark.parametrize("strategy", list(CASES))
def test_pipeline_step_equals_jax_make_train_step_pp(strategy, monkeypatch):
    stages, data, microbatches = CASES[strategy]
    jm, params, net = initial(DROID)
    batches = [batch(seed=20 + i) for i in range(STEPS)]
    rs = np.random.RandomState(5)
    t_arr, z_arr = rs.rand(B).astype(np.float32), rs.randn(B, N, 3).astype(np.float32)
    want = jax_steps(jm, params, batches, t_arr, z_arr, stages, data, microbatches, monkeypatch)
    ranks = thread_steps(DROID, net, batches, t_arr, z_arr, stages, data, microbatches,
                         monkeypatch)
    names = [n for n, _ in net.named_parameters()]
    check_against(ranks, want, names, strategy)
    assert max(float((ranks[0]["params"][n] - p).abs().max())
               for n, p in net.named_parameters()) > 100 * PARAM_TOL


# ----------------------------------------------------------------- refusals
@pytest.mark.parametrize("cfg,kw,error,match", [
    (dict(droid(), model="epic", net_config={}), {}, NotImplementedError, "droid transformer"),
    (droid(n_transforms=2), {}, NotImplementedError, "n_transforms=1"),
    (droid(t_emb="gaussian"), {}, NotImplementedError, "parameter-free"),
    (droid(self_cond=True), {}, ValueError, "self_cond"),
    (DROID, {"accumulate_grad_batches": 2}, ValueError, "accumulate_grad_batches"),
    (droid(num_layers=3), {"model_axis_size": 2}, ValueError, "divisible by pipeline stages"),
    (DROID, {"pp_microbatches": 3}, ValueError, "microbatches\\*data"),
    (DROID, {"model_axis_size": 3, "strategy": "dp_pp"}, ValueError, "divisible by model_axis"),
    (DROID, {"model_axis_size": 1, "strategy": "pp", "world": 4}, ValueError,
     "use strategy=dp_pp.*Queue 3 item 16"),
], ids=["epic", "n_transforms", "gaussian", "self_cond", "accumulation", "layers", "batch",
        "dp_pp-world", "pp-world"])
def test_pipeline_refusals_as_jax(monkeypatch, cfg, kw, error, match):
    """The Trainer's checks as a group of two ranks makes them (emulated;
    the batch of 8 over 3 microbatches for the batch check)."""
    kw = dict(kw)
    world = kw.pop("world", 2)
    monkeypatch.setattr(ptrainer.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(ptrainer.dist, "world_size", lambda: world)
    monkeypatch.setattr(ptrainer, "make_mesh", lambda m: pytest.fail("checks passed"))
    dm = type("DM", (), {"batch_size": B})()
    kw.setdefault("strategy", "pp")
    kw.setdefault("model_axis_size", 2)
    with pytest.raises(error, match=match):
        Trainer(model=PortModel(**cfg), datamodule=dm, optimizer=pstep.make_optimizer(),
                device="cpu", **kw)


def test_pipelined_loss_refuses_self_cond_and_one_process_needs_one_stage():
    model = PortModel(**droid(self_cond=True))
    net = model.init(device="cpu")
    x, mask, cond = (torch.from_numpy(a) for a in batch())
    with pytest.raises(ValueError, match="self_cond"):
        model.loss(net, torch.Generator(), x, mask, cond, train=True,
                   field=pp.PipelinedField(net, pp.single_stage(), 2))
    with pytest.raises(ValueError, match="divisible by model_axis_size"):
        Trainer(model=PortModel(**DROID), datamodule=None, optimizer=pstep.make_optimizer(),
                strategy="pp", model_axis_size=2, device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        pp.PipelinedField(net, pp.single_stage(), 3)(torch.zeros(B), x, cond, mask)


# ------------------------------------------------------------- one process
CLI = ["experiment=jetnet/fm_tops150_cond", "model=fm_droid_transformer", "trainer=smoke",
       "device=cpu", "data.synthetic=true", "data.synthetic_num_jets=161", "data.batch_size=16",
       "model.net_config.te_config.model_dim=16", "model.net_config.te_config.num_layers=2",
       "model.net_config.te_config.mha_config.num_heads=4",
       "model.net_config.ctxt_embd_config.outp_dim=8", "model.frequencies=4",
       "model.scheduler.name=constant", "callbacks=none", "trainer.max_epochs=2"]


@pytest.fixture
def one_thread():
    """One intra-op thread: the microbatches' many small products each open a
    parallel region, which stalls for seconds when the test run's workers
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_one_process_pp_trains_through_the_cli_and_resumes(tmp_path, one_thread):
    """pp with one stage (one process: S = 1, 4 microbatches) trains through
    train.py as one process's dp does (the microbatches' gradients summed in
    another order: Adam's reach, 99% of the entries within 1e-5) and resumes
    from its checkpoint."""
    from particle_fm_tpu_torch import train as ptrain

    pipe = ["trainer.strategy=pp", "trainer.model_axis_size=1", "trainer.pp_microbatches=4"]
    metrics, objs = ptrain.main(CLI + pipe + [f"output_dir={tmp_path / 'pp'}"])
    trainer = objs["trainer"]
    assert trainer.pipe is not None and trainer.pipe.size == 1
    assert trainer.per_step_reason.startswith("the pipeline")
    _, plain = ptrain.main(CLI + [f"output_dir={tmp_path / 'dp'}"])
    diffs = np.concatenate([(p - q).abs().detach().numpy().ravel() for p, q in zip(
        trainer.state.params(), plain["trainer"].state.params())])
    assert diffs.max() <= 2 * trainer.state.step * LR and np.quantile(diffs, QUANTILE) <= 1e-5
    last = glob.glob(os.path.join(str(tmp_path / "pp"), "*", "checkpoints", "last.pt"))
    assert len(last) == 1
    sd = torch.load(last[0], weights_only=True)
    resumed, objs2 = ptrain.main(CLI[:-1] + pipe + ["trainer.max_epochs=3", f"ckpt_path={last[0]}",
                                                f"output_dir={tmp_path / 'resumed'}"])
    assert objs2["trainer"].state.step > sd["step"] and np.isfinite(resumed["train_loss"])
    assert np.isfinite(metrics["train_loss"]) and np.isfinite(metrics["val_loss"])
