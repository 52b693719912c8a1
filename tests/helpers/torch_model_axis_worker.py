"""One rank of the port's (data, model) mesh tests (tests/test_torch_parallel_model_axis.py).

    RANK=r WORLD_SIZE=4 MASTER_ADDR=localhost MASTER_PORT=p LOCAL_RANK=r \
        python tests/helpers/torch_model_axis_worker.py <workdir>

Reads `<workdir>/setup.pt` (a list of cases with numpy arrays and the
port's state dicts), joins the gloo process group, builds the mesh of the
case's model axis, runs every case on the CPU and writes
`<workdir>/rank<r>.pt`. Imports torch and the port only.

Cases:
  train    the first gradients at the initial state (summed over the ranks
           that hold distinct data, gathered whole), then `steps` optimizer
           steps of `training/step.py` on this rank's rows of the global
           batches under the case's strategy (dp_tp, sp, dp_ep; pp and dp_pp
           with `microbatches`, the layers over the model axis as pipeline
           stages), t and the noise pinned at the global batch's shape; the
           global losses, the whole state after, and the elements this rank
           holds of every parameter, its EMA and its AdamW moments.
  trainer  `Trainer.fit` on an in-memory datamodule with checkpoints: a run
           of `epochs` and a run of `epochs // 2` resumed to `epochs`; the
           gathered states of both.
  cli      `train.main` with the case's arguments (every rank; rank 0
           writes the run): the run directory and the trainer's state.
  refuse   Trainer constructions in the group that must raise: the error
           type and message of each.
"""

from __future__ import annotations

import os
import sys

import torch

from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel
from particle_fm_tpu_torch.parallel import dist
from particle_fm_tpu_torch.parallel.dist import BatchShard
from particle_fm_tpu_torch.parallel.mesh import make_mesh
from particle_fm_tpu_torch.parallel.pp import pipe_axis
from particle_fm_tpu_torch.parallel.tp import STRATEGY_RULES, shard_state_tp
from particle_fm_tpu_torch.training import step as pstep
from particle_fm_tpu_torch.training.trainer import PIPELINE_STRATEGIES, Trainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_parallel_worker import Arrays, pin, run_trainer  # noqa: E402


def _placed(case, state):
    """The state placed by the case's strategy on a fresh mesh; the batch
    shard (None: every rank holds the whole batch) and the pipe axis (None
    but under pp and dp_pp)."""
    mesh = make_mesh(case["model_axis_size"])
    strategy = case["strategy"]
    dist.broadcast_(list(state.net.parameters()) + list(state.net.buffers()) + state.ema_params)
    if strategy in PIPELINE_STRATEGIES:
        return state, BatchShard.of_mesh(mesh) if mesh.data > 1 else None, pipe_axis(mesh)
    if strategy in STRATEGY_RULES:
        state = shard_state_tp(state, mesh.axis, STRATEGY_RULES[strategy])
    return state, BatchShard.of_mesh(mesh, sp=strategy == "sp"), None


def run_train(case) -> dict:
    from particle_fm_tpu_torch.losses import flow_matching as ploss

    draws = ploss._sample_t, ploss._normal
    try:
        pin(case["t"], case["z"])
        return _train(case)
    finally:
        ploss._sample_t, ploss._normal = draws


def _train(case) -> dict:
    model = FlowMatchingModel(**case["cfg"])
    opt = pstep.make_optimizer(lr=case["lr"])
    state = pstep.create_train_state(model, opt, device="cpu")
    state.net.load_state_dict(case["params"])
    state.ema_params = [p.detach().clone() for p in state.net.parameters()]
    state, shard, pipe = _placed(case, state)
    micro = case.get("microbatches", 8)

    def mine(a):
        rows = (slice(None) if shard is None
                else dist.local_rows(a.shape[0], shard.rank, shard.world))
        return torch.from_numpy(a[rows].copy())

    batches = [tuple(mine(a) for a in batch) for batch in case["batches"]]
    # the first gradients, whole
    if pipe is not None:
        loss, grads = pstep.pipelined_loss_and_grads(model, state.net, torch.Generator(),
                                                     *batches[0], pipe, micro, shard)
    else:
        loss = model.loss(state.net, torch.Generator(), *batches[0], train=True, shard=shard)
        grads = pstep._grads(loss, state.params())
        loss, grads = pstep._summed(loss.detach(), grads, shard)
    placed = getattr(state.sharding, "placed", [None] * len(grads))
    first = [g.clone() if pl is None else pl.whole(g, state.sharding.axis)
             for g, pl in zip(grads, placed)]
    step = pstep.make_train_step(model, opt, ema_decay=0.9, shard=shard, pipe=pipe,
                                 microbatches=micro)
    losses = [float(step(state, torch.Generator(), *batch)) for batch in batches]
    sd = state.state_dict()
    moments = [state.opt_state.state[p]["exp_avg"] for p in state.net.parameters()]
    return {"first_loss": float(loss), "first_grads": first, "losses": losses,
            "params": {k: v.clone() for k, v in sd["params"].items()},
            "ema": [e.clone() for e in sd["ema_params"]], "step": state.step,
            "held": {n: (p.numel(), e.numel(), m.numel()) for (n, p), e, m in
                     zip(state.net.named_parameters(), state.ema_params, moments)}}


def run_refuse(case) -> dict:
    out = {}
    for name, kw in case["constructions"].items():
        cfg = kw.pop("cfg")
        try:
            Trainer(model=FlowMatchingModel(**cfg), datamodule=Arrays(case["arrays"], 8),
                    optimizer=pstep.make_optimizer(), device="cpu", verbose=False, **kw)
            out[name] = None
        except Exception as e:  # noqa: BLE001 - the test reads the type and message
            out[name] = (type(e).__name__, str(e))
    return out


def run_cli(case) -> dict:
    from particle_fm_tpu_torch import train as ptrain

    _, objs = ptrain.main(case["argv"])
    sd = objs["trainer"].state.state_dict()
    return {"run_dir": objs["out_dir"], "params": sd["params"], "step": sd["step"]}


RUNNERS = {"train": run_train, "trainer": run_trainer, "cli": run_cli, "refuse": run_refuse}


def main(workdir: str) -> None:
    cases = torch.load(os.path.join(workdir, "setup.pt"), weights_only=False)
    assert dist.maybe_initialize_distributed(device="cpu")
    assert dist.backend() == "gloo"
    results = {}
    for case in cases:
        results[case["name"]] = RUNNERS[case["kind"]](case)
    torch.save(results, os.path.join(workdir, f"rank{dist.rank()}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
