"""One rank of the port's multi-process tests (tests/test_torch_parallel_multiproc.py).

    RANK=r WORLD_SIZE=W MASTER_ADDR=localhost MASTER_PORT=p LOCAL_RANK=r \
        python tests/helpers/torch_parallel_worker.py <workdir>

Reads `<workdir>/setup.pt` (written by the test: a list of cases with
numpy arrays and the port's state dicts), joins the gloo process group,
runs every case on the CPU and writes `<workdir>/rank<r>.pt` with each
case's results. Imports torch and the port only.

Cases:
  train    `steps` optimizer steps of `training/step.py` on this rank's rows
           of the global batches, strategy dp (replicated state, summed
           gradients) or fsdp (parallel/fsdp.py), t and the noise pinned to
           the case's arrays at the global batch's shape; the global loss
           of each step, the whole state after, the elements each rank
           holds of every parameter. `plain_ddp` takes the mean of the
           ranks' local-mean losses instead (what a DDP wrapper computes).
  trainer  `Trainer.fit` on an in-memory datamodule with checkpoints: a run
           of `epochs` and (unless `resume` is False) a run of `epochs // 2`
           resumed to `epochs`; the parameters and EMA of both and the
           checkpoint directory. `streamed`: the batches streamed from the
           host instead of the device cache.
  sample   rank-split `FlowMatchingModel.sample` against the local one.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from particle_fm_tpu_torch.data.base import ArrayDataModule, Split
from particle_fm_tpu_torch.losses import flow_matching as ploss
from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel
from particle_fm_tpu_torch.parallel import dist
from particle_fm_tpu_torch.parallel.dist import BatchShard
from particle_fm_tpu_torch.parallel.fsdp import local_view, shard_state_fsdp
from particle_fm_tpu_torch.training import step as pstep
from particle_fm_tpu_torch.training.trainer import Trainer


def pin(t_arr: np.ndarray, z_arr: np.ndarray) -> None:
    """Every loss call draws these arrays (at the global batch's shape)."""

    def sample_t(_g, size, device):
        assert (size,) == t_arr.shape, (size, t_arr.shape)
        return torch.from_numpy(t_arr.copy()).to(device)

    def normal(_g, shape, device):
        assert tuple(shape) == z_arr.shape, (shape, z_arr.shape)
        return torch.from_numpy(z_arr.copy()).to(device)

    ploss._sample_t, ploss._normal = sample_t, normal


def new_state(case) -> pstep.TrainState:
    model = FlowMatchingModel(**case["cfg"])
    state = pstep.create_train_state(model, pstep.make_optimizer(lr=case["lr"]), device="cpu")
    state.net.load_state_dict(case["params"])
    state.ema_params = [p.detach().clone() for p in state.net.parameters()]
    return model, state


def rows(a: np.ndarray, axis: int = 0) -> torch.Tensor:
    sl = dist.local_rows(a.shape[axis])
    return torch.from_numpy(np.ascontiguousarray(a[sl] if axis == 0 else a[:, sl]))


def run_train(case) -> dict:
    draws = ploss._sample_t, ploss._normal
    try:
        return _train(case)
    finally:
        ploss._sample_t, ploss._normal = draws


def _train(case) -> dict:
    if case.get("plain_ddp"):  # the same draws, this rank's rows of them
        sl = dist.local_rows(len(case["t"]))
        pin(case["t"][sl], case["z"][sl])
    else:
        pin(case["t"], case["z"])
    model, state = new_state(case)
    dist.broadcast_(list(state.net.parameters()) + list(state.net.buffers()) + state.ema_params)
    if case["strategy"] == "fsdp":
        state = shard_state_fsdp(state)
    accum = case.get("accum", 1)
    if case.get("plain_ddp"):
        # the DDP wrapper's reduction: each rank's loss over its own rows
        # (normalised by its own mask count), the gradients averaged
        def step(state, gen, x, m, c):
            loss = model.loss(state.net, gen, x, mask=m, cond=c, train=True)
            grads = pstep._grads(loss, state.params())
            loss, *grads = dist.all_reduce_tensors_([loss.detach()] + grads)
            grads = [g / dist.world_size() for g in grads]
            pstep.begin_run(state, state_opt, 1)  # a run of one step of the update
            pstep._apply(state, state_opt, grads, loss, 0.9, 1, 0)
            state.step += 1
            return loss / dist.world_size()
        state_opt = pstep.make_optimizer(lr=case["lr"])
    else:
        step = pstep.make_train_step(model, pstep.make_optimizer(lr=case["lr"]), ema_decay=0.9,
                                     accum=accum, shard=BatchShard.of_group())
    losses = []
    for x, m, c in case["batches"]:
        axis = 1 if accum > 1 else 0
        losses.append(float(step(state, torch.Generator(), rows(x, axis), rows(m, axis),
                                 rows(c, axis))))
    sd = state.state_dict()
    return {"losses": losses, "params": {k: v.clone() for k, v in sd["params"].items()},
            "ema": [e.clone() for e in sd["ema_params"]],
            "exp_avg": [s["exp_avg"].clone() for s in sd["opt_state"]["state"].values()],
            "step": state.step,
            "held": [local_view(p).numel() for p in state.net.parameters()],
            "ema_held": [e.numel() for e in state.ema_params],
            "moment_held": [local_view(state.opt_state.state[p]["exp_avg"]).numel()
                            for p in state.net.parameters()]}


class Arrays(ArrayDataModule):
    """In-memory splits; `streamed`: batched on the host and streamed, as a
    split too large for the device cache is."""

    def __init__(self, arrays, batch_size, streamed: bool = False):
        super().__init__(batch_size=batch_size, device_cacheable=not streamed)
        self.arrays = arrays

    def setup(self):
        self.train = Split(*self.arrays["train"])
        self.val = Split(*self.arrays["val"])


def run_trainer(case) -> dict:
    model = FlowMatchingModel(**case["cfg"])
    opt = pstep.make_optimizer(lr=case["lr"])
    out = {}
    runs = (("straight", case["epochs"], False), ("resumed", case["epochs"] // 2, True))
    for name, first, resume in runs[:2 if case.get("resume", True) else 1]:
        dm = Arrays(case["arrays"], case["batch_size"], case.get("streamed", False))
        dm.setup()
        run_dir = os.path.join(case["dir"], name)
        trainer = Trainer(model=model, datamodule=dm, optimizer=opt, max_epochs=first,
                          ema_decay=0.9, ckpt_dir=os.path.join(run_dir, "checkpoints"),
                          log_dir=run_dir, logger_backends=("jsonl",), save_last_every_n_epoch=1,
                          strategy=case["strategy"], seed=3, device="cpu", verbose=False,
                          **case.get("trainer_kw", {}))
        trainer.fit()
        if resume:
            trainer = Trainer(model=model, datamodule=dm, optimizer=opt,
                              max_epochs=case["epochs"], ema_decay=0.9,
                              ckpt_dir=os.path.join(run_dir, "checkpoints"), log_dir=run_dir,
                              save_last_every_n_epoch=1, strategy=case["strategy"], seed=3,
                              device="cpu", verbose=False, **case.get("trainer_kw", {}))
            trainer.fit(resume_from=os.path.join(run_dir, "checkpoints", "last.pt"))
        sd = trainer.state.state_dict()
        out[name] = {"params": sd["params"], "ema": sd["ema_params"], "step": sd["step"],
                     "history": [{k: v for k, v in m.items() if k != "epoch_time"}
                                 for m in trainer.metrics_history],
                     "artifacts_dir": trainer.artifacts_dir}
    return out


def run_sample(case) -> dict:
    model = FlowMatchingModel(**case["cfg"])
    net = model.init(seed=0, device="cpu")
    net.load_state_dict(case["params"])
    mask, cond = torch.from_numpy(case["mask"]), torch.from_numpy(case["cond"])
    out = {}
    for name, split in (("split", True), ("local", False)):
        gen = torch.Generator().manual_seed(7)
        out[name] = model.sample(net, gen, cond=cond, mask=mask,
                                 ode_solver=case.get("solver", "midpoint"),
                                 ode_steps=case["ode_steps"], rank_split=split)
    return out


RUNNERS = {"train": run_train, "trainer": run_trainer, "sample": run_sample}


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
