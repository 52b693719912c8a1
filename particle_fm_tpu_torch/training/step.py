"""Train and eval steps, single device; counterpart of particle_fm_tpu/parallel/train.py.

One optimisation step is: the loss of the unfolded network, its gradients
by autograd, global-norm clipping, AdamW, the EMA update gated on the step
counter before its increment, and the increment. `state.step` counts
optimizer steps; with gradient accumulation one step takes several
microbatches.

The step body reads no host value that changes from step to step, so that
it can be captured in a CUDA graph and replayed (training/epochs.py): the
optimizer step count, the learning rate and the EMA gate are device values
(`StepScalars`). A run of n steps starts with `begin_run`, which writes the
device step count from `state.step` and the learning rates of the n steps
ahead, computed on the host by the schedule (training/lr_schedules.py), into
a device table; each step reads its entry at the run's device position `k`,
increments `k` and the device step count, and writes its loss into the
run's loss table. The host's `state.step` (an int, as in the checkpoints)
is advanced by the caller, never by the body. The eager step
(`make_train_step`) is a run of one step of the same body.

Clipping is optax's `clip_by_global_norm`: the gradients are scaled by
max_norm / norm only when norm >= max_norm (`torch.nn.utils.clip_grad_norm_`
divides by norm + 1e-6 always, so it is not used). AdamW is optax `adamw`'s
arithmetic in `_foreach` operations (`Optimizer.apply`): mu = (1 - b1) g +
b1 mu, nu = (1 - b2) g^2 + b2 nu, the bias corrections 1 - b^(t+1) in
float32 from the device step, u = mu_hat / (sqrt(nu_hat) + eps) + wd p, p +=
-lr u, the decay decoupled and applied to every parameter. The moments live
in a `torch.optim.AdamW` object (`exp_avg`, `exp_avg_sq`), whose
`state_dict` is the checkpoint's format; its own `step()` is not called.
The learning rate of an update is the schedule at the number of optimizer
steps taken before it.

With a bfloat16 model (`dtype`) the parameters stay float32 and so do their
gradients (autograd through the networks' casts), the accumulator, the clip,
AdamW's moments and the EMA: bfloat16 is the networks' compute type only.

Across processes (parallel/): with a `shard` (parallel/dist.py::BatchShard)
each rank computes its share of the global batch's loss on its rows, the
ranks' gradients and losses are summed in one all-reduce (the counterpart
of the JAX step's gradient all-reduce over the "data" axis), and the clip,
AdamW, the EMA and the increment then run identically on every rank. With
accumulation the sum is taken once per optimizer step. A state sharded by
parallel/fsdp.py (`state.sharding`) takes its gradients from FSDP2's
backward (reduce-scattered) and its clip norm over every rank's shards; the
EMA and AdamW then update each rank's shards.

On a (data, model) mesh (parallel/mesh.py) the sum runs over the ranks that
hold distinct data (the shard's `group`): under dp_tp and dp_ep every model
rank computes the same loss on the same rows, so every gradient, sharded or
replicated, is summed over the data group; under sp each rank's loss is its
own share, so the sum runs over every rank. A state split by parallel/tp.py
(`ModelSharding`) clips by the norm whose sharded squares are summed over
the model group and whose replicated ones count once.

With a pipe axis (`pipe`, parallel/pp.py: pp and dp_pp) the state stays
replicated; the loss runs the pipelined field and its backward pipeline
leaves each rank's part of every gradient in `.grad` (a layer's on its
stage, the embedders' where they were used), so the gradients are summed
over every rank in one all-reduce, the pipe ranks' parts and the data
ranks' rows at once; the loss, the same on the stages of a pipeline, is
summed over the data group only. There is no accumulation under a pipe
axis, as in JAX (the pipeline microbatches already).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable

import torch
from torch import nn

from particle_fm_tpu_torch.parallel import dist
from particle_fm_tpu_torch.parallel.dist import BatchShard
from particle_fm_tpu_torch.parallel.fsdp import local_view
from particle_fm_tpu_torch.parallel.pp import PipeAxis, PipelinedField
from particle_fm_tpu_torch.training.ema import ema_update


@dataclasses.dataclass
class StepScalars:
    """What the step body reads on the device instead of host values: the
    optimizer step count (`step`, int64), the position in the current run of
    steps (`k`, int64), each run step's learning rate (`lr`, float32) and
    loss (`losses`, float32)."""

    step: torch.Tensor
    k: torch.Tensor
    lr: torch.Tensor
    losses: torch.Tensor

    @classmethod
    def make(cls, device: torch.device, capacity: int) -> "StepScalars":
        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(step=zeros(dtype=torch.int64), k=zeros(dtype=torch.int64),
                   lr=zeros(capacity), losses=zeros(capacity))

    def at_k(self, table: torch.Tensor) -> torch.Tensor:
        """The entry of a per-run table at the current position (0-dim)."""
        return table.index_select(0, self.k.view(1)).squeeze(0)


@dataclasses.dataclass
class TrainState:
    """The network (it holds the parameters), their EMA twin in the order of
    `net.parameters()`, the AdamW state and the optimizer step count;
    `sharding` (parallel/fsdp.py::FSDPSharding, parallel/tp.py::ModelSharding)
    when the state is sharded over ranks, where the EMA twin holds this
    rank's shards; `scalars`, the
    step body's device values (not part of the checkpoint)."""

    net: nn.Module
    ema_params: list[torch.Tensor]
    opt_state: torch.optim.AdamW
    step: int = 0
    sharding: object = None
    scalars: StepScalars | None = None

    def params(self) -> list[nn.Parameter]:
        return list(self.net.parameters())

    def network_copy(self, ema: bool) -> nn.Module:
        """An unsharded copy of the network (for sampling), with the EMA
        weights when `ema`; when sharded every rank must call."""
        if self.sharding is not None:
            return self.sharding.full_network(self, ema)
        net = copy.deepcopy(self.net)
        if ema:
            with torch.no_grad():
                for p, e in zip(net.parameters(), self.ema_params):
                    p.copy_(e)
        return net

    def ema_network(self) -> nn.Module:
        """A copy of the network that holds the EMA weights (for sampling)."""
        return self.network_copy(ema=True)

    def state_dict(self) -> dict:
        """The checkpoint: every tensor whole, also when the state is sharded
        (then every rank must call). AdamW's per-parameter step count is
        `step`, as torch's AdamW keeps it."""
        for s in self.opt_state.state.values():
            s["step"] = torch.tensor(float(self.step), dtype=torch.float32)
        if self.sharding is not None:
            return self.sharding.full_state_dict(self)
        return {"params": self.net.state_dict(), "ema_params": list(self.ema_params),
                "opt_state": self.opt_state.state_dict(), "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        if self.sharding is not None:
            raise RuntimeError("restore a checkpoint before the state is sharded")
        self.net.load_state_dict(sd["params"])
        with torch.no_grad():
            for e, saved in zip(self.ema_params, sd["ema_params"], strict=True):
                e.copy_(saved)
        self.opt_state.load_state_dict(sd["opt_state"])
        self.step = int(sd["step"])


def begin_run(state: TrainState, optimizer: "Optimizer", n: int) -> StepScalars:
    """Start a run of `n` steps: the device step count from `state.step`,
    the position 0, and the learning rates of the n steps ahead."""
    device = next(state.net.parameters()).device
    sc = state.scalars
    if sc is None or sc.lr.device != device or sc.lr.numel() < n:
        sc = state.scalars = StepScalars.make(device, max(n, 64))
    lrs = torch.tensor([optimizer.lr_at(state.step + i) for i in range(n)], dtype=torch.float32)
    with torch.no_grad():
        sc.step.fill_(state.step)
        sc.k.zero_()
        sc.lr[:n].copy_(lrs, non_blocking=True)
    return sc


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         norm: torch.Tensor | None = None) -> None:
    """optax.clip_by_global_norm in place: g / norm * max_norm where the
    global norm is at least max_norm, g unchanged below it. `norm` is the
    global norm when `grads` are shards of it."""
    if norm is None:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    trigger = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(trigger, one, norm))
    torch._foreach_mul_(grads, torch.where(trigger, one, torch.full_like(norm, max_norm)))


@dataclasses.dataclass
class Optimizer:
    """Global-norm clipping, then AdamW; `lr` is a float or a function of
    the optimizer step (training/lr_schedules.py)."""

    lr: float | Callable[[int], float] = 1e-3
    weight_decay: float = 5e-5
    grad_clip: float | None = 0.5
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def lr_at(self, step: int) -> float:
        return float(self.lr(step)) if callable(self.lr) else float(self.lr)

    def init(self, params: list[nn.Parameter]) -> torch.optim.AdamW:
        """The AdamW state, its moments made now (zeros), so that they exist
        before a step is captured."""
        opt = torch.optim.AdamW(params, lr=self.lr_at(0), betas=(self.b1, self.b2),
                                eps=self.eps, weight_decay=self.weight_decay)
        for p in params:
            _moments(opt, p)
        return opt

    @torch.no_grad()
    def apply(self, opt: torch.optim.AdamW, params: list[nn.Parameter],
              grads: list[torch.Tensor], sc: StepScalars, sharding=None) -> None:
        """Clip `grads`, then one AdamW step on `params` at the run's
        learning rate and the device step count; sharded gradients are
        clipped by the norm over every rank's shards and the update runs on
        this rank's shards."""
        if self.grad_clip is not None and sharding is None:
            clip_by_global_norm_(grads, self.grad_clip)
        elif self.grad_clip is not None:
            local = [local_view(g) for g in grads]
            clip_by_global_norm_(local, self.grad_clip, norm=sharding.global_norm(local))
        moments = [_moments(opt, p) for p in params]
        mu = [local_view(m["exp_avg"]) for m in moments]
        nu = [local_view(m["exp_avg_sq"]) for m in moments]
        ps = [local_view(p) for p in params]
        gs = [local_view(g) for g in grads]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(gs, 1.0 - self.b1))
        sq = torch._foreach_mul(gs, gs)
        torch._foreach_mul_(sq, 1.0 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, sq)
        count = (sc.step + 1).to(torch.float32)
        mu_hat = torch._foreach_div(mu, 1.0 - torch.pow(self.b1, count))
        denom = torch._foreach_div(nu, 1.0 - torch.pow(self.b2, count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(mu_hat, denom)
        torch._foreach_add_(mu_hat, torch._foreach_mul(ps, self.weight_decay))
        torch._foreach_mul_(mu_hat, torch.neg(sc.at_k(sc.lr)))
        torch._foreach_add_(ps, mu_hat)


def _moments(opt: torch.optim.AdamW, p: torch.Tensor) -> dict:
    """AdamW's state of `p` (made zero where it has none yet)."""
    s = opt.state[p]
    if "exp_avg" not in s:
        s["step"] = torch.tensor(0.0, dtype=torch.float32)
        s["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        s["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    return s


def make_optimizer(lr=1e-3, weight_decay: float = 5e-5, grad_clip: float | None = 0.5,
                   b1: float = 0.9, b2: float = 0.999) -> Optimizer:
    """AdamW with global-norm clipping, the defaults of
    configs/model/flow_matching.yaml (lr 1e-3, weight decay 5e-5) and of the
    trainer configs (clip 0.5)."""
    return Optimizer(lr=lr, weight_decay=weight_decay, grad_clip=grad_clip, b1=b1, b2=b2)


def create_train_state(model, optimizer: Optimizer, seed: int = 0,
                       device: str | torch.device = "cuda") -> TrainState:
    """A fresh network from `seed` on `device`, its EMA twin a copy of it."""
    net = model.init(seed=seed, device=device)
    params = list(net.parameters())
    return TrainState(net=net, ema_params=[p.detach().clone() for p in params],
                      opt_state=optimizer.init(params))


def _grads(loss: torch.Tensor, params: list[nn.Parameter]) -> list[torch.Tensor]:
    # a parameter the loss does not reach gets a zero gradient, as under jax.grad
    return list(torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True))


def _summed(loss: torch.Tensor, grads: list[torch.Tensor], shard: BatchShard | None):
    """(loss, grads) summed over the ranks in one all-reduce (as given in one
    process)."""
    if shard is None:
        return loss, grads
    loss, *grads = dist.all_reduce_tensors_([loss] + grads, shard.group)
    return loss, grads


def _apply(state: TrainState, optimizer: Optimizer, grads, loss, ema_decay, ema_every_n,
           ema_start_step) -> torch.Tensor:
    """The update after the gradients: AdamW, the EMA, the loss written at
    the run's position, the device counters' increments."""
    sc = state.scalars
    params = state.params()
    optimizer.apply(state.opt_state, params, grads, sc, sharding=state.sharding)
    ema_update(state.ema_params, [local_view(p) for p in params], sc.step, decay=ema_decay,
               every_n=ema_every_n, start_step=ema_start_step)
    if _owns_backward(state):  # FSDP2's backward wrote them: the next one starts afresh
        for p in params:
            p.grad = None
    with torch.no_grad():
        sc.losses.index_copy_(0, sc.k.view(1), loss.detach().reshape(1).to(torch.float32))
        sc.step.add_(1)
        sc.k.add_(1)
    return loss


def _owns_backward(state: TrainState) -> bool:
    """Whether the state's sharding takes the gradients from its own
    backward (FSDP2), not from autograd.grad."""
    return state.sharding is not None and state.sharding.owns_backward


def _loss_kw(shard: BatchShard | None) -> dict:
    return {} if shard is None else {"shard": shard}


def step_body(model, optimizer: Optimizer, ema_decay: float = 0.999, ema_every_n: int = 1,
              ema_start_step: int = 0, shard: BatchShard | None = None) -> Callable:
    """body(state, generator, x, mask, cond) -> loss: one step inside a run
    (`begin_run`); updates `state`'s tensors in place and reads only device
    values. With a `shard`, x is this rank's rows and the loss returned is
    the global batch's."""

    def body(state: TrainState, generator: torch.Generator, x, mask, cond) -> torch.Tensor:
        loss = model.loss(state.net, generator, x, mask=mask, cond=cond, train=True,
                          **_loss_kw(shard))
        if _owns_backward(state):
            state.sharding.backward(loss)
            loss, grads = state.sharding.reduced_grads(state.params(), loss)
        else:
            loss, grads = _summed(loss.detach(), _grads(loss, state.params()), shard)
        return _apply(state, optimizer, grads, loss, ema_decay, ema_every_n, ema_start_step)

    return body


def pipeline_step_body(model, optimizer: Optimizer, pipe: PipeAxis, microbatches: int,
                       ema_decay: float = 0.999, ema_every_n: int = 1, ema_start_step: int = 0,
                       shard: BatchShard | None = None) -> Callable:
    """body(state, generator, x, mask, cond) -> loss: one step with the layer
    stack pipelined over `pipe` in `microbatches` microbatches (module
    docstring); with a `shard`, x is this data replica's rows."""

    def body(state: TrainState, generator: torch.Generator, x, mask, cond) -> torch.Tensor:
        loss, grads = pipelined_loss_and_grads(model, state.net, generator, x, mask, cond, pipe,
                                               microbatches, shard)
        return _apply(state, optimizer, grads, loss, ema_decay, ema_every_n, ema_start_step)

    return body


def pipelined_loss_and_grads(model, net, generator: torch.Generator, x, mask, cond,
                             pipe: PipeAxis, microbatches: int,
                             shard: BatchShard | None = None):
    """(loss, grads) of one training loss with the layer stack pipelined
    over `pipe`: the global batch's loss and every parameter's whole
    gradient, summed over the ranks (every rank calls)."""
    params = list(net.parameters())
    for p in params:
        p.grad = None
    field = PipelinedField(net, pipe, microbatches, 1 if shard is None else shard.world)
    loss = model.loss(net, generator, x, mask=mask, cond=cond, train=True, field=field,
                      **_loss_kw(shard))
    field.backward(loss)
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    for p in params:
        p.grad = None
    loss = loss.detach()
    if dist.world_size() > 1:
        grads = dist.all_reduce_tensors_(grads)
        if shard is not None:
            loss = shard.total(loss)
    return loss, grads


def accum_step_body(model, optimizer: Optimizer, ema_decay: float = 0.999,
                    ema_every_n: int = 1, ema_start_step: int = 0,
                    shard: BatchShard | None = None) -> Callable:
    """body(state, generator, xs, ms, cs) -> loss, the data with a leading
    microbatch axis (A, B, ...): the A microbatch gradients, one after the
    other, averaged with the weights `model.loss_accum_weight` (each
    microbatch's normalisation mass, so the average is the big-batch
    gradient), then one optimizer and EMA update. The microbatches draw from
    `generator` in turn. With a `shard` the weights are the global
    microbatches' masses and the ranks' sums are reduced once, after the
    last microbatch."""

    def body(state: TrainState, generator: torch.Generator, xs, ms, cs) -> torch.Tensor:
        params = state.params()
        sharding = state.sharding if _owns_backward(state) else None
        gsum = None if sharding is not None else [torch.zeros_like(p) for p in params]
        wsum = lsum = None
        n_micro = xs.shape[0]
        for i in range(n_micro):
            x, m = xs[i], None if ms is None else ms[i]
            c = None if cs is None else cs[i]
            loss = model.loss(state.net, generator, x, mask=m, cond=c, train=True,
                              **_loss_kw(shard))
            w = model.loss_accum_weight(x, m, **_loss_kw(shard))
            if sharding is not None:
                sharding.backward(w * loss, sync=i == n_micro - 1)
            else:
                torch._foreach_add_(gsum, torch._foreach_mul(_grads(loss, params), w))
            wsum = w if wsum is None else wsum + w
            lsum = w * loss.detach() if lsum is None else lsum + w * loss.detach()
        if sharding is not None:
            lsum, gsum = sharding.reduced_grads(params, lsum)
            torch._foreach_div_([local_view(g) for g in gsum], wsum)
        else:
            lsum, gsum = _summed(lsum, gsum, shard)
            torch._foreach_div_(gsum, wsum)
        return _apply(state, optimizer, gsum, lsum / wsum, ema_decay, ema_every_n,
                      ema_start_step)

    return body


def make_step_body(model, optimizer: Optimizer, ema_decay: float = 0.999, ema_every_n: int = 1,
                   ema_start_step: int = 0, accum: int = 1,
                   shard: BatchShard | None = None) -> Callable:
    """The step body; with `accum` > 1 the accumulation body."""
    build = accum_step_body if accum > 1 else step_body
    return build(model, optimizer, ema_decay=ema_decay, ema_every_n=ema_every_n,
                 ema_start_step=ema_start_step, shard=shard)


def _eager(body: Callable, optimizer: Optimizer) -> Callable:
    """step(state, generator, x, mask, cond) -> loss: a run of one step of
    `body`, then the host's step count."""

    def step_fn(state: TrainState, generator: torch.Generator, x, mask, cond) -> torch.Tensor:
        begin_run(state, optimizer, 1)
        loss = body(state, generator, x, mask, cond)
        state.step += 1
        return loss

    step_fn.body = body
    return step_fn


def _build_step_fn(model, optimizer: Optimizer, ema_decay: float = 0.999,
                   ema_every_n: int = 1, ema_start_step: int = 0,
                   shard: BatchShard | None = None) -> Callable:
    """step(state, generator, x, mask, cond) -> loss; updates `state` in
    place. With a `shard`, x is this rank's rows and the loss returned is the
    global batch's."""
    return _eager(step_body(model, optimizer, ema_decay, ema_every_n, ema_start_step, shard),
                  optimizer)


def _build_accum_step_fn(model, optimizer: Optimizer, ema_decay: float = 0.999,
                         ema_every_n: int = 1, ema_start_step: int = 0,
                         shard: BatchShard | None = None) -> Callable:
    """step(state, generator, xs, ms, cs) -> loss over (A, B, ...)
    microbatches (`accum_step_body`); updates `state` in place."""
    return _eager(accum_step_body(model, optimizer, ema_decay, ema_every_n, ema_start_step,
                                  shard), optimizer)


def make_train_step(model, optimizer: Optimizer, ema_decay: float = 0.999,
                    ema_every_n: int = 1, ema_start_step: int = 0, accum: int = 1,
                    shard: BatchShard | None = None, pipe: PipeAxis | None = None,
                    microbatches: int = 8) -> Callable:
    """The train step; with `accum` > 1 the accumulation step; with a `pipe`
    axis the pipelined step (`pipeline_step_body`)."""
    if pipe is not None:
        if accum > 1:
            raise ValueError("accumulate_grad_batches is not supported with a pipe axis")
        return _eager(pipeline_step_body(model, optimizer, pipe, microbatches, ema_decay,
                                         ema_every_n, ema_start_step, shard), optimizer)
    build = _build_accum_step_fn if accum > 1 else _build_step_fn
    return build(model, optimizer, ema_decay=ema_decay, ema_every_n=ema_every_n,
                 ema_start_step=ema_start_step, shard=shard)


def make_eval_step(model, shard: BatchShard | None = None) -> Callable:
    """eval_step(state, generator, x, mask, cond) -> loss on the current
    (not the EMA) parameters; with a `shard`, of the global batch."""

    @torch.no_grad()
    def eval_step(state: TrainState, generator: torch.Generator, x, mask, cond) -> torch.Tensor:
        loss = model.loss(state.net, generator, x, mask=mask, cond=cond, train=False,
                          **_loss_kw(shard))
        return loss if shard is None else shard.total(loss)

    return eval_step
