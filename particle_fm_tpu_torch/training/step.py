"""Train and eval steps, single device; counterpart of particle_fm_tpu/parallel/train.py.

One optimisation step is: the loss of the unfolded network, its gradients
by autograd, global-norm clipping, AdamW, the EMA update gated on the step
counter before its increment, and the increment. `state.step` counts
optimizer steps; with gradient accumulation one step takes several
microbatches.

Clipping is optax's `clip_by_global_norm`: the gradients are scaled by
max_norm / norm only when norm >= max_norm (`torch.nn.utils.clip_grad_norm_`
divides by norm + 1e-6 always, so it is not used). AdamW is
`torch.optim.AdamW`, which computes optax `adamw`'s update: the decay
decoupled and applied to every parameter, eps outside the square root,
bias correction by the step count. The learning rate of an update is the
schedule at the number of optimizer steps taken before it.

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
from particle_fm_tpu_torch.training.ema import ema_update


@dataclasses.dataclass
class TrainState:
    """The network (it holds the parameters), their EMA twin in the order of
    `net.parameters()`, the AdamW state and the optimizer step count;
    `sharding` (parallel/fsdp.py::FSDPSharding) when the state is sharded
    over ranks, where the EMA twin holds this rank's shards."""

    net: nn.Module
    ema_params: list[torch.Tensor]
    opt_state: torch.optim.AdamW
    step: int = 0
    sharding: object = None

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
        (then every rank must call)."""
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
        return torch.optim.AdamW(params, lr=self.lr_at(0), betas=(self.b1, self.b2),
                                 eps=self.eps, weight_decay=self.weight_decay)

    def update(self, opt: torch.optim.AdamW, params: list[nn.Parameter],
               grads: list[torch.Tensor], step: int, sharding=None) -> None:
        """Clip `grads`, then one AdamW step at lr(step) on `params`; sharded
        gradients are clipped by the norm over every rank's shards."""
        if self.grad_clip is not None and sharding is None:
            clip_by_global_norm_(grads, self.grad_clip)
        elif self.grad_clip is not None:
            local = [local_view(g) for g in grads]
            clip_by_global_norm_(local, self.grad_clip, norm=sharding.global_norm(local))
        for p, g in zip(params, grads, strict=True):
            p.grad = g
        for group in opt.param_groups:
            group["lr"] = self.lr_at(step)
        opt.step()
        opt.zero_grad(set_to_none=True)


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
    loss, *grads = dist.all_reduce_tensors_([loss] + grads)
    return loss, grads


def _apply(state: TrainState, optimizer: Optimizer, grads, ema_decay, ema_every_n,
           ema_start_step) -> None:
    params = state.params()
    optimizer.update(state.opt_state, params, grads, state.step, sharding=state.sharding)
    if state.sharding is not None:
        params = [local_view(p) for p in params]
    ema_update(state.ema_params, params, state.step, decay=ema_decay, every_n=ema_every_n,
               start_step=ema_start_step)
    state.step += 1


def _loss_kw(shard: BatchShard | None) -> dict:
    return {} if shard is None else {"shard": shard}


def _build_step_fn(model, optimizer: Optimizer, ema_decay: float = 0.999,
                   ema_every_n: int = 1, ema_start_step: int = 0,
                   shard: BatchShard | None = None) -> Callable:
    """step(state, generator, x, mask, cond) -> loss; updates `state` in
    place. With a `shard`, x is this rank's rows and the loss returned is the
    global batch's."""

    def step_fn(state: TrainState, generator: torch.Generator, x, mask, cond) -> torch.Tensor:
        loss = model.loss(state.net, generator, x, mask=mask, cond=cond, train=True,
                          **_loss_kw(shard))
        if state.sharding is not None:
            state.sharding.backward(loss)
            loss, grads = state.sharding.reduced_grads(state.params(), loss)
        else:
            loss, grads = _summed(loss.detach(), _grads(loss, state.params()), shard)
        _apply(state, optimizer, grads, ema_decay, ema_every_n, ema_start_step)
        return loss

    return step_fn


def _build_accum_step_fn(model, optimizer: Optimizer, ema_decay: float = 0.999,
                         ema_every_n: int = 1, ema_start_step: int = 0,
                         shard: BatchShard | None = None) -> Callable:
    """step(state, generator, xs, ms, cs) -> loss, the data with a leading
    microbatch axis (A, B, ...): the A microbatch gradients, one after the
    other, averaged with the weights `model.loss_accum_weight` (each
    microbatch's normalisation mass, so the average is the big-batch
    gradient), then one optimizer and EMA update. The microbatches draw from
    `generator` in turn. With a `shard` the weights are the global
    microbatches' masses and the ranks' sums are reduced once, after the
    last microbatch."""

    def step_fn(state: TrainState, generator: torch.Generator, xs, ms, cs) -> torch.Tensor:
        params = state.params()
        sharding = state.sharding
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
        _apply(state, optimizer, gsum, ema_decay, ema_every_n, ema_start_step)
        return lsum / wsum

    return step_fn


def make_train_step(model, optimizer: Optimizer, ema_decay: float = 0.999,
                    ema_every_n: int = 1, ema_start_step: int = 0, accum: int = 1,
                    shard: BatchShard | None = None) -> Callable:
    """The train step; with `accum` > 1 the accumulation step."""
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
