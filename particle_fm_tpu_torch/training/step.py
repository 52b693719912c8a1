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
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable

import torch
from torch import nn

from particle_fm_tpu_torch.training.ema import ema_update


@dataclasses.dataclass
class TrainState:
    """The network (it holds the parameters), their EMA twin in the order of
    `net.parameters()`, the AdamW state and the optimizer step count."""

    net: nn.Module
    ema_params: list[torch.Tensor]
    opt_state: torch.optim.AdamW
    step: int = 0

    def params(self) -> list[nn.Parameter]:
        return list(self.net.parameters())

    def ema_network(self) -> nn.Module:
        """A copy of the network that holds the EMA weights (for sampling)."""
        net = copy.deepcopy(self.net)
        with torch.no_grad():
            for p, e in zip(net.parameters(), self.ema_params):
                p.copy_(e)
        return net

    def state_dict(self) -> dict:
        return {"params": self.net.state_dict(), "ema_params": list(self.ema_params),
                "opt_state": self.opt_state.state_dict(), "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        self.net.load_state_dict(sd["params"])
        with torch.no_grad():
            for e, saved in zip(self.ema_params, sd["ema_params"], strict=True):
                e.copy_(saved)
        self.opt_state.load_state_dict(sd["opt_state"])
        self.step = int(sd["step"])


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g / norm * max_norm where the
    global norm is at least max_norm, g unchanged below it."""
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
               grads: list[torch.Tensor], step: int) -> None:
        """Clip `grads`, then one AdamW step at lr(step) on `params`."""
        if self.grad_clip is not None:
            clip_by_global_norm_(grads, self.grad_clip)
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


def _apply(state: TrainState, optimizer: Optimizer, grads, ema_decay, ema_every_n,
           ema_start_step) -> None:
    params = state.params()
    optimizer.update(state.opt_state, params, grads, state.step)
    ema_update(state.ema_params, params, state.step, decay=ema_decay, every_n=ema_every_n,
               start_step=ema_start_step)
    state.step += 1


def _build_step_fn(model, optimizer: Optimizer, ema_decay: float = 0.999,
                   ema_every_n: int = 1, ema_start_step: int = 0) -> Callable:
    """step(state, generator, x, mask, cond) -> loss; updates `state` in place."""

    def step_fn(state: TrainState, generator: torch.Generator, x, mask, cond) -> torch.Tensor:
        loss = model.loss(state.net, generator, x, mask=mask, cond=cond, train=True)
        grads = _grads(loss, state.params())
        _apply(state, optimizer, grads, ema_decay, ema_every_n, ema_start_step)
        return loss.detach()

    return step_fn


def _build_accum_step_fn(model, optimizer: Optimizer, ema_decay: float = 0.999,
                         ema_every_n: int = 1, ema_start_step: int = 0) -> Callable:
    """step(state, generator, xs, ms, cs) -> loss, the data with a leading
    microbatch axis (A, B, ...): the A microbatch gradients, one after the
    other, averaged with the weights `model.loss_accum_weight` (each
    microbatch's normalisation mass, so the average is the big-batch
    gradient), then one optimizer and EMA update. The microbatches draw from
    `generator` in turn."""

    def step_fn(state: TrainState, generator: torch.Generator, xs, ms, cs) -> torch.Tensor:
        params = state.params()
        gsum = [torch.zeros_like(p) for p in params]
        wsum = lsum = None
        for i in range(xs.shape[0]):
            x, m = xs[i], None if ms is None else ms[i]
            c = None if cs is None else cs[i]
            loss = model.loss(state.net, generator, x, mask=m, cond=c, train=True)
            w = model.loss_accum_weight(x, m)
            torch._foreach_add_(gsum, torch._foreach_mul(_grads(loss, params), w))
            wsum = w if wsum is None else wsum + w
            lsum = w * loss.detach() if lsum is None else lsum + w * loss.detach()
        torch._foreach_div_(gsum, wsum)
        _apply(state, optimizer, gsum, ema_decay, ema_every_n, ema_start_step)
        return lsum / wsum

    return step_fn


def make_train_step(model, optimizer: Optimizer, ema_decay: float = 0.999,
                    ema_every_n: int = 1, ema_start_step: int = 0, accum: int = 1) -> Callable:
    """The train step; with `accum` > 1 the accumulation step."""
    build = _build_accum_step_fn if accum > 1 else _build_step_fn
    return build(model, optimizer, ema_decay=ema_decay, ema_every_n=ema_every_n,
                 ema_start_step=ema_start_step)


def make_eval_step(model) -> Callable:
    """eval_step(state, generator, x, mask, cond) -> loss on the current
    (not the EMA) parameters."""

    @torch.no_grad()
    def eval_step(state: TrainState, generator: torch.Generator, x, mask, cond) -> torch.Tensor:
        return model.loss(state.net, generator, x, mask=mask, cond=cond, train=False)

    return eval_step
