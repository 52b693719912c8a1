"""Fully-sharded data parallelism (ZeRO-3) on FSDP2; counterpart of
particle_fm_tpu/parallel/fsdp.py.

The placement is the JAX package's rule (`fsdp_dim`, its `fsdp_spec`): each
parameter is sharded over the ranks along its largest dimension divisible
by the world size, and a parameter with no such dimension is replicated.
The rule is applied in the JAX layout: a Dense kernel (in, out) is the
port's `weight`/`weight_v` (out, in) (utils/from_jax.py), so its dimensions
are read reversed. `torch.distributed.fsdp.fully_shard` takes the sharded
parameters through its `shard_placement_fn` and leaves the replicated ones
to the step (`ignored_params`), which sums their gradients over the ranks
itself. The EMA twin and the AdamW moments are sharded as their parameter
is; the normalisers' statistics (buffers) and the step count are
replicated.

FSDP2 all-gathers the parameters before the network's forward and
reduce-scatters the gradients after its backward, summed (not averaged):
each rank's loss is its share of the global batch's loss
(parallel/dist.py), so the sum is the global gradient. The clip reads the
global norm over every rank's shards.

A sharded TrainState writes the single-device checkpoint format (every
tensor gathered whole; `full_state_dict`), so a checkpoint of W ranks loads
into one process unchanged. It is restored before it is sharded: the
Trainer restores a plain state and then calls `shard_state_fsdp`.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from particle_fm_tpu_torch.parallel import dist


def fsdp_dim(shape, n: int) -> int | None:
    """The JAX rule: the largest dimension divisible by n (the first of
    equal ones), or None (replicate)."""
    for i, d in sorted(enumerate(shape), key=lambda t: -t[1]):
        if d >= n and d % n == 0:
            return i
    return None


def param_shard_dim(name: str, shape, n: int) -> int | None:
    """The dimension of the port's parameter `name` that JAX's rule shards:
    a Dense weight (out, in) is read as the flax kernel (in, out)."""
    if name.rpartition(".")[2] in ("weight", "weight_v") and len(shape) == 2:
        d = fsdp_dim(tuple(shape)[::-1], n)
        return None if d is None else 1 - d
    return fsdp_dim(tuple(shape), n)


def _chunk(full: torch.Tensor, dim: int | None) -> torch.Tensor:
    """This rank's shard of a whole tensor (itself where it is replicated)."""
    if dim is None:
        return full
    return full.chunk(dist.world_size(), dim=dim)[dist.rank()].clone()


def _gather(local: torch.Tensor, dim: int | None) -> torch.Tensor:
    """The whole tensor from every rank's shard."""
    return local if dim is None else dist.gather_rows(local, dim)


def local_view(t: torch.Tensor) -> torch.Tensor:
    """A sharded tensor's local shard (it shares the storage); a plain
    tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


class FSDPSharding:
    """How a TrainState is sharded: each parameter's shard dimension (None:
    replicated), and a host copy of the unsharded network to build whole
    networks from (`full_network`)."""

    owns_backward = True  # the gradients come from FSDP2's backward (`reduced_grads`)

    def __init__(self, net: nn.Module, dims: list[int | None]):
        self.net = net
        self.dims = dims
        self.template = copy.deepcopy(net).cpu()
        self.names = [name for name, _ in net.named_parameters()]

    # -------------------------------------------------------------- step
    def backward(self, loss: torch.Tensor, sync: bool = True) -> None:
        """Backward of this rank's loss; the gradients are reduce-scattered
        when `sync` (the last microbatch of an optimizer step)."""
        self.net.set_requires_gradient_sync(sync)
        loss.backward()

    def reduced_grads(self, params, loss: torch.Tensor):
        """(loss summed over the ranks, the gradients): the sharded ones as
        FSDP2 reduced them, the replicated ones summed over the ranks here,
        in one collective with the loss."""
        grads = [p.grad for p in params]
        repl = [i for i, d in enumerate(self.dims) if d is None]
        out = dist.all_reduce_tensors_([loss.detach()] + [grads[i] for i in repl])
        for i, g in zip(repl, out[1:]):
            grads[i] = g
        return out[0], grads

    def global_norm(self, local_grads: list[torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole gradients from this rank's shards:
        the squares of the shards summed over the ranks, plus the squares of
        the replicated gradients."""
        sharded = [g for g, d in zip(local_grads, self.dims) if d is not None]
        repl = [g for g, d in zip(local_grads, self.dims) if d is None]
        sq = torch.zeros((), dtype=torch.float32, device=local_grads[0].device)
        if sharded:
            sq = dist.all_reduce_sum_(torch.sum(torch.stack(torch._foreach_norm(sharded)) ** 2))
        if repl:
            sq = sq + torch.sum(torch.stack(torch._foreach_norm(repl)) ** 2)
        return torch.sqrt(sq)

    # -------------------------------------------------- whole tensors
    def full_params(self, state) -> dict[str, torch.Tensor]:
        """The network's state dict, every parameter whole."""
        sd = {}
        for name, v in state.net.state_dict().items():
            sd[name] = v.full_tensor() if hasattr(v, "full_tensor") else v
        return sd

    def full_state_dict(self, state) -> dict:
        """The single-device checkpoint format (training/step.py::TrainState)."""
        opt = state.opt_state.state_dict()
        opt["state"] = {i: {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
                            for k, v in s.items()} for i, s in opt["state"].items()}
        return {"params": self.full_params(state),
                "ema_params": [_gather(e, d) for e, d in zip(state.ema_params, self.dims)],
                "opt_state": opt, "step": state.step}

    def full_network(self, state, ema: bool) -> nn.Module:
        """An unsharded copy of the network on this rank's device, with the
        EMA weights when `ema`, else the live ones; every rank must call."""
        sd = self.full_params(state)
        if ema:
            for name, e, d in zip(self.names, state.ema_params, self.dims):
                sd[name] = _gather(e, d)
        device = next(iter(sd.values())).device
        net = copy.deepcopy(self.template).to(device)
        net.load_state_dict(sd)
        return net


def shard_state_fsdp(state):
    """Shard a TrainState in place over the process group's ranks (params,
    EMA twin, AdamW moments by the JAX rule; buffers and step replicated);
    returns it. The network is wrapped by `fully_shard`, the optimizer is
    made anew over the sharded parameters with its moments sharded."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import DTensor, Shard

    net = state.net
    n = dist.world_size()
    params = list(net.parameters())
    names = [name for name, _ in net.named_parameters()]
    dims = [param_shard_dim(name, p.shape, n) for name, p in zip(names, params)]
    sharding = FSDPSharding(net, dims)
    by_param = {p: d for p, d in zip(params, dims)}
    old_opt = state.opt_state
    old_moments = [old_opt.state.get(p, {}) for p in params]
    fully_shard(net, shard_placement_fn=lambda p: Shard(by_param[p]),
                ignored_params={p for p, d in by_param.items() if d is None})
    net.set_gradient_divide_factor(1.0)
    net.set_force_sum_reduction_for_comms(True)
    new_params = list(net.parameters())
    opt = type(old_opt)(new_params)
    for group, old in zip(opt.param_groups, old_opt.param_groups, strict=True):
        group.update({k: v for k, v in old.items() if k != "params"})
    for p, d, moments in zip(new_params, dims, old_moments):
        if not moments:
            continue
        opt.state[p] = {
            k: (DTensor.from_local(_chunk(v, d), p.device_mesh, p.placements, run_check=False)
                if isinstance(p, DTensor) and v.dim() > 0 else v.clone())
            for k, v in moments.items()}
    state.opt_state = opt
    state.ema_params = [_chunk(e, d) for e, d in zip(state.ema_params, dims)]
    state.sharding = sharding
    return state
