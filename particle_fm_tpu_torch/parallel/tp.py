"""Tensor and expert parallelism over the model axis; counterpart of
particle_fm_tpu/parallel/tp.py (`epic_tp_rules`, `moe_ep_rules`,
`shard_state`).

The JAX package places parameters on the 'model' mesh axis by rules and
lets GSPMD partition the step. The port places the same parameters on the
ranks of the model group (parallel/mesh.py) and gives the modules that own
them sharded forms, with the collectives written out:

- `epic` (trainer.strategy=dp_tp), Megatron on the EPiC local MLPs: the
  first (`fc_local1` of each EPiCLayer, `fc_l1` of the EPiCEncoder) is
  column-parallel, each model rank owning H/model of its output features
  (the rows of v (out, in), their `g` and bias: its weight norm is local);
  the second (`fc_local2`, `fc_l2`) is row-parallel, each rank owning the
  input columns of v that read its part of the first's output. Its weight
  norm runs over the whole input axis, so the ranks' squared norms are
  summed in the same all-reduce as the partial products
  (nets/common.py::WNDenseSplit): one all-reduce a layer. The encoder's
  residual after `fc_l2` reads `fc_l1`'s output whole: one all-gather.
- `moe` (trainer.strategy=dp_ep): each model rank holds E/model contiguous
  experts of every ExpertChoiceMoE (`w1`, `b1`, `w2`, `b2` split on their
  expert axis), computes their share of the combine and sums it over the
  model group (nets/moe.py); the router stays replicated.

A placement splits a parameter only where the axis divides evenly
(`tp.py:88-110` of the JAX package); a pair of EPiC layers is split only
where H divides, and a model whose rules split nothing raises (the port
never quietly trains as dp). Where JAX splits `fc_local2`'s kernel evenly
over its whole concatenated input (the time-embedding rows, the H particle
rows and the local-cond rows together), the port splits the H particle
columns and keeps the per-set columns whole on every rank, aligned with
`fc_local1`'s columns: the placement differs, the numbers do not
(ROADMAP.md Queue 3).

`shard_state_tp` places the parameters, their EMA twin and the AdamW
moments by these rules and keeps the normalisers' statistics and the step
replicated; the state's `ModelSharding` computes the clip's global norm (the
squares of the split entries summed over the model group, those of the
replicated ones, the per-set columns of a row-parallel weight among them,
counted once) and gathers the single-process checkpoint format
(`full_state_dict`), as parallel/fsdp.py does.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

from particle_fm_tpu_torch.nets.epic import EPiCEncoder, EPiCLayer
from particle_fm_tpu_torch.nets.moe import ExpertChoiceMoE
from particle_fm_tpu_torch.parallel.mesh import ROADMAP_ITEM, ModelAxis

RULES = ("epic", "moe")
STRATEGY_RULES = {"dp_tp": "epic", "dp_ep": "moe"}
EPIC_PAIRS = ((EPiCLayer, "fc_local1", "fc_local2"), (EPiCEncoder, "fc_l1", "fc_l2"))
EXPERT_PARAMS = ("w1", "b1", "w2", "b2")


@dataclasses.dataclass(frozen=True)
class Placement:
    """A parameter split over the model axis on `dim`, in the part
    [start, start + length) of that dimension (the rest whole on every
    rank)."""

    dim: int
    start: int
    length: int

    def local(self, full: torch.Tensor, rank: int, size: int) -> torch.Tensor:
        """This rank's entries of the whole tensor."""
        k = self.length // size
        lo = self.start + rank * k
        parts = [full.narrow(self.dim, 0, self.start), full.narrow(self.dim, lo, k),
                 full.narrow(self.dim, self.start + self.length,
                             full.shape[self.dim] - self.start - self.length)]
        return torch.cat([p for p in parts if p.shape[self.dim]], dim=self.dim).clone()

    def split_part(self, local: torch.Tensor, size: int) -> torch.Tensor:
        """The entries of a rank's tensor that are this rank's alone (the
        rest is whole on every rank)."""
        return local.narrow(self.dim, self.start, self.length // size)

    def rest_parts(self, local: torch.Tensor, size: int) -> list[torch.Tensor]:
        """The entries of a rank's tensor that are whole on every rank."""
        k = self.length // size
        rest = local.shape[self.dim] - self.start - k
        return [p for p in (local.narrow(self.dim, 0, self.start),
                            local.narrow(self.dim, self.start + k, rest)) if p.numel()]

    def whole(self, local: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
        """The whole tensor from every rank's entries (every rank calls)."""
        k = self.length // axis.size
        rest = local.shape[self.dim] - self.start - k
        mid = axis.all_gather(local.narrow(self.dim, self.start, k), self.dim)
        parts = [local.narrow(self.dim, 0, self.start), mid,
                 local.narrow(self.dim, self.start + k, rest)]
        return torch.cat([p for p in parts if p.shape[self.dim]], dim=self.dim)

    def indices(self, shape, rank: int, size: int) -> list[range]:
        """The index ranges, one a dimension, of this rank's entries."""
        k = self.length // size
        out = [range(n) for n in shape]
        d = out[self.dim]
        out[self.dim] = [i for i in d if not self.start <= i < self.start + self.length] + \
            list(range(self.start + rank * k, self.start + (rank + 1) * k))
        return out


def _weight_name(dense) -> str:
    return "weight_v" if dense.use_weight_norm else "weight"


def split_modules(net: nn.Module, rules: str, size: int) -> dict[str, object]:
    """The modules the rules split over `size` model ranks, by name:
    ("column" | "row", module) for the EPiC pairs, ("experts", module) for
    the MoE blocks."""
    if rules not in RULES:
        raise ValueError(f"unknown rules {rules!r} (expected {' | '.join(RULES)})")
    out = {}
    for name, mod in net.named_modules():
        prefix = f"{name}." if name else ""
        if rules == "epic":
            for cls, col, row in EPIC_PAIRS:
                if isinstance(mod, cls) and getattr(mod, col).features % size == 0:
                    out[prefix + col] = ("column", getattr(mod, col))
                    out[prefix + row] = ("row", getattr(mod, row))
        elif isinstance(mod, ExpertChoiceMoE) and mod.num_experts % size == 0:
            out[name] = ("experts", mod)
    return out


def placements(net: nn.Module, rules: str, size: int) -> dict[str, Placement | None]:
    """Every parameter's placement under the rules (None: replicated)."""
    out = {name: None for name, _ in net.named_parameters()}
    for name, (kind, mod) in split_modules(net, rules, size).items():
        if kind == "experts":
            for p in EXPERT_PARAMS:
                out[f"{name}.{p}"] = Placement(0, 0, getattr(mod, p).shape[0])
        elif kind == "column":
            h = mod.features
            out[f"{name}.{_weight_name(mod)}"] = Placement(0, 0, h)
            for p in ("g", "bias"):
                if f"{name}.{p}" in out:
                    out[f"{name}.{p}"] = Placement(0, 0, h)
        else:
            start, length = _particle_columns(mod)
            out[f"{name}.{_weight_name(mod)}"] = Placement(1, start, length)
    return out


def _particle_columns(dense) -> tuple[int, int]:
    """(start, width) of the one per-particle segment of a split Dense."""
    col, found = 0, None
    for k, kind in dense.segments:
        if kind == "particle":
            if found is not None:
                raise NotImplementedError("a row-parallel Dense reads one per-particle input")
            found = (col, k)
        col += k
    return found


class ModelSharding:
    """How a TrainState is split over the model axis: each parameter's
    placement (None: replicated), the axis, and a host copy of the whole
    network to build whole networks from. The gradients come from autograd
    (`owns_backward` False: the step sums them over the data group)."""

    owns_backward = False

    def __init__(self, net: nn.Module, template: nn.Module, placed: list, axis: ModelAxis):
        self.net, self.template, self.placed, self.axis = net, template, placed, axis
        self.names = [name for name, _ in net.named_parameters()]

    def global_norm(self, local_grads: list[torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole gradients: the squares of the split
        entries summed over the model group, plus the squares of the
        replicated ones (whole parameters, and the per-set columns of a
        row-parallel weight), counted once."""
        split, once = [], []
        for g, pl in zip(local_grads, self.placed):
            if pl is None:
                once.append(g)
            else:
                split.append(pl.split_part(g, self.axis.size))
                once.extend(pl.rest_parts(g, self.axis.size))
        sq = self.axis.all_reduce(torch.sum(torch.stack(torch._foreach_norm(split)) ** 2))
        if once:
            sq = sq + torch.sum(torch.stack(torch._foreach_norm(once)) ** 2)
        return torch.sqrt(sq)

    def _whole(self, t: torch.Tensor, pl: Placement | None) -> torch.Tensor:
        return t if pl is None else pl.whole(t, self.axis)

    def full_params(self, state) -> dict[str, torch.Tensor]:
        """The network's state dict, every parameter whole."""
        by_name = dict(zip(self.names, self.placed))
        return {k: self._whole(v, by_name.get(k)) for k, v in state.net.state_dict().items()}

    def full_state_dict(self, state) -> dict:
        """The single-device checkpoint format (training/step.py::TrainState)."""
        opt = state.opt_state.state_dict()
        opt["state"] = {i: {k: (self._whole(v, self.placed[i]) if v.dim() else v)
                            for k, v in s.items()} for i, s in opt["state"].items()}
        return {"params": self.full_params(state),
                "ema_params": [self._whole(e, pl) for e, pl in zip(state.ema_params, self.placed)],
                "opt_state": opt, "step": state.step}

    def full_network(self, state, ema: bool) -> nn.Module:
        """A whole copy of the network on this rank's device, with the EMA
        weights when `ema`, else the live ones; every rank must call."""
        sd = self.full_params(state)
        if ema:
            for name, e, pl in zip(self.names, state.ema_params, self.placed):
                sd[name] = self._whole(e, pl)
        net = copy.deepcopy(self.template).to(next(iter(sd.values())).device)
        net.load_state_dict(sd)
        return net


def shard_state_tp(state, axis: ModelAxis, rules: str):
    """Split a TrainState in place over the model axis by the rules (params,
    EMA twin, AdamW moments; buffers and step replicated) and give the
    modules their sharded forms; returns it. A model the rules split
    nothing of raises."""
    net = state.net
    mods = split_modules(net, rules, axis.size)
    if not mods:
        what = ("EPiC local MLPs whose width divides" if rules == "epic"
                else "mixture-of-experts blocks whose expert count divides")
        raise NotImplementedError(
            f"the {rules} rules split no parameter of this model over {axis.size} model ranks: "
            f"it has no {what} (the port trains dp_tp on the EPiC model and dp_ep on "
            f"te_config.moe_config, {ROADMAP_ITEM})")
    template = copy.deepcopy(net).cpu()
    by_name = placements(net, rules, axis.size)
    params = list(net.parameters())
    placed = [by_name[name] for name, _ in net.named_parameters()]
    opt = state.opt_state
    with torch.no_grad():
        for i, (p, pl) in enumerate(zip(params, placed)):
            if pl is None:
                continue
            p.data = pl.local(p.data, axis.rank, axis.size)
            state.ema_params[i] = pl.local(state.ema_params[i], axis.rank, axis.size)
            for k, v in opt.state.get(p, {}).items():
                if v.dim():
                    opt.state[p][k] = pl.local(v, axis.rank, axis.size)
    for kind, mod in mods.values():
        if kind == "experts":
            mod.shard_experts(axis)
        else:
            mod.shard(kind, axis)
    state.sharding = ModelSharding(net, template, placed, axis)
    return state
