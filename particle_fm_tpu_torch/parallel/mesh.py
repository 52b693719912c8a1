"""The (data, model) process mesh and the collectives over its model axis;
counterpart of particle_fm_tpu/parallel/mesh.py's 2-D mesh.

The JAX package reshapes the devices to (data, model) and lets GSPMD insert
the collectives of tensor, sequence and expert parallelism. The port runs
one process a rank, W = data x model of them: rank r sits at (r // model,
r % model), as `reshape(data, model)` places devices. Its data group holds
the ranks of one model coordinate (they hold different rows of each global
batch), its model group the ranks of one data coordinate (they hold the
same rows and split the work of the model axis).

`ModelAxis` is what the networks are handed: this rank's coordinate on the
model axis, its size, and two collectives over the model group, a sum and
a gather; a test may emulate them (two threads in lockstep). The autograd
functions below are the model axis's five differentiable forms:

- `copy_to`: identity forward, sum backward (Megatron's f: the input of a
  column-parallel layer, which every rank uses for its own columns);
- `reduce_from`: sum forward, identity backward (Megatron's g: the output
  of a row-parallel layer, or of the local experts, where every rank then
  computes the same loss);
- `gather_from`: gather forward, this rank's slice backward (a
  column-parallel output whole again, for a residual);
- `seq_reduce`: sum forward and backward (sequence parallelism: a pool over
  the particle axis, where each rank's loss is its own share, so every
  rank's pooled value reaches every rank's loss);
- `seq_gather`: gather forward, sum and slice backward (sequence
  parallelism: the tokens whose keys and values every rank's queries
  attend to).

Under sequence parallelism the networks read the model axis from a context
(`sequence_parallel`), per thread, set by the loss for the length of one
call (models/flow_matching.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable

import torch
import torch.distributed as tdist

MODEL_AXIS_RANGE = "particle_fm.model_axis"  # torch.profiler's name of a model-axis collective
ROADMAP_ITEM = "ROADMAP.md Queue 1 item 7"


def coords(rank: int, model: int) -> tuple[int, int]:
    """(data, model) coordinates of a rank, as reshape(data, model) places it."""
    return rank // model, rank % model


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This rank's coordinate on the model axis (`rank` of `size`) and the
    sum (`all_reduce`, a new tensor) and the gather (`all_gather(t, dim)`,
    the ranks' parts concatenated along dim in rank order) over its model
    group."""

    rank: int
    size: int
    all_reduce: Callable[[torch.Tensor], torch.Tensor]
    all_gather: Callable[[torch.Tensor, int], torch.Tensor]


def _group_all_reduce(group) -> Callable:
    def all_reduce(t: torch.Tensor) -> torch.Tensor:
        out = t.detach().clone()
        with torch.profiler.record_function(MODEL_AXIS_RANGE):
            tdist.all_reduce(out, op=tdist.ReduceOp.SUM, group=group)
        return out
    return all_reduce


def _group_all_gather(group, size: int) -> Callable:
    def all_gather(t: torch.Tensor, dim: int) -> torch.Tensor:
        t = t.detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(size)]
        with torch.profiler.record_function(MODEL_AXIS_RANGE):
            tdist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)
    return all_gather


@dataclasses.dataclass
class ProcessMesh:
    """The (data, model) mesh of the process group: W = data x model ranks,
    this rank's coordinates, the process group of its data coordinate's
    column (`data_group`: the ranks holding other rows) and of its row
    (`model_group`), and the `ModelAxis` over the latter."""

    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: object
    model_group: object
    axis: ModelAxis


def make_mesh(model_axis_size: int) -> ProcessMesh:
    """The mesh of the process group with `model_axis_size` ranks on the
    model axis; W % model_axis_size != 0 raises, as the JAX trainer
    refuses it. Every rank must call (it makes the groups)."""
    w = tdist.get_world_size()
    m = int(model_axis_size)
    if m < 1 or w % m:
        raise ValueError(f"the mesh needs the world size ({w}) divisible by "
                         f"trainer.model_axis_size ({m})")
    d = w // m
    me = tdist.get_rank()
    data_rank, model_rank = coords(me, m)
    data_group = model_group = None
    # every rank makes every group, in the same order
    for j in range(m):
        g = tdist.new_group([i * m + j for i in range(d)])
        if j == model_rank:
            data_group = g
    for i in range(d):
        g = tdist.new_group([i * m + j for j in range(m)])
        if i == data_rank:
            model_group = g
    axis = ModelAxis(model_rank, m, _group_all_reduce(model_group),
                     _group_all_gather(model_group, m))
    return ProcessMesh(d, m, data_rank, model_rank, data_group, model_group, axis)


# ------------------------------------------------- differentiable collectives
class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return axis.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n), None, None


class _SeqReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g), None


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return axis.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        whole = ctx.axis.all_reduce(g)
        return whole.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n), None, None


def copy_to(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return _CopyTo.apply(x, axis) if x.requires_grad else x


def reduce_from(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return _ReduceFrom.apply(x, axis)


def gather_from(x: torch.Tensor, axis: ModelAxis, dim: int = -1) -> torch.Tensor:
    return _GatherFrom.apply(x, axis, dim % x.ndim)


def seq_reduce(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return _SeqReduce.apply(x, axis)


def seq_gather(x: torch.Tensor, axis: ModelAxis, dim: int = 1) -> torch.Tensor:
    return _SeqGather.apply(x, axis, dim % x.ndim)


# ------------------------------------------------------- sequence parallelism
_local = threading.local()


def sequence_axis() -> ModelAxis | None:
    """The model axis the particles are split over in the current call, or
    None outside `sequence_parallel`."""
    return getattr(_local, "seq", None)


@contextlib.contextmanager
def sequence_parallel(axis: ModelAxis | None):
    """Inside the block the networks see this rank's particles of every set,
    the others on the other ranks of `axis` (None: no change)."""
    if axis is None:
        yield
        return
    prev = sequence_axis()
    _local.seq = axis
    try:
        yield
    finally:
        _local.seq = prev


def refuse_under_sp(what: str) -> None:
    """Raise where a network that couples particles across the split runs
    under sequence parallelism."""
    if sequence_axis() is not None:
        raise NotImplementedError(
            f"trainer.strategy='sp' is not ported for {what} ({ROADMAP_ITEM}); sp runs the "
            "EPiC model and the full transformer without experts")
