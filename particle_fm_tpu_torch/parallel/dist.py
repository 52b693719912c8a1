"""Processes, ranks and the collectives of data-parallel training; the
counterpart of particle_fm_tpu/parallel/mesh.py's data axis.

The JAX package shards each global batch over the "data" axis of a device
mesh and lets XLA insert the gradient all-reduce. The port runs one process
a device, started by torchrun, each with the same program:

    torchrun --nproc_per_node=W -m particle_fm_tpu_torch.train trainer.strategy=dp ...

`maybe_initialize_distributed` starts the process group from torchrun's
environment (or `trainer.multihost=true`, or PFM_MULTIHOST=1): NCCL when
the device is CUDA, gloo on the CPU, or the backend PFM_DIST_BACKEND names
(gloo with CUDA tensors: two ranks on one card, which NCCL refuses; ranks
beyond the visible cards then share them in turn). In one
process without any of these nothing starts, and every function below
answers for a world of one.

`BatchShard` is what a loss is handed to compute this rank's part of the
global batch's loss (losses/flow_matching.py): rank r holds rows
[r*B/W, (r+1)*B/W) of the global batch B, as `shard_batch` places them;
every draw is made at the global batch's size and sliced, so W ranks see
the numbers one process draws; and the normalising sums (the mask count,
the normaliser's moments) are summed over the ranks, so each rank's loss
is its share of the global loss and the ranks' gradients add up to the
global gradient. On a (data, model) mesh (parallel/mesh.py) the rows split
over the data axis only, and under sp each set's particles over the model
axis too (`BatchShard.of_mesh`).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable

import torch
import torch.distributed as tdist

BACKEND_ENV = "PFM_DIST_BACKEND"
ALL_REDUCE_RANGE = "particle_fm.all_reduce"  # torch.profiler's name of a step's all-reduces


def _launched_by_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def maybe_initialize_distributed(enable: bool | None = None,
                                 device: str | torch.device = "cuda") -> bool:
    """Start the process group when asked: `enable` (the config's
    `trainer.multihost`), PFM_MULTIHOST=1, or a launch by torchrun (RANK and
    WORLD_SIZE in the environment). Returns whether a group is up. A second
    call returns True. A CUDA device is this rank's card from here on
    (`rank_device`)."""
    if tdist.is_initialized():
        return True
    if not (enable or os.environ.get("PFM_MULTIHOST", "0") == "1" or _launched_by_torchrun()):
        return False
    if not _launched_by_torchrun():
        raise RuntimeError(
            "a multi-process run needs RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT: "
            "launch it with torchrun")
    dev = torch.device(device)
    backend = os.environ.get(BACKEND_ENV) or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the NCCL backend needs a CUDA device, got {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device=cpu to run on the CPU")
        torch.cuda.set_device(_device_index(backend))
    kwargs = ({"device_id": torch.device("cuda", _device_index(backend))}
              if backend == "nccl" else {})
    tdist.init_process_group(backend, **kwargs)
    return True


def _device_index(backend_name: str) -> int:
    """This rank's card: LOCAL_RANK; with more ranks than cards on gloo, the
    ranks share the cards in turn (NCCL takes one rank a card and raises)."""
    n, r = torch.cuda.device_count(), local_rank()
    if r < n:
        return r
    if backend_name != "gloo":
        raise RuntimeError(f"local rank {r} has no card of its own ({n} visible) on "
                           f"{backend_name}: NCCL takes one rank a card (gloo may share)")
    return r % n


def is_initialized() -> bool:
    return tdist.is_initialized()


def rank() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def world_size() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def is_rank_zero() -> bool:
    """True on the process that writes logs, checkpoints and files."""
    return rank() == 0


def backend() -> str | None:
    return tdist.get_backend() if tdist.is_initialized() else None


def rank_device(device: torch.device) -> torch.device:
    """This rank's device: its card (`cuda:LOCAL_RANK`; shared in turn by
    gloo ranks beyond the cards) for CUDA in a process group, else `device`
    as given."""
    if device.type == "cuda" and tdist.is_initialized():
        return torch.device("cuda", _device_index(backend()))
    return device


def local_rows(global_batch: int, rank_: int | None = None,
               world: int | None = None) -> slice:
    """This rank's rows of a global batch; the counterpart of `shard_batch`.
    A batch the ranks cannot share evenly raises."""
    r = rank() if rank_ is None else rank_
    w = world_size() if world is None else world
    if global_batch % w:
        raise ValueError(f"a batch of {global_batch} does not split over {w} ranks")
    b = global_batch // w
    return slice(r * b, (r + 1) * b)


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `t` over the ranks (of `group`; None: all), in place; returns it.
    Each call is a torch.profiler range named ALL_REDUCE_RANGE."""
    with torch.profiler.record_function(ALL_REDUCE_RANGE):
        tdist.all_reduce(t, op=tdist.ReduceOp.SUM, group=group)
    return t


SEGMENT_ALIGN_BYTES = 16  # where each tensor starts in the flat buffer of a summed list


def all_reduce_tensors_(tensors: list[torch.Tensor], group=None) -> list[torch.Tensor]:
    """The tensors summed over the ranks (of `group`) in one collective (one
    flat buffer of their common dtype); returns views of the summed buffer,
    each starting SEGMENT_ALIGN_BYTES-aligned. The alignment matters: the
    CUDA `_foreach_norm` of the clip sums a misaligned view in another order
    than a tensor of its own, which moved dp at W=1 from one process by up
    to 3.9e-6 in 8 steps (ROADMAP.md Queue 3 item 15)."""
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in tensors))
    step = max(SEGMENT_ALIGN_BYTES // dtype.itemsize, 1)
    sizes = [-(-t.numel() // step) * step for t in tensors]
    flat = tensors[0].new_zeros(sum(sizes), dtype=dtype)
    torch._foreach_copy_([part[:t.numel()] for part, t in zip(torch.split(flat, sizes), tensors)],
                         [t.reshape(-1) for t in tensors])
    flat = all_reduce_sum_(flat, group)
    return [part[:t.numel()].view(t.shape) for part, t in
            zip(torch.split(flat, sizes), tensors)]


def broadcast_(tensors) -> None:
    """Overwrite every tensor with rank 0's; the counterpart of `replicate`
    (the seeded initialisation is the same on every rank, but a rank that
    differs must not train on)."""
    with torch.no_grad():
        for t in tensors:
            tdist.broadcast(t, src=0)


def broadcast_object(obj):
    """Rank 0's `obj` on every rank (a decision only rank 0 may take)."""
    if not tdist.is_initialized():
        return obj
    box = [obj]
    tdist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    if tdist.is_initialized():
        tdist.barrier()


def gather_rows(local: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The ranks' parts, concatenated along `dim` in rank order on every rank."""
    parts = [torch.empty_like(local) for _ in range(world_size())]
    tdist.all_gather(parts, local.contiguous())
    return torch.cat(parts, dim=dim)


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """Rank `rank` of `world` holds its rows of the global batch; `reduce`
    sums a tensor over the ranks that hold distinct data (an all-reduce; a
    test may emulate it), `group` is their process group (None: every rank).

    On a (data, model) mesh (parallel/mesh.py) `rank` and `world` are the
    data coordinate and size. Under dp_tp and dp_ep the model ranks of a
    row hold the same rows, so the sums run over the data group. Under sp
    (`seq`, the model axis) each rank also holds its part of every set's
    particles, of a set of `particles` padded to a multiple of the model
    size with masked particles on the last ranks (`local_particles`); the
    sums of per-particle quantities run over every rank, and those of
    per-set quantities (the cond normaliser's) over the data group
    (`rows_shard`, with `reduce_rows`)."""

    rank: int
    world: int
    reduce: Callable[[torch.Tensor], torch.Tensor]
    group: object = None
    seq: object = None
    particles: int = 0
    reduce_rows: Callable[[torch.Tensor], torch.Tensor] | None = None

    @classmethod
    def of_group(cls) -> "BatchShard":
        return cls(rank(), world_size(), lambda t: all_reduce_sum_(t.clone()))

    @classmethod
    def of_mesh(cls, mesh, sp: bool = False) -> "BatchShard":
        """The rows of this rank's data coordinate on a ProcessMesh; with
        `sp` the particles split over its model axis too."""
        def over(group):
            return lambda t: all_reduce_sum_(t.clone(), group)

        if not sp:
            return cls(mesh.data_rank, mesh.data, over(mesh.data_group), mesh.data_group)
        return cls(mesh.data_rank, mesh.data, over(None), None, seq=mesh.axis,
                   reduce_rows=over(mesh.data_group))

    def global_rows(self, b: int) -> int:
        return b * self.world

    def local(self, a: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global-batch tensor."""
        return a[local_rows(a.shape[0], self.rank, self.world)]

    def at_particles(self, n: int) -> "BatchShard":
        """This shard for sets of n particles (sp)."""
        return dataclasses.replace(self, particles=n)

    def local_particles(self, a: torch.Tensor) -> torch.Tensor:
        """This model rank's particles (axis 1) of a tensor of whole sets:
        ceil(n / model) of them, zeros past the last particle."""
        m = self.seq.size
        k = -(-self.particles // m)
        lo = self.seq.rank * k
        part = a[:, lo:lo + k]
        if part.shape[1] < k:
            pad = part.new_zeros((part.shape[0], k - part.shape[1]) + tuple(part.shape[2:]))
            part = torch.cat([part, pad], dim=1)
        return part

    def rows_shard(self) -> "BatchShard":
        """The shard of per-set quantities: its sums over the data group."""
        if self.seq is None:
            return self
        return BatchShard(self.rank, self.world, self.reduce_rows)

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of a no-grad tensor."""
        if t.requires_grad:
            raise ValueError("BatchShard.total sums no-grad tensors (counts and moments)")
        return self.reduce(t)


def local_draw(shard: BatchShard | None, draw: Callable, generator: torch.Generator,
               shape, device: torch.device, per_particle: bool = False) -> torch.Tensor:
    """`draw(generator, shape, device)` for this rank's rows: with a shard,
    drawn for the global batch (shape[0] * W rows) and sliced; a
    `per_particle` draw (B, N, ...) under sp is drawn for the whole sets
    and this rank's particles kept."""
    if shard is None:
        return draw(generator, shape, device)
    if isinstance(shape, int):
        return shard.local(draw(generator, shard.global_rows(shape), device))
    shape = tuple(shape)
    if per_particle and shard.seq is not None:
        whole = draw(generator, (shard.global_rows(shape[0]), shard.particles) + shape[2:],
                     device)
        return shard.local_particles(shard.local(whole))
    return shard.local(draw(generator, (shard.global_rows(shape[0]),) + shape[1:], device))
