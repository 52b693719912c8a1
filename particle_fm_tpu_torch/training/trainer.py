"""Training loop, single device: epochs, validation, eval callbacks,
checkpoints, logging; counterpart of particle_fm_tpu/training/trainer.py
(field names and semantics as there).

A train split of fixed-shape batches (`datamodule.device_cacheable`) is
placed on the device once, and each epoch's shuffle is one gather there:
with `cache_data_on_device=None` (the default) when the split is under
`device_cache_limit_mb`, with True always, with False never.
The shuffle is the JAX trainer's,
`np.random.default_rng(seed + epoch).permutation(n)[:n_use]`, over the same
usable batches, so both packages see the same batches in the same order.
Otherwise the epoch's batches come from
`datamodule.train_batches(seed=seed + epoch)` on the host (the bucketed
CaloChallenge batches) and are streamed: a worker thread builds the next
`prefetch_batches` batches and copies them from page-locked buffers with
`non_blocking` copies (data/prefetch.py); a worker's exception is raised at
the next pull; 0 turns the worker off (each batch placed at its pull). With
accumulation, each group of streamed batches is stacked
on the host first, as in the JAX trainer.
Each step draws from a generator seeded from (seed + 1, step), the
counterpart of the JAX step's `fold_in(rng, step)`: a run resumed from a
checkpoint continues as the uninterrupted run would have.

With `scan_epochs` (the default, as in the JAX trainer) and the split on
the device, an epoch is one run of the step body over its shuffle
(training/epochs.py: a plain loop on the CPU, a captured CUDA graph of one
step replayed on the card), with no host read inside it; with `fuse_epochs`
= E > 1 a group of E epochs is one run, its epochs' shuffles gathered on the
device, the groups aligned to multiples of E (a resumed mid-group start
runs a short first group). Validation, callbacks, logging and checkpoints
run at group boundaries, the group's last epoch's `train_loss` reported.
Both train the same as the per-step path, to the bit. Where the split holds
no full batch, or is streamed, epochs run per step, as in the JAX trainer.
Some runs cannot be captured: a process group (dp or fsdp, on gloo or
NCCL) and a loss that reads the host (OT-CFM with `ot_method=exact`) take
the per-step path, by a rule decided at construction and said once in the
log (`per_step_reason`).

A callback may set `should_stop` (training/stopping.py): the loop breaks
after the epoch's checkpoints, saving `last` first. `load_weights_from`
starts from a checkpoint's parameters and EMA with a fresh optimizer and
step. Checkpoints are written on a worker thread (`ckpt_async`), joined at
the end of `fit` and before any read. Validation runs
on the current parameters with the generator seeded VAL_SEED for every
batch, as the JAX trainer hands every batch the same key.

With `loss_per_jettype`, every `loss_per_jettype_every_n` epochs the
validation loss of each jet type (the one-hot `jet_type_label_*` columns of
the conditioning, JetClass) is logged as `val_loss_<type>`: at most 10,000
validation sets a type, the generator seeded VAL_SEED.

Once per epoch, after validation, each callback is called with the trainer;
the metrics it returns (e.g. `w1m_mean`) are merged into the epoch's before
logging and before the checkpoint monitors read them. `test` restores the
best or last checkpoint and runs the callbacks marked `on_test` with
`testing` set. A callback must not move the training run: it samples a copy
of the network with its own generators (eval/callbacks.py), and each step's
generator stays seeded from (seed + 1, step).

Across processes (parallel/, launched by torchrun) every rank runs this
loop on the same global batches: `strategy="dp"` replicates the state and
sums the gradients over the ranks each step, `strategy="fsdp"` shards the
parameters, their EMA twin and the AdamW moments (parallel/fsdp.py). On a
(data, model) mesh of `model_axis_size` ranks a row (parallel/mesh.py; the
world must divide, as in the JAX trainer) `dp_tp` splits the EPiC local
MLPs and `dp_ep` the MoE's experts over the model axis (parallel/tp.py),
and `sp` splits each set's particles (the EPiC model and the full
transformer without experts; another family, or CFM-OT, raises); the model
ranks of a row hold the same rows. Rank r takes rows [d*B/D, (d+1)*B/D) of
each global batch B, d its data coordinate of D (D = W but on the mesh;
`batch_size` is global, as in the JAX trainer) from its own device cache,
shuffled by the same permutation, or from the same streamed batches; the
cache is trimmed to a multiple of D as the JAX trainer trims it, and so is
each validation batch. Each rank draws from the same generator at the global batch's size
and keeps its rows (parallel/dist.py), so the losses and the updates are
one process's at the same global batch. The state starts from rank 0's.
Callbacks compute on every rank (generation rank-split, metrics identical
everywhere, so checkpoint decisions agree); logs, stdout, checkpoints and
callback files are rank 0's (`artifacts_dir` is None on the others). In
one process without a process group nothing of this runs.

The pipeline strategies (parallel/pp.py) split the droid full
transformer's layers over S = `model_axis_size` stages, M = `pp_microbatches`
microbatches a step: `pp` is one pipeline of the S ranks (data 1, pipe S),
`dp_pp` W / S pipelines on the (data, pipe) layout, each training its rows.
The state stays replicated (each rank holds it whole; the step sums every
rank's part of the gradients); validation and the callbacks run the
unpipelined network, as the JAX trainer's eval step does; checkpoints are
rank 0's, in the single-process format. They refuse what JAX refuses, with
its exception types: another family, n_transforms != 1, the gaussian time
embedding (NotImplementedError); accumulation, self_cond, layers or a
batch that the stages or M x D microbatches do not divide, a world that S
does not divide (ValueError). In one process pp runs with S = 1 only; a
world larger than S under pp raises ValueError naming dp_pp where JAX
leaves the other devices idle (ROADMAP.md Queue 3 item 16).

The logger backends (training/loggers.py) take their init arguments from
`logger_kwargs`, one dict a backend name, as in the JAX trainer.

Not carried: the model axis in one process (ROADMAP.md Queue 1 item 7).
"""

from __future__ import annotations

import inspect
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from particle_fm_tpu_torch.data.prefetch import pinned_placer, prefetch_to_device
from particle_fm_tpu_torch.parallel import dist
from particle_fm_tpu_torch.parallel.dist import BatchShard
from particle_fm_tpu_torch.parallel.fsdp import shard_state_fsdp
from particle_fm_tpu_torch.parallel.mesh import ROADMAP_ITEM, make_mesh
from particle_fm_tpu_torch.parallel.pp import (check_batch, check_pipelined, pipe_axis,
                                               single_stage)
from particle_fm_tpu_torch.parallel.tp import STRATEGY_RULES, shard_state_tp
from particle_fm_tpu_torch.training.checkpoint import CheckpointManager
from particle_fm_tpu_torch.training.checkpoint import load_weights_from as _load_weights
from particle_fm_tpu_torch.training.epochs import make_train_superepoch, step_seed
from particle_fm_tpu_torch.training.loggers import MultiLogger
from particle_fm_tpu_torch.training.step import (
    Optimizer,
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from particle_fm_tpu_torch.utils.device import resolve_device

VAL_SEED = 9999  # fixed validation seed, as in the JAX trainer
STRATEGIES = ("dp", "fsdp", "dp_tp", "sp", "pp", "dp_pp", "dp_ep")
MODEL_AXIS_STRATEGIES = ("dp_tp", "sp", "dp_ep")  # on a (data, model) mesh
PIPELINE_STRATEGIES = ("pp", "dp_pp")  # on a (data, pipe) mesh
SP_FAMILIES = ("epic", "droid_fulltransformer")  # the networks sp runs


@dataclass
class Trainer:
    model: object
    datamodule: object
    optimizer: Optimizer
    max_epochs: int = 10
    ema_decay: float = 0.999
    ema_every_n: int = 1
    ema_start_step: int = 0
    check_val_every_n_epoch: int = 1
    callbacks: Sequence = ()
    ckpt_dir: Optional[str] = None
    ckpt_monitors: dict = field(default_factory=lambda: {"val_loss": "min"})
    ckpt_top_k: int = 1
    ckpt_async: bool = True  # checkpoints written on a worker thread (training/checkpoint.py)
    save_last_every_n_epoch: int = 10
    log_dir: Optional[str] = None
    logger_backends: tuple = ("jsonl",)
    logger_kwargs: dict = field(default_factory=dict)  # init arguments a backend name
    # the train split on the device: None = when under device_cache_limit_mb
    cache_data_on_device: Optional[bool] = None
    device_cache_limit_mb: int = 2048
    prefetch_batches: int = 2  # streamed batches the worker keeps in flight; 0 = no worker
    # one optimizer step per this many microbatches of datamodule.batch_size,
    # their gradients weighted by the loss normalisation mass
    accumulate_grad_batches: int = 1
    loss_per_jettype: bool = False
    loss_per_jettype_every_n: int = 20
    # an epoch as one run of steps with no host read inside (a captured CUDA
    # graph on the card); groups of fuse_epochs epochs as one run
    scan_epochs: bool = True
    fuse_epochs: int = 1
    strategy: str = "dp"
    # ranks on the model axis of dp_tp, sp and dp_ep, stages of pp and dp_pp
    # (the JAX trainer's default)
    model_axis_size: int = 2
    pp_microbatches: int = 8  # microbatches a step of pp and dp_pp, as in the JAX trainer
    seed: int = 0
    verbose: bool = True
    device: str = "cuda"

    # populated at runtime
    state: TrainState = None
    epoch: int = 0
    metrics_history: list = field(default_factory=list)
    last_metrics: dict = field(default_factory=dict)
    testing: bool = False  # set by `test`: scheduled callbacks bypass their epoch gates
    # callbacks may set this (early stopping, trial pruning); the epoch loop
    # breaks after checkpointing
    should_stop: bool = False

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"unknown trainer.strategy {self.strategy!r} "
                f"(expected {' | '.join(STRATEGIES)})")
        if self.fuse_epochs < 1:
            raise ValueError("trainer.fuse_epochs must be >= 1")
        if self.accumulate_grad_batches < 1:
            raise ValueError("trainer.accumulate_grad_batches must be >= 1")
        self.mesh = self.pipe = None
        shard = BatchShard.of_group() if dist.is_initialized() else None
        if self.strategy in MODEL_AXIS_STRATEGIES:
            self._check_model_axis()
            self.mesh = make_mesh(self.model_axis_size)
            shard = BatchShard.of_mesh(self.mesh, sp=self.strategy == "sp")
        if self.strategy in PIPELINE_STRATEGIES:
            self._check_pipeline()
            self.pipe = single_stage()
            shard = None
            if dist.is_initialized():
                self.mesh = make_mesh(self.model_axis_size)
                self.pipe = pipe_axis(self.mesh)
                shard = BatchShard.of_mesh(self.mesh) if self.mesh.data > 1 else None
        if self.strategy == "fsdp" and shard is None:
            raise NotImplementedError(
                "trainer.strategy='fsdp' in one process is not ported: it shards over the "
                "ranks of a process group (launch with torchrun)")
        # the ranks that hold distinct rows of each global batch
        self.world = 1 if shard is None else shard.world
        if shard is not None:
            if "shard" not in inspect.signature(self.model.loss).parameters:
                raise NotImplementedError(
                    f"{type(self.model).__name__} does not train across processes")
            if self.datamodule.batch_size % self.world:
                raise ValueError(f"data.batch_size={self.datamodule.batch_size} does not "
                                 f"split over {self.world} ranks")
        self.shard = shard
        # multi-process: logs and stdout on rank 0 only; every rank makes the
        # checkpoint manager's calls (its writes are rank 0's)
        self._rank0 = dist.is_rank_zero()
        if not self._rank0:
            self.log_dir = None
            self.verbose = False
        self.device = dist.rank_device(resolve_device(self.device))
        self.train_step = make_train_step(
            self.model, self.optimizer, ema_decay=self.ema_decay, ema_every_n=self.ema_every_n,
            ema_start_step=self.ema_start_step, accum=self.accumulate_grad_batches, shard=shard,
            pipe=self.pipe, microbatches=self.pp_microbatches,
        )
        self.eval_step = make_eval_step(self.model, shard=shard)
        self.per_step_reason = self._per_step_reason() if self.scan_epochs else None
        if self.per_step_reason is not None:
            self.scan_epochs = False
            if self.verbose:
                print(f"[trainer] scan_epochs off: {self.per_step_reason}; epochs run per step",
                      flush=True)
        self.train_superepoch = (make_train_superepoch(
            self.model, self.optimizer, ema_decay=self.ema_decay, ema_every_n=self.ema_every_n,
            ema_start_step=self.ema_start_step, accum=self.accumulate_grad_batches,
            seed=self.seed) if self.scan_epochs else None)
        self.ckpt = (CheckpointManager(self.ckpt_dir, self.ckpt_monitors, self.ckpt_top_k,
                                       async_save=self.ckpt_async)
                     if self.ckpt_dir else None)
        self.logger = (MultiLogger(self.log_dir, backends=tuple(self.logger_backends),
                                   **(self.logger_kwargs or {}))
                       if self.log_dir else None)
        # where callbacks write their files (final_generated_data.npy, ...):
        # None on every rank but 0
        self.artifacts_dir = (self.log_dir or ".") if self._rank0 else None

    def _check_model_axis(self) -> None:
        """The port's limits and JAX's checks of a (data, model) strategy: a
        process group (one process has no model axis), the world divisible
        by model_axis_size, and for sp a network family whose particles it
        can split."""
        if not dist.is_initialized():
            raise NotImplementedError(
                f"trainer.strategy={self.strategy!r} in one process is not ported "
                f"({ROADMAP_ITEM}): it splits the model axis over the ranks of a process group "
                "(launch with torchrun)")
        w, m = dist.world_size(), self.model_axis_size
        if m < 1 or w % m:
            raise ValueError(f"strategy={self.strategy} needs the world size ({w}) divisible by "
                             f"model_axis_size ({m})")
        if self.strategy != "sp":
            return
        family = getattr(self.model, "model", None)
        te = dict(dict(getattr(self.model, "net_config", None) or {}).get("te_config") or {})
        if family not in SP_FAMILIES or te.get("moe_config") is not None:
            raise NotImplementedError(
                f"trainer.strategy='sp' is not ported for {type(self.model).__name__} "
                f"model={family!r}{' with experts' if te.get('moe_config') else ''} "
                f"({ROADMAP_ITEM}); sp runs {' and '.join(SP_FAMILIES)} without experts")
        if getattr(self.model, "loss_type", None) == "CFM-OT":
            raise NotImplementedError(
                f"trainer.strategy='sp' with CFM-OT is not ported ({ROADMAP_ITEM}): the pairing "
                "couples each set's particles across the split")

    def _check_pipeline(self) -> None:
        """JAX's checks of pp and dp_pp (the trainer's, `make_pipe_mesh`'s and
        parallel/pp.py's) and the port's limit on pp's world."""
        w, s = dist.world_size(), self.model_axis_size
        if self.accumulate_grad_batches > 1:
            raise ValueError(
                "accumulate_grad_batches is not supported with strategy=pp/dp_pp (the pipeline "
                "already microbatches internally; raise pp_microbatches instead)")
        if s < 1 or w % s:
            raise ValueError(f"strategy={self.strategy} needs the world size ({w}) divisible by "
                             f"model_axis_size ({s})")
        if self.strategy == "pp" and w > s:
            raise ValueError(
                f"strategy=pp runs one pipeline of model_axis_size ({s}) stages, the world has "
                f"{w} ranks: use strategy=dp_pp for {w // s} pipelines (ROADMAP.md Queue 3 "
                "item 16)")
        check_pipelined(self.model, s)
        if self.pp_microbatches < 1:
            raise ValueError("trainer.pp_microbatches must be >= 1")
        if self.datamodule is not None:
            check_batch(self.datamodule.batch_size, self.pp_microbatches, w // s)

    def _per_step_reason(self) -> str | None:
        """Why epochs cannot run as one captured run, or None."""
        if self.pipe is not None:
            return f"the pipeline ({self.strategy}, as in the JAX trainer)"
        if self.shard is not None:
            return f"a process group ({self.strategy} over {dist.world_size()} ranks)"
        reads_host = getattr(self.model, "loss_reads_host", None)
        if reads_host is not None and reads_host():
            return "the loss reads the host (OT-CFM with ot_method=exact)"
        return None

    # ------------------------------------------------------------- helpers
    def _log(self, metrics: dict) -> None:
        metrics = {"epoch": self.epoch, **metrics}
        self.metrics_history.append(metrics)
        if self.logger is not None:
            self.logger.log_metrics(metrics, step=self.epoch)
        if self.verbose:
            print("[trainer] " + " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}" for k, v in metrics.items()
            ), flush=True)

    def _to_device(self, batch):
        return tuple(None if a is None else torch.as_tensor(a, device=self.device) for a in batch)

    def _local(self, batch):
        """This rank's rows of a host batch (the batch in one process)."""
        if self.shard is None:
            return batch
        return tuple(None if a is None else self.shard.local(a) for a in batch)

    def _even(self, batch):
        """A validation batch trimmed to a multiple of the world size, as the
        JAX trainer trims it (None: nothing left)."""
        keep = len(batch[0]) - len(batch[0]) % self.world
        if keep == 0:
            return None
        return batch if keep == len(batch[0]) else tuple(
            None if a is None else a[:keep] for a in batch)

    def _place_train_split(self):
        split = self.datamodule.train
        n = len(split.x) - len(split.x) % self.world  # evenly over the ranks, as in JAX
        return self._to_device(tuple(None if a is None else a[:n]
                                     for a in (split.x, split.mask, split.cond)))

    def _maybe_cache_train_data(self):
        """The train split on the device, or None to stream its batches."""
        dm = self.datamodule
        split = getattr(dm, "train", None)
        if split is None or not getattr(dm, "device_cacheable", False):
            return None
        nbytes = split.x.nbytes + (split.mask.nbytes if split.mask is not None else 0)
        enabled = (self.cache_data_on_device if self.cache_data_on_device is not None
                   else nbytes < self.device_cache_limit_mb * 2**20)
        return self._place_train_split() if enabled else None

    def _streamed_batches(self, epoch: int):
        """The epoch's host batches (this rank's rows) on the device,
        prefetched; (A, B, ...) groups of A stacked host batches with
        accumulation."""
        batches = map(self._local, self.datamodule.train_batches(seed=self.seed + epoch))
        accum = self.accumulate_grad_batches
        if accum > 1:
            def groups(batches=batches):
                buf = []
                for batch in batches:
                    buf.append(batch)
                    if len(buf) == accum:
                        yield tuple(None if buf[0][j] is None
                                    else np.stack([np.asarray(b[j]) for b in buf])
                                    for j in range(3))
                        buf = []
            batches = groups()
        return prefetch_to_device(batches, pinned_placer(self.device),
                                  self.prefetch_batches)

    def _epoch_perm(self, n: int, n_use: int, epoch: int) -> np.ndarray:
        return np.random.default_rng(self.seed + epoch).permutation(n)[:n_use]

    def _usable_batches(self, n: int, bs: int, accum: int) -> tuple[int, int]:
        """(n_use, k): samples and microbatches of an epoch after dropping
        the ragged tail and, with accumulation, the microbatches beyond the
        last full optimizer step."""
        n_use = n - (n % bs)
        k = n_use // bs
        if accum > 1:
            k -= k % accum
            if k == 0 and n_use > 0:
                raise ValueError(
                    f"accumulate_grad_batches={accum} needs at least {accum} "
                    f"full batches per epoch; train split has {n_use // bs}"
                )
        return k * bs, k

    def _epoch_batches(self, dev_data, epoch: int):
        """The epoch's batches, gathered on the device: (B, ...) each, or
        (A, B, ...) groups with accumulation. A split smaller than one batch
        gives one short batch (without accumulation)."""
        if dev_data is None:
            yield from self._streamed_batches(epoch)
            return
        bs, accum = self.datamodule.batch_size, self.accumulate_grad_batches
        x = dev_data[0]
        n = x.shape[0]
        if accum == 1 and 0 < n < bs:
            bs = n
        n_use, k = self._usable_batches(n, bs, accum)
        perm = self._epoch_perm(n, n_use, epoch)
        if self.shard is not None:  # this rank's rows of every batch
            perm = perm.reshape(k, bs)[:, dist.local_rows(bs, self.shard.rank,
                                                          self.world)].reshape(-1)
            bs //= self.world
        perm = torch.from_numpy(perm).to(self.device)
        shuffled = [None if a is None else a.index_select(0, perm) for a in dev_data]
        group = accum * bs
        for i in range(k // accum):
            sl = slice(i * group, (i + 1) * group)
            yield tuple(
                None if a is None
                else a[sl] if accum == 1 else a[sl].reshape((accum, bs) + a.shape[1:])
                for a in shuffled
            )

    # ---------------------------------------------------------------- fit
    def fit(self, resume_from: str | None = None, load_weights_from: str | None = None,
            initial_state: TrainState | None = None) -> TrainState:
        state = initial_state or create_train_state(self.model, self.optimizer, seed=self.seed,
                                                    device=self.device)
        if load_weights_from:
            _load_weights(load_weights_from, state)
            if self.verbose:
                print(f"[trainer] loaded pretrained weights from {load_weights_from}")
        if resume_from:
            if self.ckpt is None:
                raise ValueError("resume_from requires ckpt_dir")
            self.ckpt.restore(resume_from, state)
            if self.verbose:
                print(f"[trainer] resumed from {resume_from} at step {state.step}")
        state = self._place_state(state)
        self.state = state
        self.should_stop = False  # a fresh fit() clears any earlier stop request
        dev_data = self._maybe_cache_train_data()
        gen = torch.Generator(self.device)

        opt_steps_per_epoch = max(
            self.datamodule.steps_per_epoch // self.accumulate_grad_batches, 1)
        epoch = state.step // opt_steps_per_epoch
        while epoch < self.max_epochs:
            t0 = time.perf_counter()
            # fused groups align to multiples of fuse_epochs (a resumed
            # mid-group start runs a short first group)
            group = min(self.fuse_epochs - epoch % self.fuse_epochs, self.max_epochs - epoch)
            perms = (self._group_perms(dev_data, epoch, group)
                     if self.scan_epochs and dev_data is not None else None)
            if perms is not None:
                losses = self.train_superepoch(state, *dev_data, perms)
                train_loss = float(losses[-1].mean())  # the group's last epoch
            else:
                group = 1  # per step: streamed, a split smaller than one batch, or the rule
                losses = []
                for batch in self._epoch_batches(dev_data, epoch):
                    gen.manual_seed(step_seed(self.seed, state.step))
                    losses.append(self.train_step(state, gen, *batch))
                train_loss = float(torch.stack(losses).mean()) if losses else float("nan")
            epoch += group - 1  # the group's last epoch: all per-epoch work below
            self.epoch = epoch
            metrics = {"train_loss": train_loss, "epoch_time": time.perf_counter() - t0}
            if (epoch + 1) % self.check_val_every_n_epoch == 0:
                metrics["val_loss"] = self.validate()
            if self.loss_per_jettype and epoch % self.loss_per_jettype_every_n == 0:
                metrics.update(self._per_jettype_losses())
            # eval callbacks may add metrics (e.g. w1m_mean) that drive
            # checkpoints; stopping and pruning callbacks read them here
            self.last_metrics = metrics
            for cb in self.callbacks:
                out = cb(self)
                if out:
                    metrics.update(out)
            self._log(metrics)

            if self.ckpt is not None:
                for monitor in self.ckpt_monitors:
                    if monitor in metrics:
                        self.ckpt.save_metric(state, monitor, float(metrics[monitor]), state.step)
                if (epoch + 1) % self.save_last_every_n_epoch == 0 or epoch == self.max_epochs - 1:
                    self.ckpt.save_last(state)
            if self.should_stop:
                if self.ckpt is not None:
                    self.ckpt.save_last(state)
                if self.verbose:
                    print(f"[trainer] stop requested at epoch {epoch}", flush=True)
                break
            epoch += 1
        if self.ckpt is not None:
            self.ckpt.flush()  # join the queued checkpoint writes
        return state

    def _group_perms(self, dev_data, epoch: int, group: int) -> np.ndarray | None:
        """The (E, K, B) shuffles of a group of E epochs ((E, K, A, B) with
        accumulation), each the epoch's `_epoch_perm`; None when the split
        holds no full batch (the per-step path takes it)."""
        bs, accum = self.datamodule.batch_size, self.accumulate_grad_batches
        n = dev_data[0].shape[0]
        n_use, k = self._usable_batches(n, bs, accum)
        if n_use == 0:
            return None
        row = (k // accum, accum, bs) if accum > 1 else (k, bs)
        return np.stack([self._epoch_perm(n, n_use, e).reshape(row)
                         for e in range(epoch, epoch + group)])

    def _place_state(self, state: TrainState) -> TrainState:
        """In a process group: rank 0's state on every rank, then sharded
        under fsdp, split over the model axis under dp_tp and dp_ep (the
        counterpart of the JAX trainer's `_place_state`)."""
        if not dist.is_initialized():
            return state
        dist.broadcast_(list(state.net.parameters()) + list(state.net.buffers())
                        + list(state.ema_params))
        if self.strategy == "fsdp":
            return shard_state_fsdp(state)
        if self.strategy in STRATEGY_RULES:
            return shard_state_tp(state, self.mesh.axis, STRATEGY_RULES[self.strategy])
        return state

    # ------------------------------------------------------------ validate
    def validate(self) -> float:
        gen = torch.Generator(self.device)
        losses = []
        for batch in self.datamodule.val_batches():
            batch = self._even(batch)
            if batch is None:
                continue
            gen.manual_seed(VAL_SEED)
            losses.append(self.eval_step(self.state, gen, *self._to_device(self._local(batch))))
        return float(torch.stack(losses).mean()) if losses else float("nan")

    def _per_jettype_losses(self) -> dict:
        """Validation loss per jet type, the sets picked by the one-hot
        conditioning columns named jet_type_label_* (JetClass)."""
        dm = self.datamodule
        names = getattr(dm, "names_conditioning", None)
        split = dm.val
        if not names or split.cond is None:
            return {}
        gen = torch.Generator(self.device)
        out = {}
        for i, name in enumerate(names):
            if not str(name).startswith("jet_type_label_"):
                continue
            sel = np.where(split.cond[:, i] == 1)[0][:10_000]
            sel = sel[: len(sel) - len(sel) % self.world]
            if len(sel) == 0:
                continue
            batch = (split.x[sel], split.mask[sel] if split.mask is not None else None,
                     split.cond[sel])
            gen.manual_seed(VAL_SEED)
            loss = self.eval_step(self.state, gen, *self._to_device(self._local(batch)))
            out[f"val_loss_{str(name).replace('jet_type_label_', '')}"] = float(loss)
        return out

    # ---------------------------------------------------------------- test
    def test(self, ckpt: str = "best", monitor: str | None = None) -> dict:
        """Run the `on_test` callbacks on the best (of `monitor`, else the
        first monitor) or the last checkpoint; returns their metrics. A
        monitor no epoch logged (a callback that never ran, or one whose
        metrics have other names) has no best checkpoint: the last one is
        taken then."""
        if self.ckpt is not None:
            best = (self.ckpt.best_path(monitor or next(iter(self.ckpt_monitors)))
                    if ckpt == "best" else None)
            path = best or self.ckpt.last_path()
            if path is not None:
                if self.state is None or self.state.sharding is not None:
                    # a sharded state is restored whole, then sharded again
                    self.state = create_train_state(self.model, self.optimizer, seed=self.seed,
                                                    device=self.device)
                self.state = self._place_state(self.ckpt.restore(path, self.state))
        if self.state is None:
            raise FileNotFoundError("Trainer.test: no checkpoint to restore and no trained state")
        results = {}
        self.testing = True
        try:
            for cb in self.callbacks:
                if getattr(cb, "on_test", False):
                    out = cb(self)
                    if out:
                        results.update(out)
        finally:
            self.testing = False
        return results
