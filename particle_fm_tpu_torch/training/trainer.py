"""Training loop, single device: epochs, validation, eval callbacks,
checkpoints, logging; counterpart of particle_fm_tpu/training/trainer.py
(field names and semantics as there).

A train split of fixed-shape batches (`datamodule.device_cacheable`) is
placed on the device once when it is under DEVICE_CACHE_LIMIT_MB, and each
epoch's shuffle is one gather there.
The shuffle is the JAX trainer's,
`np.random.default_rng(seed + epoch).permutation(n)[:n_use]`, over the same
usable batches, so both packages see the same batches in the same order.
Otherwise the epoch's batches come from
`datamodule.train_batches(seed=seed + epoch)` on the host (the bucketed
CaloChallenge batches) and are streamed: a worker thread builds the next
PREFETCH_BATCHES batches and copies them from page-locked buffers with
`non_blocking` copies (data/prefetch.py); a worker's exception is raised at
the next pull. With accumulation, each group of streamed batches is stacked
on the host first, as in the JAX trainer.
Each step draws from a generator seeded from (seed + 1, step), the
counterpart of the JAX step's `fold_in(rng, step)`: a run resumed from a
checkpoint continues as the uninterrupted run would have. Validation runs
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

Not carried: the scanned and fused epochs, the mesh strategies and the
JAX trainer's cache and prefetch options (here the constants
DEVICE_CACHE_LIMIT_MB and PREFETCH_BATCHES); asking for them raises.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from particle_fm_tpu_torch.data.prefetch import pinned_placer, prefetch_to_device
from particle_fm_tpu_torch.training.checkpoint import CheckpointManager
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
DEVICE_CACHE_LIMIT_MB = 2048  # the JAX trainer's default device_cache_limit_mb
PREFETCH_BATCHES = 2  # streamed batches the worker keeps in flight


def step_seed(seed: int, step: int) -> int:
    """The seed of one train step's generator."""
    return int(np.random.SeedSequence([seed + 1, step]).generate_state(1)[0])


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
    save_last_every_n_epoch: int = 10
    log_dir: Optional[str] = None
    logger_backends: tuple = ("jsonl",)
    # one optimizer step per this many microbatches of datamodule.batch_size,
    # their gradients weighted by the loss normalisation mass
    accumulate_grad_batches: int = 1
    loss_per_jettype: bool = False
    loss_per_jettype_every_n: int = 20
    fuse_epochs: int = 1
    strategy: str = "dp"
    seed: int = 0
    verbose: bool = True
    device: str = "cuda"

    # populated at runtime
    state: TrainState = None
    epoch: int = 0
    metrics_history: list = field(default_factory=list)
    last_metrics: dict = field(default_factory=dict)
    testing: bool = False  # set by `test`: scheduled callbacks bypass their epoch gates

    def __post_init__(self):
        if self.strategy != "dp":
            raise NotImplementedError(
                f"trainer.strategy={self.strategy!r} is not ported (single device, 'dp')")
        if self.fuse_epochs > 1:
            raise NotImplementedError("fused epochs (fuse_epochs > 1) are not ported")
        if self.accumulate_grad_batches < 1:
            raise ValueError("trainer.accumulate_grad_batches must be >= 1")
        self.device = resolve_device(self.device)
        self.train_step = make_train_step(
            self.model, self.optimizer, ema_decay=self.ema_decay, ema_every_n=self.ema_every_n,
            ema_start_step=self.ema_start_step, accum=self.accumulate_grad_batches,
        )
        self.eval_step = make_eval_step(self.model)
        self.ckpt = (CheckpointManager(self.ckpt_dir, self.ckpt_monitors, self.ckpt_top_k)
                     if self.ckpt_dir else None)
        self.logger = (MultiLogger(self.log_dir, backends=tuple(self.logger_backends))
                       if self.log_dir else None)
        # where callbacks write their files (final_generated_data.npy, ...)
        self.artifacts_dir = self.log_dir or "."

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

    def _place_train_split(self):
        split = self.datamodule.train
        return self._to_device((split.x, split.mask, split.cond))

    def _maybe_cache_train_data(self):
        """The train split on the device, or None to stream its batches."""
        dm = self.datamodule
        split = getattr(dm, "train", None)
        if split is None or not getattr(dm, "device_cacheable", False):
            return None
        nbytes = split.x.nbytes + (split.mask.nbytes if split.mask is not None else 0)
        return self._place_train_split() if nbytes < DEVICE_CACHE_LIMIT_MB * 2**20 else None

    def _streamed_batches(self, epoch: int):
        """The epoch's host batches on the device, prefetched; (A, B, ...)
        groups of A stacked host batches with accumulation."""
        batches = self.datamodule.train_batches(seed=self.seed + epoch)
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
        return prefetch_to_device(batches, pinned_placer(self.device), PREFETCH_BATCHES)

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
        perm = torch.from_numpy(self._epoch_perm(n, n_use, epoch)).to(self.device)
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
    def fit(self, resume_from: str | None = None,
            initial_state: TrainState | None = None) -> TrainState:
        state = initial_state or create_train_state(self.model, self.optimizer, seed=self.seed,
                                                    device=self.device)
        if resume_from:
            if self.ckpt is None:
                raise ValueError("resume_from requires ckpt_dir")
            self.ckpt.restore(resume_from, state)
            if self.verbose:
                print(f"[trainer] resumed from {resume_from} at step {state.step}")
        self.state = state
        dev_data = self._maybe_cache_train_data()
        gen = torch.Generator(self.device)

        opt_steps_per_epoch = max(
            self.datamodule.steps_per_epoch // self.accumulate_grad_batches, 1)
        for epoch in range(state.step // opt_steps_per_epoch, self.max_epochs):
            t0 = time.perf_counter()
            losses = []
            for batch in self._epoch_batches(dev_data, epoch):
                gen.manual_seed(step_seed(self.seed, state.step))
                losses.append(self.train_step(state, gen, *batch))
            train_loss = float(torch.stack(losses).mean()) if losses else float("nan")
            self.epoch = epoch
            metrics = {"train_loss": train_loss, "epoch_time": time.perf_counter() - t0}
            if (epoch + 1) % self.check_val_every_n_epoch == 0:
                metrics["val_loss"] = self.validate()
            if self.loss_per_jettype and epoch % self.loss_per_jettype_every_n == 0:
                metrics.update(self._per_jettype_losses())
            # eval callbacks may add metrics (e.g. w1m_mean) that drive checkpoints
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
        return state

    # ------------------------------------------------------------ validate
    def validate(self) -> float:
        gen = torch.Generator(self.device)
        losses = []
        for batch in self.datamodule.val_batches():
            gen.manual_seed(VAL_SEED)
            losses.append(self.eval_step(self.state, gen, *self._to_device(batch)))
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
            if len(sel) == 0:
                continue
            batch = (split.x[sel], split.mask[sel] if split.mask is not None else None,
                     split.cond[sel])
            gen.manual_seed(VAL_SEED)
            loss = self.eval_step(self.state, gen, *self._to_device(batch))
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
                if self.state is None:
                    self.state = create_train_state(self.model, self.optimizer, seed=self.seed,
                                                    device=self.device)
                self.state = self.ckpt.restore(path, self.state)
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
