"""Scanned and fused epochs; counterpart of particle_fm_tpu/parallel/train.py::
make_train_epoch and make_train_superepoch.

A run of steps: each step gathers its batch from a source on the device
(the cached train split, or an epoch's stacked batches) by one row of a
permutation table, then runs the step body (training/step.py) that the
per-step path runs. Step i of a run reads row i of the table and the i-th
learning rate at the run's device position; its draws come from a
generator seeded from (seed + 1, step), as the per-step path seeds its
generator (training/trainer.py::step_seed), so a run draws the numbers
that the per-step path draws and trains the same, to the bit.

On the CPU the steps run in a plain loop. On CUDA they run as a captured
`torch.cuda.CUDAGraph` of one step, replayed once a step: the first step
of a run without a graph runs eagerly on a side stream (the warm-up: it
makes the AdamW moments, autograd's and the libraries' state) and the
graph is then captured, once per source, table and state (the tensors it
reads and writes in place). One graph of one step rather than one of a
whole epoch: it serves every epoch length, the short groups of a resumed
or final fused group and any accumulation, it captures in the time of one
step, and a replay is one launch, while the host's work between replays is
the generator's seed (`manual_seed`, no device work) and the graph's own
prologue, which writes that seed and offset to the device
(`CUDAGraph.register_generator_state`). The host reads nothing from the
device inside a run; the losses of its steps are read once, at its end. A
capture or a replay that fails raises: there is no eager fallback.

The kernels' `.launches` counters count where a wrapper's Python runs: at
the warm-up step and at the capture, not at a replay. A replayed run of n
steps launches each kernel n times as often as one step does.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from particle_fm_tpu_torch.training.step import (
    Optimizer,
    TrainState,
    begin_run,
    make_step_body,
)


def step_seed(seed: int, step: int) -> int:
    """The seed of one train step's generator."""
    return int(np.random.SeedSequence([seed + 1, step]).generate_state(1)[0])


class StepRunner:
    """Runs steps of one body over rows of a permutation table: the plain
    loop on the CPU, the replayed graph on CUDA (module docstring)."""

    def __init__(self, model, optimizer: Optimizer, ema_decay: float = 0.999,
                 ema_every_n: int = 1, ema_start_step: int = 0, accum: int = 1, seed: int = 0):
        self.optimizer = optimizer
        self.seed = seed
        self.body = make_step_body(model, optimizer, ema_decay=ema_decay,
                                   ema_every_n=ema_every_n, ema_start_step=ema_start_step,
                                   accum=accum)
        self.generator: torch.Generator | None = None
        self.table: torch.Tensor | None = None  # the permutation rows, int64 on the device
        self.graph: torch.cuda.CUDAGraph | None = None
        self.graph_key: tuple | None = None
        self.captures = 0  # graphs captured (each one a warm-up step and a capture)
        self.capture_s = 0.0  # seconds of the last capture, warm-up step included

    def _gen(self, device: torch.device) -> torch.Generator:
        if self.generator is None or self.generator.device != device:
            self.generator = torch.Generator(device)
        return self.generator

    def _table(self, perms: np.ndarray, device: torch.device) -> torch.Tensor:
        """`perms` (n, *row) in the table's first n rows (a new table where
        the shape, device or room differs)."""
        rows = torch.from_numpy(np.ascontiguousarray(perms, dtype=np.int64))
        t = self.table
        if (t is None or t.device != device or t.shape[1:] != rows.shape[1:]
                or t.shape[0] < rows.shape[0]):
            t = self.table = torch.empty(rows.shape, dtype=torch.int64, device=device)
        t[:rows.shape[0]].copy_(rows, non_blocking=True)
        return t

    def _step(self, state: TrainState, generator: torch.Generator, source) -> torch.Tensor:
        """Gather the batch of the run's current row, then the body."""
        table, sc = self.table, state.scalars
        row = table.shape[1:]
        idx = table.index_select(0, sc.k.view(1)).reshape(-1)
        batch = [None if a is None else a.index_select(0, idx).reshape(row + a.shape[1:])
                 for a in source]
        return self.body(state, generator, *batch)

    def _key(self, state: TrainState, source, generator) -> tuple:
        """The tensors a captured step reads or writes in place."""
        opt = state.opt_state.state
        tensors = [*source, self.table, *state.scalars.__dict__.values(),
                   *state.net.parameters(), *state.net.buffers(), *state.ema_params,
                   *(t for p in state.net.parameters() for t in
                     (opt[p]["exp_avg"], opt[p]["exp_avg_sq"]))]
        return (id(generator),) + tuple(
            None if t is None else (t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors)

    def _capture(self, state: TrainState, generator: torch.Generator, source) -> None:
        """The warm-up step (a step of the run) on a side stream, then the
        capture of one step."""
        t0 = time.perf_counter()
        device = generator.device
        self.graph = None  # its memory goes back before the next capture
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            generator.manual_seed(step_seed(self.seed, state.step))
            self._step(state, generator, source)
        torch.cuda.current_stream(device).wait_stream(side)
        state.step += 1
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        # thread_local: a checkpoint writer's copies on another thread may run meanwhile
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._step(state, generator, source)
        self.graph, self.graph_key = graph, self._key(state, source, generator)
        self.captures += 1
        self.capture_s = time.perf_counter() - t0

    def run(self, state: TrainState, source, perms: np.ndarray) -> torch.Tensor:
        """len(perms) steps, step i on the batch of rows perms[i] of
        `source` (x, mask, cond; None where absent); the losses (n,) on the
        device."""
        n = len(perms)
        device = next(state.net.parameters()).device
        generator = self._gen(device)
        begin_run(state, self.optimizer, n)
        self._table(perms, device)
        if device.type != "cuda":
            for _ in range(n):
                generator.manual_seed(step_seed(self.seed, state.step))
                self._step(state, generator, source)
                state.step += 1
            return state.scalars.losses[:n].clone()
        done = 0
        if self.graph is None or self.graph_key != self._key(state, source, generator):
            self._capture(state, generator, source)
            done = 1
        for _ in range(done, n):
            generator.manual_seed(step_seed(self.seed, state.step))
            self.graph.replay()
            state.step += 1
        return state.scalars.losses[:n].clone()


def _stacked_source(xs, ms, cs, accum: int) -> tuple[tuple, np.ndarray]:
    """Stacked (K, B, ...) or (K, A, B, ...) batches as a flat source and
    the table that reads them in order."""
    lead = 3 if accum > 1 else 2
    row = tuple(xs.shape[:lead])
    source = tuple(None if a is None else a.reshape((-1,) + tuple(a.shape[lead:]))
                   for a in (xs, ms, cs))
    return source, np.arange(int(np.prod(row)), dtype=np.int64).reshape(row)


def make_train_epoch(model, optimizer: Optimizer, ema_decay: float = 0.999,
                     ema_every_n: int = 1, ema_start_step: int = 0, accum: int = 1,
                     seed: int = 0) -> Callable:
    """train_epoch(state, xs, ms, cs) -> losses (K,): K steps over stacked
    batches (K, B, ...), or (K, A, B, ...) accumulated steps of A
    microbatches, each step's draws seeded from (seed + 1, step). On CUDA the
    batches are copied into a buffer the captured step reads (one per shape)."""
    runner = StepRunner(model, optimizer, ema_decay, ema_every_n, ema_start_step, accum, seed)
    buffers: dict = {}

    def train_epoch(state: TrainState, xs, ms, cs) -> torch.Tensor:
        source, table = _stacked_source(xs, ms, cs, accum)
        if xs.device.type == "cuda":
            key = tuple(None if a is None else (tuple(a.shape), a.dtype, a.device) for a in source)
            if key not in buffers:
                buffers.clear()
                buffers[key] = tuple(None if a is None else torch.empty_like(a) for a in source)
            for buf, a in zip(buffers[key], source):
                if a is not None:
                    buf.copy_(a)
            source = buffers[key]
        return runner.run(state, source, table)

    train_epoch.runner = runner
    return train_epoch


def make_train_superepoch(model, optimizer: Optimizer, ema_decay: float = 0.999,
                          ema_every_n: int = 1, ema_start_step: int = 0, accum: int = 1,
                          seed: int = 0) -> Callable:
    """superepoch(state, x, mask, cond, perms) -> losses (E, K): E epochs
    over the device-cached split (x, mask, cond: (N, ...), None where
    absent), epoch e's step k on the rows perms[e, k] ((E, K, B), or (E, K,
    A, B) with accumulation): each epoch's shuffle, the same
    `np.random.default_rng(seed + epoch)` permutation that the per-step path
    gathers, is gathered on the device step by step. One host read, of the
    losses, at the end."""
    runner = StepRunner(model, optimizer, ema_decay, ema_every_n, ema_start_step, accum, seed)

    def superepoch(state: TrainState, x, mask, cond, perms: np.ndarray) -> torch.Tensor:
        e, k = perms.shape[:2]
        losses = runner.run(state, (x, mask, cond), perms.reshape((e * k,) + perms.shape[2:]))
        return losses.reshape(e, k)

    superepoch.runner = runner
    return superepoch
