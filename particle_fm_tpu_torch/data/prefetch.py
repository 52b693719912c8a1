"""Host-to-device prefetch for the streaming (not device-cached) train path;
counterpart of particle_fm_tpu/data/prefetch.py.

A worker thread prepares the next host batches and issues their copies to
the device while the device still computes the previous step, so that host
batch preparation and the copy overlap device work. `pinned_placer` gives
the placement the Trainer uses: page-locked host buffers and `non_blocking`
copies onto a CUDA device (a plain copy onto the CPU).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch


def pinned_placer(device: torch.device) -> Callable:
    """A function that places one (x, mask, cond) batch of numpy arrays (or
    None) on `device`."""

    def place(batch):
        out = []
        for a in batch:
            if a is None:
                out.append(None)
                continue
            t = torch.from_numpy(np.ascontiguousarray(a))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out.append(t)
        return tuple(out)

    return place


def prefetch_to_device(iterator: Iterable, place: Callable, depth: int = 2) -> Iterator:
    """Yield `place(item)` for each item, with up to `depth` (>= 1) placed
    items prepared ahead by a worker thread.

    `place` runs on the worker thread. A worker's exception is re-raised at
    the consumer's next pull. If the consumer leaves the generator early,
    the worker is told to stop and exits at its next queue hand-off.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    sentinel = object()
    err: list[BaseException] = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(place(item)):
                    return
        except BaseException as e:  # re-raised on the consumer's side
            err.append(e)
        finally:
            put(sentinel)

    t = threading.Thread(target=worker, daemon=True, name="prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        t.join(timeout=10)
