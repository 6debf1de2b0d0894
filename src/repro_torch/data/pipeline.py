"""Input pipeline with prefetch: the straggler-absorbing layer.

Port of ``repro.data.pipeline``:
  * a background thread fills a bounded queue (depth ``prefetch``), so a
    transient host hiccup is absorbed by the buffer instead of the step;
  * each batch's produce time is kept (``produce_times``) for the
    runtime's ``StepWatchdog``;
  * with ``device``, the producer turns each numpy array into a tensor
    in pinned host memory and the consumer (``__next__``) issues
    ``.to(device, non_blocking=True)``, so the copy to the card overlaps
    the step before it (the reference's consumer-side ``device_put``).
    Without ``device``, batches come as ``make_batch`` made them.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator

import numpy as np
import torch


class Prefetcher:
    def __init__(self, make_batch: Callable[[int], dict], *,
                 start_step: int = 0, prefetch: int = 2, device=None):
        self._make = make_batch
        self._device = None if device is None else torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._step = start_step
        self._stop = threading.Event()
        self.produce_times: list[float] = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _host(self, v):
        t = torch.from_numpy(np.asarray(v))
        return t.pin_memory() if self._device.type == "cuda" else t

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            t0 = time.perf_counter()
            batch = self._make(step)
            if self._device is not None:
                batch = {k: self._host(v) for k, v in batch.items()}
            self.produce_times.append(time.perf_counter() - t0)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        if self._device is not None:
            batch = {k: v.to(self._device, non_blocking=True)
                     for k, v in batch.items()}
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
