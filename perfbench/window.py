"""What a traffic loop records of each request, and the window it ran in.

A request is timed by the host clock from ``t_due`` (when it was due:
the send itself in a closed loop, the scheduled arrival in an open
one) to ``t_answer``, stamped by the future's callback as the server
resolves it.  ``batch`` is the server's batch counter at that moment,
which names the carrying batch (the server resolves one batch's futures
before it dispatches the next).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

ANSWER_WAIT_S = 60.0     # how long past the close a late answer is awaited


@dataclass
class Request:
    index: int                       # row of the query pool
    l: int
    t_due: float
    t_send: float = 0.0
    t_answer: Optional[float] = None
    batch: int = -1
    dists: Optional[np.ndarray] = None
    ids: Optional[np.ndarray] = None
    iterations: int = 0
    host_syncs: int = 0
    queued_s: float = 0.0
    bucket: int = 0
    error: Optional[str] = None

    @property
    def answered(self) -> bool:
        return self.t_answer is not None and self.error is None

    @property
    def latency_s(self) -> float:
        return self.t_answer - self.t_due


@dataclass
class Window:
    t0: float                        # the first request was due
    t1: float                        # the last answer (or the close)
    requests: list = field(default_factory=list)
    lateness_s: list = field(default_factory=list)   # open loop: send - due

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def answered(self) -> list:
        return [r for r in self.requests if r.answered]


def track(future, req: Request, server, clock=time.perf_counter) -> None:
    """Stamp ``req`` when ``future`` resolves and keep what the checks
    and the readers need of its ``QueryResult``."""

    def done(f):
        req.t_answer = clock()
        req.batch = server.stats.batches
        exc = f.exception()
        if exc is not None:
            req.error = f"{type(exc).__name__}: {exc}"
            return
        res = f.result()
        req.dists, req.ids = res.dists, res.ids
        req.iterations, req.host_syncs = res.iterations, res.host_syncs
        req.queued_s, req.bucket = res.queued_s, res.bucket

    future.add_done_callback(done)
