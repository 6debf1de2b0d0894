"""Open loop: requests of rank ``l``, one query each, sent on a schedule
drawn from the seed whatever the server does.

Parameters: ``rate`` (requests a second, Poisson arrivals) and ``l``.
Each request is timed from when it was due; how late the sender ran
(send - due) is kept as ``Window.lateness_s``.  Set-up sends one burst
of each bucket size, so every bucket shape is warm.
"""

from __future__ import annotations

import concurrent.futures as cf
import time

import numpy as np

from perfbench.seeds import sub_seed
from perfbench.window import ANSWER_WAIT_S, Request, Window, track


def schedule(params, seed: int, seconds: float) -> np.ndarray:
    """Due times, in seconds from the window's start."""
    rng = np.random.default_rng(sub_seed(seed, "arrivals"))
    rate = float(params["rate"])
    n = int(seconds * rate * 1.2) + 16
    t = np.cumsum(rng.exponential(1.0 / rate, n))
    while t[-1] < seconds:
        t = np.concatenate([t, t[-1] + np.cumsum(
            rng.exponential(1.0 / rate, n))])
    return t[t < seconds]


def warmup(server, pool, params, seed: int) -> Window:
    l = int(params["l"])
    reqs = []
    t0 = time.perf_counter()
    row = len(pool)
    for b in server.cfg.bucket_sizes:
        futs = []
        for _ in range(b):
            row -= 1
            t = time.perf_counter()
            req = Request(index=row % len(pool), l=l, t_due=t, t_send=t)
            fut = server.submit(pool[req.index], l)
            track(fut, req, server)
            reqs.append(req)
            futs.append(fut)
        cf.wait(futs, timeout=ANSWER_WAIT_S)
    ends = [q.t_answer for q in reqs if q.t_answer is not None]
    return Window(t0=t0, t1=max(ends) if ends else time.perf_counter(),
                  requests=reqs)


def run(server, pool, params, seed: int, seconds: float) -> Window:
    l = int(params["l"])
    due = schedule(params, seed, seconds)
    clock = time.perf_counter
    t0 = clock()
    reqs, futs, late = [], [], []
    for i, dt in enumerate(due):
        t_due = t0 + float(dt)
        wait = t_due - clock()
        if wait > 0:
            time.sleep(wait)
        idx = i % len(pool)
        req = Request(index=idx, l=l, t_due=t_due, t_send=clock())
        fut = server.submit(pool[idx], l)
        track(fut, req, server, clock)
        late.append(req.t_send - t_due)
        reqs.append(req)
        futs.append(fut)
    cf.wait(futs, timeout=ANSWER_WAIT_S)
    ends = [q.t_answer for q in reqs if q.t_answer is not None]
    return Window(t0=t0, t1=max(ends + [t0 + seconds]), requests=reqs,
                  lateness_s=late)
