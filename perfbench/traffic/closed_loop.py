"""Closed loop: ``clients`` threads, each sends ``requests_per_round``
requests of rank ``l`` through ``KnnServer.submit`` and waits for all of
them before it sends more.

Parameters: ``clients``, ``requests_per_round``, ``l``, ``warmup_rounds``
(rounds each client sends in set-up).  Client ``j``'s round ``r`` takes
the pool rows from ``(r * clients + j) * requests_per_round`` on, so the
same seed sends the same queries in the same rounds.  Every client
sends its first round, and starts no further round once ``seconds``
have passed; the window closes at the last answer, so it holds all the
work of every round sent in it.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
import time

from perfbench.window import ANSWER_WAIT_S, Request, Window, track


def _loop(server, pool, params, *, seconds=None, rounds=None,
          offset=0, clock=time.perf_counter) -> Window:
    clients = int(params["clients"])
    per = int(params["requests_per_round"])
    l = int(params["l"])
    t0 = clock()
    out = [[] for _ in range(clients)]

    def client(j):
        r = 0
        while rounds is None or r < rounds:
            if seconds is not None and r and clock() >= t0 + seconds:
                break
            base = offset + (r * clients + j) * per
            futs = []
            for i in range(per):
                idx = (base + i) % len(pool)
                t = clock()
                req = Request(index=idx, l=l, t_due=t, t_send=t)
                fut = server.submit(pool[idx], l)
                track(fut, req, server, clock)
                out[j].append(req)
                futs.append(fut)
            _, pending = cf.wait(futs, timeout=ANSWER_WAIT_S)
            if pending:
                return
            r += 1

    threads = [threading.Thread(target=client, args=(j,),
                                name=f"perfbench-client-{j}")
               for j in range(clients)]
    for t in threads:
        t.start()
    limit = (seconds or 0) + ANSWER_WAIT_S * ((rounds or 1) + 1)
    for t in threads:
        t.join(timeout=limit)
    reqs = [q for rs in out for q in rs]
    ends = [q.t_answer for q in reqs if q.t_answer is not None]
    return Window(t0=t0, t1=max(ends) if ends else clock(), requests=reqs)


def warmup(server, pool, params, seed: int) -> Window:
    """``warmup_rounds`` rounds of every client: the shapes the window
    uses, from the end of the pool (rows the window reaches last)."""
    per = int(params["clients"]) * int(params["requests_per_round"])
    rounds = int(params.get("warmup_rounds", 1))
    return _loop(server, pool, params, rounds=rounds,
                 offset=len(pool) - per * rounds)


def run(server, pool, params, seed: int, seconds: float) -> Window:
    return _loop(server, pool, params, seconds=seconds)
