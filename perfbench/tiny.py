"""Tiny copies of the cells, for the CPU tests: the same files, with the
point set, the rounds, the query pool and the check's sample cut so
that a run takes a second or two with the kernels' plain versions."""

from __future__ import annotations

import copy

from perfbench import spec


def cell(name: str, *, n: int = 8 * 256, per_round: int = 8,
         sample: int = 16, **kw) -> spec.Cell:
    c = spec.cell(name, **kw)
    c.config = copy.deepcopy(c.config)
    c.workload = copy.deepcopy(c.workload)
    c.config["n_points"] = n
    c.config["data"]["params"]["chunk_rows"] = max(1, n // 3 + 1)
    params = c.workload["params"]
    if "requests_per_round" in params:
        params["requests_per_round"] = per_round
        params["warmup_rounds"] = 1
    c.workload["query_pool"] = 64
    c.workload["check"]["sample"] = sample
    return c
