"""Serving: the 95th percentile of ``QueryResult.queued_s`` (enqueue to
the dispatch of the request's batch) over the window's requests."""

import numpy as np


def read(ctx):
    q = [r.queued_s for r in ctx.window.answered()]
    return float(np.quantile(q, 0.95)) * 1e3 if q else None
