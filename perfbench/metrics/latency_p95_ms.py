"""The 95th percentile of every answered request's latency, from when it
was due to its answer (a closed loop's requests are due when sent)."""

import numpy as np


def read(ctx):
    lat = [r.latency_s for r in ctx.window.answered()]
    return float(np.quantile(lat, 0.95)) * 1e3 if lat else None
