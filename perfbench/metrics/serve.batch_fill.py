"""Serving: real rows over the dispatched bucket rows of the window,
from ``ServerStats.queries`` and ``padded_rows``."""


def read(ctx):
    real = ctx.stats1["queries"] - ctx.stats0["queries"]
    pad = ctx.stats1["padded_rows"] - ctx.stats0["padded_rows"]
    return 100.0 * real / (real + pad) if real else None
