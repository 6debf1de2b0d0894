"""Serving: real rows a dispatched batch over the window, from
``ServerStats.queries`` and ``batches``.  Under an open loop below its
knee a batch holds what arrived during the one before, so this reads
about the offered rate times the batch wall: it falls as the step or
the linger gets shorter, with the latency.  How full the buckets run is
``serve.batch_fill``."""


def read(ctx):
    n = ctx.stats1["batches"] - ctx.stats0["batches"]
    real = ctx.stats1["queries"] - ctx.stats0["queries"]
    return real / n if n else None
