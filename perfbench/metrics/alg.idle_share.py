"""Algorithm 2: the device's idle time inside the program's ``prune``,
``select`` and ``gather`` spans, over the traced window (``spans``)."""

from perfbench import spans


def read(ctx):
    return spans.idle_share(ctx, spans.LOOP)
