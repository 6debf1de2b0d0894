"""Serving: the device's idle time inside the program's ``snapshot``,
``route``, ``resolve`` and ``shadow_audit`` spans, the self time of
``dispatch`` and between dispatches, over the traced window
(``spans``)."""

from perfbench import spans


def read(ctx):
    return spans.idle_share(ctx, spans.SERVE)
