"""Algorithm 2: the serving thread's kernel launches inside the
program's ``select`` spans over those spans, one a batch (``spans``).
None unless the run kept the program's spans whole and aligned."""

from perfbench import spans


def read(ctx):
    s = spans.sound(ctx)
    if s is None or not s["select_spans"]:
        return None
    return s["select_launches"] / s["select_spans"]
