"""Device: one minus the union of the device's activity over the traced
window (``trace.summarize``)."""


def read(ctx):
    t = ctx.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
