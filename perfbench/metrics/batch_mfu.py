"""Device, whole batch: the distance + top-l step's work bound summed
over the window's batches, over the traced window's seconds: the share
of the chip's peak that the whole served batch reaches, whatever
kernels carry the step."""

from perfbench.work import topl_step


def read(ctx):
    t = ctx.trace
    if not t or t["window_s"] <= 0 or not ctx.batches:
        return None
    bound = topl_step.window_bound_s(ctx.cell.config, ctx.batches,
                                     ctx.peaks)
    return 100.0 * bound / t["window_s"]
