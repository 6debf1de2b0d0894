"""Kernels: the distance + top-l step's work bound (``work/topl_step``,
summed over the window's batches at their real rows) over the device
time of the activities launched inside its ranges (``trace``)."""

from perfbench.work import topl_step


def read(ctx):
    t = ctx.trace
    if not t or not t["step_device_s"] or not ctx.batches:
        return None
    bound = topl_step.window_bound_s(ctx.cell.config, ctx.batches,
                                     ctx.peaks)
    return 100.0 * bound / t["step_device_s"]
