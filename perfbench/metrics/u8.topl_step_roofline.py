"""Kernels, uint8 points: the uint8 distance + top-l step's work bound
(``work/topl_step_u8``: the int8 tensor peak and the memory's, summed over
the window's batches at their real rows) over the device time of the
activities launched inside the step's ranges (``trace``).  None where the
run traced no step."""

from perfbench.work import topl_step_u8


def read(ctx):
    t = ctx.trace
    if not t or not t["step_device_s"] or not ctx.batches:
        return None
    bound = topl_step_u8.window_bound_s(ctx.cell.config, ctx.batches,
                                        ctx.peaks)
    return 100.0 * bound / t["step_device_s"]
