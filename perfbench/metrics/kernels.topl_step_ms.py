"""Kernels: the distance + top-l step's device time a batch, by the CUDA
events the server records around it (``ServerStats.topl_device_s``,
summed over the window's batches, over their count).  None where the
server keeps no such sum or read no device time (the CPU)."""


def read(ctx):
    if "topl_device_s" not in ctx.stats1:
        return None
    n = ctx.stats1["batches"] - ctx.stats0["batches"]
    s = ctx.stats1["topl_device_s"] - ctx.stats0["topl_device_s"]
    return 1e3 * s / n if n and s > 0 else None
