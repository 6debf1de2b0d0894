"""Algorithm 2: the Algorithm 1 loop's wall a batch
(``ServerStats.select_s``, summed over the window's batches, over their
count): on the card the stream's, between CUDA events at the loop's two
ends, which leaves out the host's wait for the distance + top-l step
that the loop's first sync makes.  None where the server keeps no such
sum."""


def read(ctx):
    if "select_s" not in ctx.stats1:
        return None
    n = ctx.stats1["batches"] - ctx.stats0["batches"]
    s = ctx.stats1["select_s"] - ctx.stats0["select_s"]
    return 1e3 * s / n if n else None
