"""Gather baseline: the merge of the k shards' top-l a batch (the
all_gather of the ``(k, B, l)`` candidates and the reduction over k*l,
``ServerStats.merge_s`` summed over the window's batches, over their
count): on the card the stream's, between the CUDA events at the
``merge`` phase's two ends.  None where the server keeps no such sum or
ran no merge."""


def read(ctx):
    if "merge_s" not in ctx.stats1:
        return None
    n = ctx.stats1["batches"] - ctx.stats0["batches"]
    s = ctx.stats1["merge_s"] - ctx.stats0["merge_s"]
    return 1e3 * s / n if n and s > 0 else None
