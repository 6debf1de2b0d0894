"""Algorithm 2: ``QueryResult.host_syncs`` once a batch (the Algorithm 1
loop's done checks and the readbacks), the mean over the window's
batches."""


def read(ctx):
    b = ctx.batches
    return sum(x["host_syncs"] for x in b) / len(b) if b else None
