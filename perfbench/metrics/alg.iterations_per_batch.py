"""Algorithm 2: ``QueryResult.iterations`` (Algorithm 1's loop) once a
batch, the mean over the window's batches."""


def read(ctx):
    b = ctx.batches
    return sum(x["iterations"] for x in b) / len(b) if b else None
