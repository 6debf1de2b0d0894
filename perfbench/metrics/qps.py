"""Requests answered in the window over the window's seconds."""


def read(ctx):
    n = len(ctx.window.answered())
    return n / ctx.window.seconds if n else None
