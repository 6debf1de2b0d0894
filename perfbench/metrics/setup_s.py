"""Process start to the first timed request: imports, the points and
queries made on the card, the kernel library's load (and its build on
a checkout's first run), the server, and the warm-up traffic."""


def read(ctx):
    return ctx.setup_s
