"""Traffic: the 99th percentile of the open loop's lateness, send time
less due time (``Window.lateness_s``): how late the sender ran, which
the server's thread can cause through the GIL.  None where the loop
keeps no lateness (a closed loop)."""

import numpy as np


def read(ctx):
    late = getattr(ctx.window, "lateness_s", None)
    return float(np.quantile(late, 0.99)) * 1e3 if late else None
