"""95th percentile of the window's request latencies (CUDA events on the
card's clock, from before a request's compile to after its search)."""
import numpy as np


def read(ctx):
    if not ctx.latencies_s:
        return None
    return 1e3 * float(np.percentile(ctx.latencies_s, 95))
