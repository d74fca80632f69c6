"""Mean distance computations of a graph-routed query in the window
(``SearchResult.stats["dist_comps"]``)."""
import numpy as np


def read(ctx):
    if ctx.routes is None:
        return None
    graph = ctx.routes == "graph"
    if not graph.any():
        return None
    return float(np.mean(ctx.dist_comps[graph]))
