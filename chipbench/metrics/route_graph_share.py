"""Share of the window's queries the router sent to the graph
(``SearchResult.routes``)."""
import numpy as np


def read(ctx):
    if ctx.routes is None or not len(ctx.routes):
        return None
    return float(np.mean(ctx.routes == "graph"))
