"""Faults planted under the timed path, each a ``search_wrapper`` for
``harness.run_cell``: ``fault(index) -> search``.  A sound check reads
``correct`` false under every one that the cell can have
(``tests/test_chipbench_control.py`` on the CPU, ``control.py --paths
<fault>`` on the card at the cell's own size)."""
from dataclasses import replace


def stale(index):
    """Each request gets the answer of the request before it."""
    last = []

    def search(req):
        res = index.search(req)
        out = last[0] if last else res
        last[:] = [res]
        return out
    return search


def half(index):
    """The second half of each batch left out: no answers for it."""
    def search(req):
        res = index.search(req)
        b = res.ids.shape[0]
        ids, d = res.ids.clone(), res.dists.clone()
        ids[b // 2:] = -1
        d[b // 2:] = float("inf")
        return replace(res, ids=ids, dists=d)
    return search


def altered(index):
    """One answer of each request altered where it is produced."""
    def search(req):
        res = index.search(req)
        ids = res.ids.clone()
        ids[0, 0] = (ids[0, 0] + 1) % index.x.shape[0]
        return replace(res, ids=ids)
    return search


def ef_k(index):
    """The graph search's beam cut to k: passing rows at their true
    distances, fewer of the true neighbours."""
    def search(req):
        return index.search(replace(req, ef=req.k))
    return search


def one_hop(index):
    """The level-0 search stopped after its first expansion."""
    def search(req):
        cfg = index.config
        index.config = replace(cfg, max_expansions=1)
        try:
            return index.search(req)
        finally:
            index.config = cfg
    return search


FAULTS = {f.__name__: f for f in (stale, half, altered, ef_k, one_hop)}
# faults that only the graph route can have
GRAPH_ONLY = ("ef_k", "one_hop")
