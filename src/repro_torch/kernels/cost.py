"""What each hand-written kernel must do: its FLOPs and the bytes it must
move (each input read once, each output written once), from its shapes
and the counts of its data.

One formula a kernel.  ``chip_smoke.py``'s bounds pass the counts of the
run's data (the valid ids, the distinct rows, the passing pairs, the
edges); a router given ``meta`` tensors passes the dense counts (every id
valid and distinct, every pair scored) and reports the result through
:func:`record_kernel` to whatever listens, the dry run's
``repro_torch.launch.op_cost.OpCounter``.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

# the listeners of record_kernel, innermost last: each is called as
# listener(name, flops, bytes, dtype)
LISTENERS: List[Callable] = []


def record_kernel(name: str, flops: float, nbytes: float,
                  dtype: torch.dtype = torch.float32) -> None:
    """Report one launch of a hand-written kernel, with its FLOPs and
    bytes, to every listener (a no-op when none listens)."""
    for listen in LISTENERS:
        listen(name, flops, nbytes, dtype)


def gather_distance_cost(b: int, m: int, n: int, d: int, *, valid: int,
                         rows: int) -> Tuple[float, float]:
    """ids (b, m), q (b, d), x (n, d): the ids, the queries and the
    ``rows`` distinct rows the valid ids name read once, the (b, m) fp32
    output written once; 3 flops per valid id and column."""
    return 3 * valid * d, 4 * (2 * b * m + b * d + rows * d)


def filtered_topk_cost(b: int, n: int, d: int, k: int, metric: str, *,
                       rows: int, pairs: int, q_bytes: int = 4,
                       x_bytes: int = 4) -> Tuple[float, float]:
    """q (b, d), x (n, d), mask (b, n): the mask (a byte per query and
    row), the queries, the ``rows`` rows some query passes (``x_bytes``
    an element: 2 for a 16-bit corpus) and the (ids, dists) output, each
    once; 2 d flops per passing (query, row) pair, plus 2 d per row read
    for |x|^2 under l2."""
    norms = 2 * d * rows if metric == "l2" else 0
    return (2 * d * pairs + norms,
            b * n + q_bytes * b * d + x_bytes * rows * d + 8 * b * k)


def pna_aggregate_cost(b: int, n: int, f: int, *, edges: int,
                       adj_bytes: int = 4, feat_bytes: int = 4
                       ) -> Tuple[float, float]:
    """adj (b, n, n), feats (b, n, f): adj and feats read once, the
    (b, n, 4f) output written once; 7 operations per (edge, feature)
    (h^2, two fused multiply-adds, max, min)."""
    return (7 * edges * f,
            adj_bytes * b * n * n + feat_bytes * (b * n * f + b * n * 4 * f))


def embedding_bag_cost(b: int, l: int, d: int, mode: str, *, valid: int,
                       rows: int, table_bytes: int = 4, id_bytes: int = 4
                       ) -> Tuple[float, float]:
    """ids (b, l), table (V, d): the ``rows`` distinct rows the valid ids
    name, the ids, and the (b, d) output, each once; one add per valid id
    and column, plus a division per output under mean."""
    return (valid * d + (b * d if mode == "mean" else 0),
            table_bytes * (rows * d + b * d) + id_bytes * b * l)


def neighbor_expand_dense_cost(b: int, cap: int, m: int, strategy: str,
                               m_beta: int, *, masked: bool,
                               visited: bool) -> Tuple[float, float]:
    """row (b, cap), every lane scanning its whole candidate stream of
    distinct valid ids: each stream entry (a 1-hop row entry or a table
    entry) read once, one ``pos`` lookup per expanded row, a pass-mask
    and a visited byte per candidate, the (b, m) output written once.  No
    arithmetic.  (``chip_smoke.neighbor_expand_bound`` counts the stream
    a run's data reaches before each lane stops, which this form
    bounds.)"""
    expanded = {"filter": 0, "compress": cap - m_beta,
                "two_hop": cap}[strategy]
    stream = cap + expanded * cap
    per_lane = 4 * (stream + expanded) + stream * (masked + visited)
    return 0, b * per_lane + 4 * b * m
