"""ACORN predicate-subgraph traversal (paper Algorithms 1-2, Figure 4).

The greedy descent and the level-0 beam search run as explicitly batched
loops over fixed-size sorted beams; heaps and sets become fixed-shape
masked tensors.  The reference's ``lax.while_loop``s become host loops.
Their bodies are lane-guarded by ``active`` (a converged lane's state is
frozen), so an extra iteration changes nothing, and the loop tests for
termination only every :data:`CHECK_EVERY` iterations instead of
synchronising with the device on every hop.

Every hop issues one ``neighbor_expand`` (Figure 4 lookup) and one
``gather_distance`` over the whole batch, then a bounded sorted-merge
updates the beam.  Both ops route by device: CUDA tensors launch the
Hopper kernels, CPU tensors run their plain versions.  The visited set is
updated in place (the reference builds a new array per hop).

Neighbor-lookup strategies (Figure 4):
  'plain'    — the stored neighbor list, no predicate (HNSW).
  'filter'   — scan N^l(c), keep predicate-passing, truncate to M (ACORN-γ,
               uncompressed levels — Fig 4a).
  'compress' — first M_β entries filtered directly; remaining entries
               expanded to their own neighbor lists (2-hop recovery of
               pruned edges), filtered, truncated to M (Fig 4b).
  'two_hop'  — full 1-hop + 2-hop expansion, filter, truncate to M
               (ACORN-1 — Fig 4c).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.filtered_topk.merge import bounded_sorted_merge
from repro_torch.kernels.gather_distance.ops import gather_distance
from repro_torch.kernels.neighbor_expand.ops import neighbor_expand

from .graph import INVALID, LayeredGraph, neighbor_rows
from .plan import ExecutionSpec, resolve_execution_spec

Tensor = torch.Tensor

INF = float("inf")

# iterations between termination checks (each check syncs with the device)
CHECK_EVERY = 4

# greedy-descent step cap per upper level (as in the reference)
GREEDY_MAX_STEPS = 128


class SearchStats(NamedTuple):
    dist_comps: Tensor  # per-query number of distance computations
    hops: Tensor        # per-query number of expanded nodes (level 0)


# ---------------------------------------------------------------------------
# small fixed-shape helpers
# ---------------------------------------------------------------------------


def first_m_true(ids: Tensor, ok: Tensor, m: int) -> Tensor:
    """Pack the first m ids where ok, preserving order; -1 padded.
    (C,) -> (m,)."""
    rank = torch.cumsum(ok.to(torch.int64), dim=0) - 1
    scatter_to = torch.where(ok & (rank < m), rank, torch.full_like(rank, m))
    out = torch.full((m + 1,), INVALID, dtype=torch.int32, device=ids.device)
    out.scatter_(0, scatter_to,
                 torch.where(ok, ids, torch.full_like(ids, INVALID)))
    return out[:m]


def dedup_mask(ids: Tensor) -> Tensor:
    """True at the first occurrence of each valid id (order preserved)."""
    order = torch.argsort(ids, stable=True)
    s = ids[order]
    first_sorted = torch.cat([torch.ones(1, dtype=torch.bool,
                                         device=ids.device), s[1:] != s[:-1]])
    mask = torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
    mask[order] = first_sorted
    return mask & (ids >= 0)


# ---------------------------------------------------------------------------
# neighbor lookup (Figure 4)
# ---------------------------------------------------------------------------


def get_neighbors(graph: LayeredGraph, level: int, c: Tensor,
                  pass_mask: Optional[Tensor], strategy: str, m: int,
                  m_beta: int, visited: Optional[Tensor] = None) -> Tensor:
    """Up to ``m`` neighbor ids of node ``c`` (a 0-d id) for the query
    predicate.  ``pass_mask=None`` means "all nodes pass"; ``visited`` is
    applied before the first-M truncation."""
    row = neighbor_rows(graph, level, c)  # (cap,)
    if strategy == "plain":
        return row
    pm = None if pass_mask is None else pass_mask[None]
    vis = None if visited is None else visited[None]
    out = neighbor_expand(row[None], graph.neighbors[level], graph.pos[level],
                          pm, vis, strategy=strategy, m=m, m_beta=m_beta)
    return out[0]


def _strategy_for(variant: str, level: int, compressed_level0: bool) -> str:
    if variant == "hnsw":
        return "plain"
    if variant == "acorn-1":
        return "two_hop"
    if variant == "acorn-gamma":
        if level == 0 and compressed_level0:
            return "compress"
        return "filter"
    raise ValueError(variant)


def _batched_neighbors(graph, level, cs, pass_mask, strategy, m, m_beta,
                       visited=None):
    """get_neighbors over the query batch: (B,) ids -> (B, M), one
    ``neighbor_expand`` call for the whole batch."""
    rows = neighbor_rows(graph, level, cs)  # (B, cap)
    if strategy == "plain":
        return rows
    return neighbor_expand(rows, graph.neighbors[level], graph.pos[level],
                           pass_mask, visited, strategy=strategy, m=m,
                           m_beta=m_beta)


# ---------------------------------------------------------------------------
# the search itself
# ---------------------------------------------------------------------------


def _batch_dists(x: Tensor, ids: Tensor, xq: Tensor, metric: str) -> Tensor:
    """ids (B, M) int32 (-1 padded), xq (B, d) -> (B, M); invalid -> +inf.
    The single point where the search touches vector data."""
    return gather_distance(ids, xq, x, metric=metric)


def _mark_visited(visited: Tensor, ids: Tensor, ok: Tensor,
                  anchor: Tensor) -> None:
    """visited[b, ids[b, j]] = True where ok, in place and without a host
    sync: entries not ok are redirected to the lane's ``anchor`` column,
    which is already True, so every write stores True and duplicate
    targets cannot race."""
    tgt = torch.where(ok, ids.long(), anchor[:, None].expand_as(ids))
    visited.scatter_(1, tgt, True)


def _greedy_level(graph, x, level, e, ed, xq, pass_mask, strategy, m,
                  m_beta, metric, max_steps, dc):
    """Batched ef=1 greedy descent at one level (Algorithm 1 upper levels).

    e (B,) current nodes, ed (B,) their distances; a lane freezes once its
    own step stops improving."""
    b = e.shape[0]
    moved = torch.ones((b,), dtype=torch.bool, device=e.device)
    it = torch.zeros((b,), dtype=torch.int32, device=e.device)
    step = 0
    while True:
        active = moved & (it < max_steps)
        if step % CHECK_EVERY == 0 and not bool(active.any()):
            break
        step += 1
        nbrs = _batched_neighbors(graph, level, e, pass_mask, strategy, m,
                                  m_beta)
        d = _batch_dists(x, nbrs, xq, metric)
        dc2 = dc + (nbrs >= 0).sum(dim=1, dtype=torch.int32)
        j = torch.argmin(d, dim=1, keepdim=True)
        dj = torch.gather(d, 1, j)[:, 0]
        nj = torch.gather(nbrs, 1, j)[:, 0]
        better = dj < ed
        e = torch.where(active & better, nj, e)
        ed = torch.where(active & better, dj, ed)
        moved = torch.where(active, better, moved)
        it = torch.where(active, it + 1, it)
        dc = torch.where(active, dc2, dc)
    return e, ed, dc


def _lane_cond(beam_ids, beam_d, beam_exp, it, max_expansions):
    unexp = (beam_ids >= 0) & ~beam_exp
    any_unexp = unexp.any(dim=1)
    best_unexp = torch.where(unexp, beam_d, INF).amin(dim=1)
    full = (beam_ids >= 0).all(dim=1)
    worst = torch.where(full, beam_d.amax(dim=1), INF)
    return any_unexp & (best_unexp <= worst) & (it < max_expansions)


def _search_impl(
    graph: LayeredGraph,
    x: Tensor,
    xq: Tensor,
    pass_mask: Optional[Tensor],
    k: int,
    ef: int,
    variant: str,
    m: int,
    m_beta: int,
    metric: str,
    compressed_level0: bool,
    max_expansions: int,
    spec: ExecutionSpec = ExecutionSpec(),
) -> Tuple[Tensor, Tensor, SearchStats]:
    """Batched hybrid search: xq (B, d), pass_mask (B, n) bool or None.

    ``spec`` is dispatch-layer policy and is not read here: kernel routing
    follows the tensors' device."""
    dev = xq.device
    b = xq.shape[0]
    n = x.shape[0]
    top = graph.num_levels - 1
    rows = torch.arange(b, device=dev)
    e = graph.entry_point.to(device=dev, dtype=torch.int32).reshape(1) \
        .repeat(b)
    ed = _batch_dists(x, e[:, None], xq, metric)[:, 0]
    dc = torch.ones((b,), dtype=torch.int32, device=dev)

    # ---- upper levels: greedy descent (Algorithm 1) ----
    for lvl in range(top, 0, -1):
        strat = _strategy_for(variant, lvl, compressed_level0)
        e, ed, dc = _greedy_level(graph, x, lvl, e, ed, xq, pass_mask, strat,
                                  m, m_beta, metric, GREEDY_MAX_STEPS, dc)

    # ---- level 0: beam search (Algorithm 2) ----
    strat0 = _strategy_for(variant, 0, compressed_level0)
    e_safe = e.clamp(0, n - 1).long()
    beam_ids = torch.full((b, ef), INVALID, dtype=torch.int32, device=dev)
    beam_ids[:, 0] = e
    beam_d = torch.full((b, ef), INF, dtype=torch.float32, device=dev)
    beam_d[:, 0] = ed
    beam_exp = torch.zeros((b, ef), dtype=torch.bool, device=dev)
    if pass_mask is None:
        e_pass = torch.ones((b,), dtype=torch.bool, device=dev)
    else:
        e_pass = torch.gather(pass_mask, 1, e_safe[:, None])[:, 0] & (e >= 0)
    beam_pass = torch.zeros((b, ef), dtype=torch.bool, device=dev)
    beam_pass[:, 0] = e_pass
    visited = torch.zeros((b, n), dtype=torch.bool, device=dev)
    visited[rows, e_safe] = True

    # Multi-seed: the predicate-passing members of the landing point's
    # level-1 neighborhood seed the beam too (ef must be > m).
    if pass_mask is not None and graph.num_levels > 1 and ef > m:
        strat1 = _strategy_for(variant, 1, compressed_level0)
        seeds = _batched_neighbors(graph, 1, e, pass_mask, strat1, m, m_beta)
        seeds = seeds[:, :m]  # 'plain' rows may be wider than m
        s = seeds.shape[1]
        sd = _batch_dists(x, seeds, xq, metric)
        dc = dc + (seeds >= 0).sum(dim=1, dtype=torch.int32)
        dup = seeds == e[:, None]
        sd = torch.where(dup, INF, sd)
        beam_ids[:, 1:s + 1] = torch.where(dup, INVALID, seeds)
        beam_d[:, 1:s + 1] = sd
        beam_pass[:, 1:s + 1] = (seeds >= 0) & ~dup
        _mark_visited(visited, seeds.clamp(0, n - 1), seeds >= 0, e_safe)

    # the bounded sorted-merge keeps a sorted beam; establish the
    # invariant once (stable: ties keep insertion order)
    order0 = torch.argsort(beam_d, dim=1, stable=True)
    beam_ids = torch.gather(beam_ids, 1, order0)
    beam_d = torch.gather(beam_d, 1, order0)
    beam_pass = torch.gather(beam_pass, 1, order0)

    it = torch.zeros((b,), dtype=torch.int32, device=dev)
    step = 0
    while True:
        active = _lane_cond(beam_ids, beam_d, beam_exp, it, max_expansions)
        if step % CHECK_EVERY == 0 and not bool(active.any()):
            break
        step += 1
        unexp = (beam_ids >= 0) & ~beam_exp
        sel = torch.argmin(torch.where(unexp, beam_d, INF), dim=1,
                           keepdim=True)
        c = torch.gather(beam_ids, 1, sel)[:, 0]
        beam_exp2 = beam_exp.scatter(1, sel, True)

        nbrs = _batched_neighbors(graph, 0, c, pass_mask, strat0, m, m_beta,
                                  visited=visited)
        safe = nbrs.clamp(0, n - 1)
        fresh = (nbrs >= 0) & ~torch.gather(visited, 1, safe.long())
        nd = torch.where(fresh, _batch_dists(x, nbrs, xq, metric), INF)
        dc2 = dc + fresh.sum(dim=1, dtype=torch.int32)
        _mark_visited(visited, safe, (nbrs >= 0) & active[:, None], e_safe)

        # bounded sorted-merge into the beam: only the M candidates sort
        cand_ids = torch.where(fresh, nbrs, INVALID)
        merged_d, (m_ids, m_exp, m_pass) = bounded_sorted_merge(
            beam_d, nd, (beam_ids, beam_exp2, beam_pass),
            (cand_ids, torch.zeros_like(fresh), fresh))
        lane = active[:, None]
        beam_ids = torch.where(lane, m_ids, beam_ids)
        beam_d = torch.where(lane, merged_d, beam_d)
        beam_exp = torch.where(lane, m_exp, beam_exp)
        beam_pass = torch.where(lane, m_pass, beam_pass)
        it = torch.where(active, it + 1, it)
        dc = torch.where(active, dc2, dc)

    # final top-k among predicate-passing beam entries
    final_d = torch.where(beam_pass & (beam_ids >= 0), beam_d, INF)
    order = torch.argsort(final_d, dim=1, stable=True)[:, :k]
    out_d = torch.gather(final_d, 1, order)
    out_ids = torch.where(torch.isfinite(out_d),
                          torch.gather(beam_ids, 1, order), INVALID)
    return out_ids, out_d, SearchStats(dist_comps=dc, hops=it)


def hybrid_search(
    graph: LayeredGraph,
    x: Tensor,
    xq: Tensor,
    pass_mask: Optional[Tensor],
    k: int = 10,
    ef: int = 64,
    variant: str = "acorn-gamma",
    m: int = 16,
    m_beta: int = 32,
    metric: str = "l2",
    compressed_level0: bool = True,
    max_expansions: int = 512,
    spec: Optional[ExecutionSpec] = None,
    use_kernel: Optional[bool] = None,
    interpret: Optional[bool] = None,
    expand_kernel: Optional[bool] = None,
):
    """Batched hybrid search on the tensors' device.

    xq: (B, d) queries; pass_mask: (B, n) predicate masks.  The retired
    ``use_kernel``/``interpret``/``expand_kernel`` kwargs raise
    ``TypeError``.  Returns ids (B, k), dists (B, k), SearchStats with
    (B,) fields.
    """
    spec = resolve_execution_spec(
        spec, "hybrid_search", use_kernel=use_kernel, interpret=interpret,
        expand_kernel=expand_kernel)
    return _search_impl(graph, x, xq, pass_mask, k, ef, variant, m, m_beta,
                        metric, compressed_level0, max_expansions, spec)


def ann_search(
    graph: LayeredGraph,
    x: Tensor,
    xq: Tensor,
    k: int = 10,
    ef: int = 64,
    m: int = 32,
    metric: str = "l2",
    max_expansions: int = 512,
    spec: Optional[ExecutionSpec] = None,
    use_kernel: Optional[bool] = None,
    interpret: Optional[bool] = None,
):
    """Plain (unfiltered) HNSW ANN search — baseline substrate."""
    spec = resolve_execution_spec(
        spec, "ann_search", use_kernel=use_kernel, interpret=interpret)
    return _search_impl(graph, x, xq, None, k, ef, "hnsw", m, 0, metric,
                        False, max_expansions, spec)
