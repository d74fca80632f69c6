"""Plain PyTorch version of the fused 2-hop neighbor expansion.

Gather the 2-hop candidate lists, apply the predicate/visited filter, keep
the first occurrence of each id, pack the first M in candidate order.  Two
dedups give identical results: a sort-free scatter-min of candidate
positions into an id-indexed (B, n) tile (:func:`first_occurrence_mask`)
and the stable-argsort formulation (:func:`_dedup_argsort`);
:func:`use_scatter_dedup` picks one by cost.  They agree because the
predicate/visited test is a pure function of the id, so "first passing
occurrence" equals "first occurrence that passes".  Ids must lie in
[-1, n).

Candidate scan order (Figure 4; the CUDA kernel follows it exactly):

  'filter'   — the 1-hop row itself; no dedup (ACORN-γ uncompressed).
  'compress' — row[:m_beta], then per tail entry t: [t, N(t)] row-major.
  'two_hop'  — row, then the j-th 2-hop neighbor of *every* 1-hop node
               before the (j+1)-th of any (breadth-first interleave).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

Tensor = torch.Tensor

INVALID = -1

# scatter-min dedup pays O(B * n) tile writes; stable argsort pays
# O(B * C log C) n-independent compares.  Crossover constant kept from the
# reference so both packages pick the same formulation per shape.
SCATTER_DEDUP_FACTOR = 8


def use_scatter_dedup(n: int, c: int) -> bool:
    """Cost choice between the two identical dedups."""
    return n <= SCATTER_DEDUP_FACTOR * c * math.log2(max(c, 2))


def _gather_rows(nbr_table: Tensor, pos: Tensor, gids: Tensor) -> Tensor:
    """Neighbor rows for global ids: (...,) -> (..., cap); ids absent from
    the level (``pos`` -1) or invalid (< 0) yield all -1 rows."""
    n = pos.shape[0]
    cap = nbr_table.shape[1]
    if nbr_table.shape[0] == 0:
        return torch.full(gids.shape + (cap,), INVALID, dtype=torch.int32,
                          device=gids.device)
    r = pos[gids.clamp(0, n - 1).long()]
    present = (gids >= 0) & (r >= 0)
    rows = nbr_table[r.clamp(0, nbr_table.shape[0] - 1).long()]
    return torch.where(present[..., None], rows, torch.full_like(rows, INVALID))


def expansion_candidates(row: Tensor, nbr_table: Tensor, pos: Tensor,
                         strategy: str, m_beta: int) -> Tensor:
    """Materialize the (B, C) candidate array in scan order."""
    if strategy == "filter":
        return row
    if strategy == "compress":
        head, tail = row[:, :m_beta], row[:, m_beta:]
        hop2 = _gather_rows(nbr_table, pos, tail)          # (B, T, cap)
        two = torch.cat([tail[..., None], hop2], dim=2)
        return torch.cat([head, two.flatten(1)], dim=1)
    if strategy == "two_hop":
        hop2 = _gather_rows(nbr_table, pos, row)           # (B, cap, cap)
        inter = hop2.transpose(1, 2).flatten(1)
        return torch.cat([row, inter], dim=1)
    raise ValueError(strategy)


def _passes(cand: Tensor, pass_mask: Optional[Tensor],
            visited: Optional[Tensor]) -> Tensor:
    """Validity + predicate + not-visited, all pure functions of the id."""
    ok = cand >= 0
    if pass_mask is not None:
        safe = cand.clamp(0, pass_mask.shape[1] - 1).long()
        ok = ok & torch.gather(pass_mask, 1, safe)
    if visited is not None:
        safe = cand.clamp(0, visited.shape[1] - 1).long()
        ok = ok & ~torch.gather(visited, 1, safe)
    return ok


def first_occurrence_mask(ids: Tensor, n: int) -> Tensor:
    """True at the first occurrence of each valid id — sort-free.

    (B, C) int32 ids in [-1, n) -> (B, C) bool: scatter-min of each
    candidate's position into an id-indexed (B, n) tile, gather back, and a
    candidate is first iff its position IS the minimum for its id."""
    b, c = ids.shape
    safe = ids.clamp(0, n - 1).long()
    posn = torch.arange(c, dtype=torch.int32, device=ids.device).expand(b, c)
    src = torch.where(ids >= 0, posn, torch.full_like(posn, c))
    first = torch.full((b, n), c, dtype=torch.int32, device=ids.device)
    first.scatter_reduce_(1, safe, src, reduce="amin", include_self=True)
    return (ids >= 0) & (torch.gather(first, 1, safe) == posn)


def _dedup_argsort(ids: Tensor) -> Tensor:
    """Dedup by stable argsort + sorted-run first (batched)."""
    order = torch.argsort(ids, dim=1, stable=True)
    s = torch.gather(ids, 1, order)
    first_sorted = torch.cat(
        [torch.ones_like(s[:, :1], dtype=torch.bool), s[:, 1:] != s[:, :-1]],
        dim=1)
    mask = torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
    mask.scatter_(1, order, first_sorted)
    return mask & (ids >= 0)


def first_m_true_batched(ids: Tensor, ok: Tensor, m: int) -> Tensor:
    """Pack the first m ids where ok, in order, -1 padded: (B, C) -> (B, m).

    Ranks >= m go to a spare column m that is dropped afterwards (the
    reference's ``mode="drop"`` scatter)."""
    b = ids.shape[0]
    rank = torch.cumsum(ok.to(torch.int64), dim=1) - 1
    scatter_to = torch.where(ok & (rank < m), rank, torch.full_like(rank, m))
    out = torch.full((b, m + 1), INVALID, dtype=torch.int32, device=ids.device)
    out.scatter_(1, scatter_to, torch.where(ok, ids, torch.full_like(ids, INVALID)))
    return out[:, :m]


def _expand(row, nbr_table, pos, pass_mask, visited, strategy, m, m_beta,
            argsort_only: bool) -> Tensor:
    m = max(m, 0)
    cand = expansion_candidates(row, nbr_table, pos, strategy, m_beta)
    ok = _passes(cand, pass_mask, visited)
    if strategy != "filter":   # filter scans a duplicate-free stored row
        n = pos.shape[0]
        if not argsort_only and use_scatter_dedup(n, cand.shape[1]):
            ok = ok & first_occurrence_mask(cand, n)
        else:
            ok = ok & _dedup_argsort(cand)
    return first_m_true_batched(cand, ok, m)


def neighbor_expand_ref(row: Tensor, nbr_table: Tensor, pos: Tensor,
                        pass_mask: Optional[Tensor] = None,
                        visited: Optional[Tensor] = None, *, strategy: str,
                        m: int, m_beta: int = 0) -> Tensor:
    """Fused expansion, plain PyTorch (scatter-min or argsort dedup by cost).

    row (B, cap) int32 1-hop ids (-1 padded); nbr_table (n_l, cap) level
    neighbor table; pos (n,) global id -> level row (-1 absent);
    pass_mask / visited (B, n) bool or None -> (B, m) int32 ids.
    """
    return _expand(row, nbr_table, pos, pass_mask, visited, strategy, m,
                   m_beta, argsort_only=False)


def neighbor_expand_argsort(row: Tensor, nbr_table: Tensor, pos: Tensor,
                            pass_mask: Optional[Tensor] = None,
                            visited: Optional[Tensor] = None, *,
                            strategy: str, m: int, m_beta: int = 0) -> Tensor:
    """The same expansion with the argsort dedup always (test oracle)."""
    return _expand(row, nbr_table, pos, pass_mask, visited, strategy, m,
                   m_beta, argsort_only=True)
