"""Bounded sorted-merge: the beam-update primitive of the search hot path.

Algorithm 2's beam maintenance merges the (sorted, length-L) beam with the
<=C freshly-scored candidates of one expansion and keeps the best L.  The
beam is already sorted, so only the C candidates are sorted; two batched
``searchsorted`` rank passes give every entry its merged position, and the
entries are scattered straight into place.

Tie-breaking is identical to a stable argsort of ``[beam, candidates]``:
beam entries precede equal-valued candidates (``side='left'`` vs
``side='right'``), and both sides keep their own order.  The merged
positions are a permutation of 0..L+C-1, so the scatter writes an (B, L+C)
buffer and positions >= L are dropped by keeping its first L columns.

``bounded_sorted_merge_ref`` is the stable-argsort oracle.
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def _merge_positions(beam_d: Tensor, cand_sorted: Tensor
                     ) -> Tuple[Tensor, Tensor]:
    """Output position of each beam entry / sorted candidate:
    beam_d (B, L) ascending, cand_sorted (B, C) ascending ->
    (pos_beam (B, L), pos_cand (B, C)), a permutation of 0..L+C-1 per row."""
    l = beam_d.shape[-1]
    c = cand_sorted.shape[-1]
    rank_b = torch.searchsorted(cand_sorted.contiguous(), beam_d.contiguous(),
                                side="left")
    rank_c = torch.searchsorted(beam_d.contiguous(), cand_sorted.contiguous(),
                                side="right")
    pos_beam = torch.arange(l, device=beam_d.device)[None, :] + rank_b
    pos_cand = torch.arange(c, device=beam_d.device)[None, :] + rank_c
    return pos_beam, pos_cand


def bounded_sorted_merge(beam_d: Tensor, cand_d: Tensor,
                         beam_payload: Tuple[Tensor, ...] = (),
                         cand_payload: Tuple[Tensor, ...] = ()):
    """Merge a sorted beam with unsorted candidates, keep the best L.

    beam_d (B, L) ascending; cand_d (B, C) unsorted (+inf = absent).
    ``beam_payload`` / ``cand_payload`` are matching tuples of (B, L) /
    (B, C) tensors carried through the merge.  Returns
    ``(merged_d (B, L), merged_payloads)``: the first L entries of the
    stable ascending merge.
    """
    l = beam_d.shape[-1]
    b, c = cand_d.shape
    cand_order = torch.argsort(cand_d, dim=-1, stable=True)
    cand_sorted = torch.gather(cand_d, -1, cand_order)
    pos_beam, pos_cand = _merge_positions(beam_d, cand_sorted)

    def scatter(bv: Tensor, cv: Tensor) -> Tensor:
        out = torch.empty((b, l + c), dtype=bv.dtype, device=bv.device)
        out.scatter_(1, pos_beam, bv)
        out.scatter_(1, pos_cand, cv)
        return out[:, :l]

    merged_d = scatter(beam_d, cand_sorted)
    merged_payloads = tuple(
        scatter(bp, torch.gather(cp, -1, cand_order))
        for bp, cp in zip(beam_payload, cand_payload))
    return merged_d, merged_payloads


def bounded_sorted_merge_ref(beam_d: Tensor, cand_d: Tensor,
                             beam_payload: Tuple[Tensor, ...] = (),
                             cand_payload: Tuple[Tensor, ...] = ()):
    """Oracle: stable argsort of the concatenation, truncated to L."""
    l = beam_d.shape[-1]
    all_d = torch.cat([beam_d, cand_d], dim=-1)
    order = torch.argsort(all_d, dim=-1, stable=True)[:, :l]
    merged_d = torch.gather(all_d, -1, order)
    merged_payloads = tuple(
        torch.gather(torch.cat([bp, cp], dim=-1), -1, order)
        for bp, cp in zip(beam_payload, cand_payload))
    return merged_d, merged_payloads
