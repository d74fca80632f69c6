"""Distributed primitives.  So far only the deterministic cross-shard top-k
merge that the serving engine's host loop runs on the device."""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def merge_topk(ids: Tensor, d: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Deterministic cross-shard top-k merge over concatenated candidates.

    ids (B, C) int32 global ids (-1 = invalid), d (B, C) distances (invalid
    candidates carry ``inf``).  Each row is ordered by the lexicographic
    (distance, global id) key — two stable sorts, by id and then by
    distance, as torch has no lexsort — so the merge is invariant to shard
    arrival order and equal-distance ties always resolve the same way
    (smallest global id first; -0.0 and +0.0 are equal).  Exact duplicate
    candidates — the same (id, distance) pair contributed twice, e.g. by a
    duplicate-dispatch mirror of a shard — are collapsed to one entry, so
    mirrored dispatch never crowds real neighbors out of the top k.
    Non-finite distances come back as id ``-1`` / ``inf``.
    """
    by_id = torch.argsort(ids, dim=1, stable=True)
    d1 = torch.gather(d, 1, by_id)
    order = torch.gather(by_id, 1, torch.argsort(d1, dim=1, stable=True))
    s_ids = torch.gather(ids, 1, order)
    s_d = torch.gather(d, 1, order)
    # exact (id, distance) duplicates are adjacent after the sort; keep the
    # first of each run (invalid entries are already id -1 / inf)
    dup = torch.zeros_like(s_ids, dtype=torch.bool)
    dup[:, 1:] = ((s_ids[:, 1:] == s_ids[:, :-1])
                  & (s_d[:, 1:] == s_d[:, :-1]) & (s_ids[:, 1:] >= 0))
    s_d = torch.where(dup, torch.full_like(s_d, float("inf")), s_d)
    # survivors are already (distance, id)-sorted; a stable sort floats the
    # invalidated duplicates past the real candidates without reordering
    order2 = torch.argsort(s_d, dim=1, stable=True)[:, :k]
    out_d = torch.gather(s_d, 1, order2)
    out_ids = torch.where(torch.isfinite(out_d),
                          torch.gather(s_ids, 1, order2),
                          torch.full_like(out_d, -1, dtype=ids.dtype))
    return out_ids, out_d
