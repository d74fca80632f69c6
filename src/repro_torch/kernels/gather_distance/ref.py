"""Plain PyTorch version of the gather_distance kernel."""
from __future__ import annotations

import torch


def gather_distance_ref(ids: torch.Tensor, q: torch.Tensor, x: torch.Tensor,
                        metric: str = "l2") -> torch.Tensor:
    """ids (B, M) int32 (-1 padded), q (B, d), x (n, d) -> (B, M) f32.

    Distances to invalid ids are +inf.  l2 = squared L2 by direct
    difference; ip = negated inner product (lower = better, matching the
    beam-search ordering).  Ids are clipped into [0, n-1] before the row
    gather."""
    safe = ids.clamp(0, x.shape[0] - 1).long()
    rows = x[safe]  # (B, M, d)
    if metric == "l2":
        d = ((rows - q[:, None, :]) ** 2).sum(dim=-1)
    elif metric == "ip":
        d = -torch.einsum("bmd,bd->bm", rows, q)
    else:
        raise ValueError(metric)
    return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))
