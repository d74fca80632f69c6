"""Exact (masked) top-k distance search, in plain PyTorch.

The substrate of pre-filtering (paper §3.2), ground-truth generation and
the exact KNN inside the bulk builder.  Distances are squared L2 in the
expanded form ``|q|^2 + |x|^2 - 2 q.x``; ``metric='ip'`` covers
inner-product corpora.

Tie rule: the lower id wins a tie in score, as in the reference (its
running top-k keeps the best-so-far before each block and ``lax.top_k``
keeps the lower index).  ``torch.topk`` promises no order among ties, so
:func:`_topk_lowid` re-sorts the selection on (score, id) and redoes any
row whose boundary value is tied beyond the selection with a full stable
sort.  :func:`masked_topk` is also the plain version of the filtered_topk
kernel (``kernels/filtered_topk/ref.py``).

Sign of ``metric='ip'``: :func:`masked_topk` returns **+q.x** for ip, as
the reference does, while ``gather_distance`` (the graph route) returns
-q.x.  So a ``HybridIndex`` with ``metric='ip'`` mixes signs across routes.
The port reproduces the reference here and does not fix it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor

NEG_INF = float("-inf")

# score-block budget (elements) of one masked_topk step
_BLOCK_ELEMS = 1 << 28


def pairwise_sq_l2(q: Tensor, x: Tensor) -> Tensor:
    """(B, d), (n, d) -> (B, n) squared L2 distances (expanded form)."""
    qn = (q * q).sum(dim=-1, keepdim=True)
    xn = (x * x).sum(dim=-1)
    return qn + xn[None, :] - (2.0 * q) @ x.T


def _scores(q: Tensor, x: Tensor, metric: str) -> Tensor:
    """Higher is better."""
    if metric == "l2":
        return -pairwise_sq_l2(q, x)
    if metric == "ip":
        return q @ x.T
    raise ValueError(metric)


def _topk_lowid(s: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Top-k of each row of ``s`` (B, n) by (score desc, index asc)."""
    vals, idx = torch.topk(s, k, dim=1, largest=True, sorted=True)
    # order ties inside the selection by index
    o = torch.argsort(idx, dim=1)
    vals, idx = torch.gather(vals, 1, o), torch.gather(idx, 1, o)
    o = torch.argsort(vals, dim=1, descending=True, stable=True)
    vals, idx = torch.gather(vals, 1, o), torch.gather(idx, 1, o)
    # a tie at the boundary may have left out a lower index: redo such rows
    kth = vals[:, -1:]
    bad = ((s >= kth).sum(dim=1) > k) & (kth[:, 0] > NEG_INF)
    if bool(bad.any()):
        rows = bad.nonzero()[:, 0]
        sv, si = torch.sort(s[rows], dim=1, descending=True, stable=True)
        vals[rows], idx[rows] = sv[:, :k], si[:, :k]
    return vals, idx


def masked_topk(q: Tensor, x: Tensor, mask: Optional[Tensor], k: int,
                metric: str = "l2") -> Tuple[Tensor, Tensor]:
    """Exact top-k over rows of ``x`` passing ``mask``.

    q (B, d) queries; x (n, d) corpus; mask (B, n) bool or None (None =
    unfiltered).  Returns (ids, dists): (B, k) int32 / (B, k) f32 squared
    L2 for l2 and +q.x for ip (see the module note on the ip sign); ids
    are -1 where fewer than k rows pass.  Queries are processed in blocks
    so one block's scores stay within a fixed element budget.
    """
    n = x.shape[0]
    bq = q.shape[0]
    kk = min(k, n)
    best_s = torch.full((bq, k), NEG_INF, dtype=q.dtype, device=q.device)
    best_i = torch.full((bq, k), -1, dtype=torch.int32, device=q.device)
    qblock = max(1, _BLOCK_ELEMS // max(n, 1))
    for start in range(0, bq if kk > 0 else 0, qblock):
        sl = slice(start, min(start + qblock, bq))
        s = _scores(q[sl], x, metric)
        if mask is not None:
            s = s.masked_fill(~mask[sl], NEG_INF)
        v, i = _topk_lowid(s, kk)
        best_s[sl, :kk] = v
        best_i[sl, :kk] = i.to(torch.int32)
    best_i = torch.where(best_s == NEG_INF, torch.full_like(best_i, -1),
                         best_i)
    dists = -best_s if metric == "l2" else best_s
    return best_i, dists


def ground_truth(q: Tensor, x: Tensor, mask: Optional[Tensor], k: int,
                 metric: str = "l2") -> Tensor:
    """Exact hybrid-search answers -> (B, k) ids (-1 padded)."""
    ids, _ = masked_topk(q, x, mask, k, metric=metric)
    return ids


def recall_at_k(retrieved: Tensor, gt: Tensor) -> float:
    """recall@K = |G ∩ R| / |G| averaged over queries (paper §3.1; when
    fewer than K ground-truth answers exist, the denominator is the true
    count)."""
    r = torch.as_tensor(retrieved)
    g = torch.as_tensor(gt).to(r.device)
    valid_g = g >= 0
    hits = ((r[:, :, None] == g[:, None, :]) & valid_g[:, None, :]
            & (r >= 0)[:, :, None])
    inter = hits.any(dim=1).sum(dim=1)
    denom = valid_g.sum(dim=1).clamp(min=1)
    return float((inter.double() / denom.double()).mean())
