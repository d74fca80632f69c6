"""The exact filtered k nearest neighbours under squared L2, in blocks.

:func:`exact_knn` scores the corpus a block of rows at a time in the
expanded form |x|^2 - 2 q.x, keeps the ``k + RERANK_MARGIN`` best passing
rows of each query, and ranks those again by the direct squared
difference in float64: the answer is exact unless more than
``RERANK_MARGIN`` rows lie within float32 rounding of the k-th distance.

:func:`tf32_knn` is the same scoring pass with its matrix product in TF32
(each input rounded to 10 mantissa bits, as the tensor cores take it,
products summed in float32) and its answer taken as it comes: the
benchmark's control, the step from float32 a faster program would take.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

Tensor = torch.Tensor

# candidates beyond k ranked again in float64
RERANK_MARGIN = 16
# elements of one (queries x rows) score block
BLOCK_ELEMS = 1 << 26


class Answer(NamedTuple):
    ids: Tensor      # (B, k) int64, -1 where fewer than k rows pass
    dists: Tensor    # (B, k) float64 (exact) or float32 (tf32), +inf pads
    passing: Tensor  # (B,) int64 rows passing each query's predicate


def round_to_tf32(t: Tensor) -> Tensor:
    """float32 -> float32 holding the nearest TF32 value (10 mantissa
    bits; ties away from zero)."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def sq_dists64(xq: Tensor, x: Tensor, ids: Tensor) -> Tensor:
    """Squared L2 of each query to the rows ``ids`` (B, m) by the direct
    difference in float64; +inf where an id is -1."""
    safe = ids.clamp(0, x.shape[0] - 1)
    rows = x[safe].double()                         # (B, m, d)
    d = ((rows - xq.double()[:, None, :]) ** 2).sum(dim=-1)
    return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))


def _scan(xq: Tensor, x: Tensor, mask_rows: Callable[[int, int], Tensor],
          keep: int, tf32: bool):
    """Best ``keep`` passing rows of each query by expanded-form float32
    scores: (scores (B, keep) with +inf pads, ids, passing counts)."""
    b, n = xq.shape[0], x.shape[0]
    dev = xq.device
    rows_per_block = max(1, BLOCK_ELEMS // max(b, 1))
    q = round_to_tf32(xq) if tf32 else xq
    best_s = torch.full((b, keep), float("inf"), device=dev)
    best_i = torch.full((b, keep), -1, dtype=torch.int64, device=dev)
    passing = torch.zeros((b,), dtype=torch.int64, device=dev)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for s in range(0, n, rows_per_block):
            e = min(s + rows_per_block, n)
            xb = x[s:e]
            xn = (xb * xb).sum(dim=1)
            prod = q @ (round_to_tf32(xb) if tf32 else xb).T
            sc = xn[None, :] - 2.0 * prod
            m = mask_rows(s, e)
            passing += m.sum(dim=1)
            sc = sc.masked_fill(~m, float("inf"))
            kk = min(keep, e - s)
            v, i = torch.topk(sc, kk, dim=1, largest=False)
            cat_s = torch.cat([best_s, v], dim=1)
            cat_i = torch.cat([best_i, i + s], dim=1)
            v2, j = torch.topk(cat_s, keep, dim=1, largest=False)
            best_s, best_i = v2, torch.gather(cat_i, 1, j)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    best_i = torch.where(torch.isinf(best_s), -1, best_i)
    return best_s, best_i, passing


def exact_knn(xq: Tensor, x: Tensor, mask_rows: Callable[[int, int], Tensor],
              k: int) -> Answer:
    """Exact answer: ``mask_rows(s, e)`` gives the (B, e - s) pass-mask of
    rows s..e-1."""
    _, cand, passing = _scan(xq, x, mask_rows, k + RERANK_MARGIN, tf32=False)
    d = sq_dists64(xq, x, cand)
    d, order = torch.sort(d, dim=1, stable=True)
    ids = torch.gather(cand, 1, order)[:, :k]
    return Answer(ids=ids, dists=d[:, :k], passing=passing)


def tf32_knn(xq: Tensor, x: Tensor, mask_rows: Callable[[int, int], Tensor],
             k: int) -> Answer:
    """The control: top-k by TF32 scores, distances as TF32 scores give
    them (|q|^2 + |x|^2 - 2 q.x)."""
    s, ids, passing = _scan(xq, x, mask_rows, k, tf32=True)
    qn = (xq * xq).sum(dim=1, keepdim=True)
    return Answer(ids=ids, dists=s + qn, passing=passing)
