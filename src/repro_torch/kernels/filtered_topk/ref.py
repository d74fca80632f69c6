"""Plain PyTorch version of the filtered_topk kernel.

The same function as the reference's plain route
(``repro/kernels/filtered_topk/ref.py``) and as
``repro_torch.core.bruteforce.masked_topk``, which computes it: scores are
-(|q|^2 + |x|^2 - 2 q.x) for l2 and q.x for ip, masked rows score -inf,
and the k best are kept with the lower id first among equal scores.  Dists
are squared L2 for l2 and **+q.x** for ip (the reference's docstring says
negative IP; its code returns +q.x, and so does the port).  Slots past the
last passing row hold id -1 and dist -score: +inf for l2, -inf for ip.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.bruteforce import masked_topk

Tensor = torch.Tensor


def filtered_topk_ref(q: Tensor, x: Tensor, mask: Tensor, k: int,
                      metric: str = "l2") -> Tuple[Tensor, Tensor]:
    """q (B, d), x (n, d), mask (B, n) bool -> (ids (B, k) int32, dists
    (B, k) f32).  Raises ``ValueError`` for k > n, as the reference's
    ``lax.top_k`` does."""
    n = x.shape[0]
    if k > n:
        raise ValueError(f"filtered_topk: k = {k} > n = {n}")
    return masked_topk(q, x, mask, k, metric)
