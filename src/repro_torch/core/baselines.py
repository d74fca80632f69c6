"""Baseline hybrid-search methods the paper compares against (§3.2, §7.2).

Only pre-filtering is ported so far: exact masked brute force (perfect
recall, O(s·n)), the §5.2 low-selectivity route of ``HybridIndex``.
Post-filtering and the oracle partition index wait for a later slice.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .bruteforce import masked_topk

Tensor = torch.Tensor


def prefilter_search(xq: Tensor, x: Tensor, pass_mask: Tensor, k: int,
                     metric: str = "l2") -> Tuple[Tensor, Tensor]:
    """Exact brute force over the predicate-passing rows."""
    return masked_topk(xq, x, pass_mask, k, metric=metric)
