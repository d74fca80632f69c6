"""Predicate masks from the benchmark's plain request descriptions.

A description is a tuple tree whose leaves hold one parameter per query
(numpy arrays of length B):

* ``("equals", column, values)``            int column == value
* ``("between", column, lo, hi)``           lo <= int column <= hi
* ``("contains_any", column, keywords)``    the row's keyword bitset holds
  one of the query's keywords; ``keywords`` is (B, c), -1 padded
* ``("and", [children])``

:func:`evaluate` gives the (B, r) pass-mask over r rows.  Columns come
from ``column(name)``: an int column as (r,) or (B, r) int32, a bitset
column as (r, W) or (B, r, W) int32 holding uint32 bits.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

Tensor = torch.Tensor


def keyword_bits(keywords: np.ndarray, words: int) -> np.ndarray:
    """(B, c) keyword ids (-1 padded) -> (B, words) int32 bitsets."""
    out = np.zeros((keywords.shape[0], words), dtype=np.uint32)
    for j in range(keywords.shape[1]):
        kw = keywords[:, j]
        ok = kw >= 0
        rows = np.nonzero(ok)[0]
        np.bitwise_or.at(out, (rows, kw[ok] // 32),
                         np.uint32(1) << (kw[ok] % 32).astype(np.uint32))
    return out.view(np.int32)


def _per_query(col: Tensor, per_row_dims: int) -> Tensor:
    """A column as (B or 1, r, ...) for broadcasting against queries."""
    return col if col.dim() > per_row_dims else col[None]


def evaluate(tree, column: Callable[[str], Tensor], b: int,
             device: torch.device) -> Tensor:
    """The (B, r) bool pass-mask of ``tree`` over the rows ``column``
    gives."""
    kind = tree[0]

    def param(a):
        return torch.as_tensor(np.asarray(a), device=device)

    if kind == "equals":
        col = _per_query(column(tree[1]), 1)
        return col == param(tree[2])[:, None]
    if kind == "between":
        col = _per_query(column(tree[1]), 1)
        return (col >= param(tree[2])[:, None]) & (col <= param(tree[3])[:, None])
    if kind == "contains_any":
        col = _per_query(column(tree[1]), 2)
        q = param(keyword_bits(np.asarray(tree[2]), col.shape[-1]))
        return ((col & q[:, None, :]) != 0).any(dim=-1)
    if kind == "and":
        out = evaluate(tree[1][0], column, b, device)
        for child in tree[1][1:]:
            out = out & evaluate(child, column, b, device)
        return out
    raise ValueError(f"unknown predicate kind {kind!r}")


def mask_over(tree, column: Callable[[str], Tensor], b: int, r: int,
              device: torch.device) -> Tensor:
    """:func:`evaluate`, broadcast to (B, r)."""
    return evaluate(tree, column, b, device).expand(b, r)
