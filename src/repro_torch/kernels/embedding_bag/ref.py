"""Plain PyTorch versions of EmbeddingBag, twins of
``repro/kernels/embedding_bag/ref.py``.

Ids are clipped into [0, V-1] before the row gather, and an id < 0 adds
nothing and is not counted.  So an id >= V reads row V-1 and *counts as
valid*: a quirk of the reference, reproduced.  Mean divides by
max(count, 1), so an all-padding bag gives zeros in both modes.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

MODES = ("sum", "mean")


def embedding_bag_ref(ids: Tensor, table: Tensor, mode: str = "sum"
                      ) -> Tensor:
    """ids (B, L) int (-1 padded), table (V, D) -> (B, D).  Raises
    ``ValueError`` for a mode other than ``"sum"`` and ``"mean"``."""
    if mode not in MODES:
        raise ValueError(mode)
    safe = ids.clamp(0, table.shape[0] - 1).long()
    rows = table[safe]                                   # (B, L, D)
    valid = (ids >= 0)[..., None]
    summed = torch.where(valid, rows, 0.0).sum(dim=1)
    if mode == "sum":
        return summed
    cnt = (ids >= 0).sum(dim=1, keepdim=True).clamp_min(1)
    return summed / cnt.to(table.dtype)


def embedding_bag_segment_ref(flat_ids: Tensor, segment_ids: Tensor,
                              table: Tensor, num_segments: int,
                              mode: str = "sum") -> Tensor:
    """Segment form: flat_ids (E,) with their bag in segment_ids (E,) ->
    (num_segments, D).  As in the reference, any mode but ``"sum"`` is the
    mean."""
    rows = table[flat_ids.clamp(0, table.shape[0] - 1).long()]
    valid = flat_ids >= 0
    rows = torch.where(valid[:, None], rows, 0.0)
    seg = segment_ids.long()
    summed = table.new_zeros((num_segments, table.shape[1])).index_add_(
        0, seg, rows)
    if mode == "sum":
        return summed
    cnt = table.new_zeros(num_segments).index_add_(0, seg,
                                                   valid.to(table.dtype))
    return summed / cnt.clamp_min(1.0)[:, None]
