"""Public op: exact masked top-k over a corpus, routed by device.

A CPU tensor runs the plain PyTorch version (``ref.py``); a CUDA tensor
launches the CUDA kernel (``kernel.py``) or raises.  There is no fallback
from CUDA to the plain version, and no ``use_kernel``/``interpret`` knob.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .kernel import filtered_topk_cuda
from .ref import filtered_topk_ref


def filtered_topk(q: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                  k: int, metric: str = "l2"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact masked top-k: q (B, d), x (n, d), mask (B, n) bool ->
    (ids (B, k) int32, -1 padded; dists (B, k): squared L2, or +q.x for
    ip).  Raises ``ValueError`` for k > n."""
    if x.device.type == "cpu":
        ids, dists = filtered_topk_ref(q, x, mask, k, metric)
    else:
        ids, dists = filtered_topk_cuda(q.contiguous(), x.contiguous(),
                                        mask.contiguous(), k, metric)
    # The reference's padding depends on k: its ops.py:25 sends k > 64 to
    # the plain route, which pads ip dists with -inf (ref.py:25-26), while
    # k <= 64 takes the Pallas route, which pads with +inf (ops.py:38).
    # Both pad l2 with +inf.  The port returns what the reference returns.
    if k <= 64:
        dists = dists.masked_fill(ids < 0, float("inf"))
    return ids, dists
