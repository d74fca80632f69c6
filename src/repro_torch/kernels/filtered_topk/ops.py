"""Public op: exact masked top-k over a corpus, routed by device.

A CPU tensor runs the plain PyTorch version (``ref.py``); a CUDA tensor
launches the CUDA kernel (``kernel.py``) or raises.  There is no fallback
from CUDA to the plain version, and no ``use_kernel``/``interpret`` knob.
A ``meta`` tensor computes nothing: it gets ``meta`` outputs and reports
the kernel's cost to the dry run's counter
(:func:`repro_torch.kernels.cost.record_kernel`).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..cost import filtered_topk_cost, record_kernel
from .kernel import filtered_topk_cuda
from .ref import filtered_topk_ref


def filtered_topk_meta(q: torch.Tensor, x: torch.Tensor, k: int,
                       metric: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids (B, k) int32, dists (B, k) fp32) on ``meta``, and the kernel's
    cost with every (query, row) pair passing (every row read).  Raises
    ``ValueError`` for k > n."""
    (b, d), n = q.shape, x.shape[0]
    if k > n:
        raise ValueError(f"filtered_topk: k = {k} > n = {n}")
    record_kernel("filtered_topk", *filtered_topk_cost(
        b, n, d, k, metric, rows=n, pairs=b * n, q_bytes=q.element_size(),
        x_bytes=x.element_size()))
    return (torch.empty((b, k), dtype=torch.int32, device="meta"),
            torch.empty((b, k), dtype=torch.float32, device="meta"))


def filtered_topk(q: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                  k: int, metric: str = "l2"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact masked top-k: q (B, d), x (n, d), mask (B, n) bool ->
    (ids (B, k) int32, -1 padded; dists (B, k) fp32: squared L2, or +q.x
    for ip).  q and x may be fp32, bf16 or fp16 (scored in fp32 from the
    stored values), any 0 <= k <= n.  Raises ``ValueError`` for k > n."""
    if x.device.type == "meta":
        return filtered_topk_meta(q, x, k, metric)
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
