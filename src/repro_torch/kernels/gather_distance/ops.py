"""Public op: batched neighbor gather + distance, routed by device.

A CPU tensor runs the plain PyTorch version (``ref.py``); a CUDA tensor
launches the CUDA kernel (``kernel.py``) or raises.  There is no fallback
from CUDA to the plain version.  A ``meta`` tensor computes nothing: it
gets a ``meta`` output and reports the kernel's cost to the dry run's
counter (:func:`repro_torch.kernels.cost.record_kernel`).
"""
from __future__ import annotations

import torch

from ..cost import gather_distance_cost, record_kernel
from .kernel import gather_distance_cuda
from .ref import gather_distance_ref


def gather_distance_meta(ids: torch.Tensor, q: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """The (B, M) fp32 output on ``meta``, and the kernel's cost with
    every id valid and distinct (min(B·M, n) rows read)."""
    (b, m), (n, d) = ids.shape, x.shape
    record_kernel("gather_distance", *gather_distance_cost(
        b, m, n, d, valid=b * m, rows=min(b * m, n)))
    return torch.empty((b, m), dtype=torch.float32, device="meta")


def gather_distance(ids: torch.Tensor, q: torch.Tensor, x: torch.Tensor,
                    metric: str = "l2") -> torch.Tensor:
    """ids (B, M) int32 (-1 padded), q (B, d), x (n, d) -> (B, M) f32."""
    if x.device.type == "meta":
        return gather_distance_meta(ids, q, x)
    if x.device.type == "cpu":
        return gather_distance_ref(ids, q, x, metric)
    return gather_distance_cuda(ids.contiguous(), q.contiguous(), x, metric)
