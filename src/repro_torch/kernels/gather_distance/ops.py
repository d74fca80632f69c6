"""Public op: batched neighbor gather + distance, routed by device.

A CPU tensor runs the plain PyTorch version (``ref.py``); a CUDA tensor
launches the CUDA kernel (``kernel.py``) or raises.  There is no fallback
from CUDA to the plain version.
"""
from __future__ import annotations

import torch

from .kernel import gather_distance_cuda
from .ref import gather_distance_ref


def gather_distance(ids: torch.Tensor, q: torch.Tensor, x: torch.Tensor,
                    metric: str = "l2") -> torch.Tensor:
    """ids (B, M) int32 (-1 padded), q (B, d), x (n, d) -> (B, M) f32."""
    if x.device.type == "cpu":
        return gather_distance_ref(ids, q, x, metric)
    return gather_distance_cuda(ids.contiguous(), q.contiguous(), x, metric)
