"""Public op: PNA's fused multi-aggregator over padded dense graphs,
routed by device.

A CPU tensor runs the plain PyTorch version (``ref.py``); a CUDA tensor
launches the CUDA kernel (``kernel.py``) or raises.  There is no fallback
from CUDA to the plain version.  The segment form is plain PyTorch on
both devices, as it is plain jnp in the reference.
"""
from __future__ import annotations

import torch

from .kernel import pna_aggregate_cuda
from .ref import pna_aggregate_ref, pna_aggregate_segment_ref


def pna_aggregate(adj: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """Dense-batched PNA aggregation: adj (B, N, N) in {0, 1}, row =
    destination; feats (B, N, F) -> (B, N, 4F) ``[mean | max | min |
    std]``.  On the card it has no gradient (``NotImplementedError``)."""
    if feats.device.type == "cpu":
        return pna_aggregate_ref(adj, feats)
    return pna_aggregate_cuda(adj.contiguous(), feats.contiguous())


pna_aggregate_segment = pna_aggregate_segment_ref
