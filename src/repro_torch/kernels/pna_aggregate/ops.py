"""Public op: PNA's fused multi-aggregator over padded dense graphs,
routed by device.

A CPU tensor runs the plain PyTorch version (``ref.py``); a CUDA tensor
launches the CUDA kernel (``kernel.py``) or raises.  There is no fallback
from CUDA to the plain version.  The segment form is plain PyTorch on
both devices, as it is plain jnp in the reference.  A ``meta`` tensor
computes nothing: it gets a ``meta`` output and reports the kernel's cost
to the dry run's counter (:func:`repro_torch.kernels.cost.record_kernel`).
"""
from __future__ import annotations

import torch

from ..cost import pna_aggregate_cost, record_kernel
from .kernel import pna_aggregate_cuda
from .ref import pna_aggregate_ref, pna_aggregate_segment_ref


def pna_aggregate_meta(adj: torch.Tensor,
                       feats: torch.Tensor) -> torch.Tensor:
    """The (B, N, 4F) output on ``meta``, and the kernel's cost with
    every (row, column) pair an edge."""
    b, n, f = feats.shape
    record_kernel("pna_aggregate", *pna_aggregate_cost(
        b, n, f, edges=b * n * n, adj_bytes=adj.element_size(),
        feat_bytes=feats.element_size()), feats.dtype)
    return torch.empty((b, n, 4 * f), dtype=feats.dtype, device="meta")


def pna_aggregate(adj: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """Dense-batched PNA aggregation: adj (B, N, N) in {0, 1}, row =
    destination; feats (B, N, F) -> (B, N, 4F) ``[mean | max | min |
    std]``.  On the card it has no gradient (``NotImplementedError``)."""
    if feats.device.type == "meta":
        return pna_aggregate_meta(adj, feats)
    if feats.device.type == "cpu":
        return pna_aggregate_ref(adj, feats)
    return pna_aggregate_cuda(adj.contiguous(), feats.contiguous())


pna_aggregate_segment = pna_aggregate_segment_ref
