"""Launcher of the pna_aggregate CUDA kernel (``csrc/pna_aggregate.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/pna_aggregate/kernel.py::pna_aggregate_pallas``.  The
source's header says what bounds the kernel on an H100 and what its design
does about it.  Like the TPU kernel it is forward only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import loader


def pna_aggregate_cuda(adj: torch.Tensor, feats: torch.Tensor
                       ) -> torch.Tensor:
    """adj (B, N, N) f32 in {0, 1} (row = destination), feats (B, N, F)
    f32 -> (B, N, 4F) f32 ``[mean | max | min | std]``, as
    :func:`pna_aggregate_ref` returns it.

    CUDA tensors only, contiguous.  Has no gradient: raises
    ``NotImplementedError`` when autograd would need one.  Adds one to
    ``pna_aggregate_cuda.launches`` per kernel launch."""
    loader.check_tensors("pna_aggregate_cuda", adj.device,
                         [("adj", adj, torch.float32, 3),
                          ("feats", feats, torch.float32, 3)])
    b, n, f = feats.shape
    if adj.shape != (b, n, n):
        raise ValueError(f"pna_aggregate_cuda: adj {tuple(adj.shape)}, "
                         f"expected ({b}, {n}, {n})")
    if torch.is_grad_enabled() and (adj.requires_grad or feats.requires_grad):
        raise NotImplementedError(
            "pna_aggregate has no backward on the card; train through "
            "forward_dense(..., use_kernel=False), as the reference does")
    out = torch.empty((b, n, 4 * f), dtype=torch.float32, device=adj.device)
    if out.numel() == 0:
        return out
    lib = loader.library()
    with torch.cuda.device(adj.device):
        stream = torch.cuda.current_stream(adj.device).cuda_stream
        rc = lib.repro_pna_aggregate(adj.data_ptr(), feats.data_ptr(),
                                     out.data_ptr(), b, n, f, stream)
        pna_aggregate_cuda.launches += 1
    loader.check(rc, "pna_aggregate")
    return out


pna_aggregate_cuda.launches = 0
