"""Launcher of the gather_distance CUDA kernel (``csrc/gather_distance.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/gather_distance/kernel.py::gather_distance_pallas``.
The source's header says what bounds the kernel on an H100 and what its
design does about it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import loader


def gather_distance_cuda(ids: torch.Tensor, q: torch.Tensor, x: torch.Tensor,
                         metric: str = "l2") -> torch.Tensor:
    """ids (B, M) int32 (-1 padded), q (B, d) f32, x (n, d) f32 -> (B, M).

    CUDA tensors only, contiguous.  Adds one to
    ``gather_distance_cuda.launches`` per kernel launch."""
    if metric not in ("l2", "ip"):
        raise ValueError(metric)
    loader.check_tensors("gather_distance_cuda", ids.device,
                         [("ids", ids, torch.int32, 2),
                          ("q", q, torch.float32, 2),
                          ("x", x, torch.float32, 2)])
    b, m = ids.shape
    n, d = x.shape
    if q.shape != (b, d):
        raise ValueError(f"q shape {tuple(q.shape)} != ({b}, {d})")
    if n < 1:
        raise ValueError("gather_distance_cuda: x has no rows")
    out = torch.empty((b, m), dtype=torch.float32, device=ids.device)
    if b * m == 0:
        return out
    lib = loader.library()
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        rc = lib.repro_gather_distance(
            ids.data_ptr(), q.data_ptr(), x.data_ptr(), out.data_ptr(),
            b, m, n, d, int(metric == "ip"), stream)
        gather_distance_cuda.launches += 1
    loader.check(rc, "gather_distance")
    return out


gather_distance_cuda.launches = 0
