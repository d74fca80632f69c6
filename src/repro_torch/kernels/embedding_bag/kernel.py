"""Launcher of the embedding_bag CUDA kernel (``csrc/embedding_bag.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/embedding_bag/kernel.py::embedding_bag_pallas``.  The
source's header says what bounds the kernel on an H100 and what its design
does about it.  Like the TPU kernel it is forward only; the op's backward
is plain PyTorch (``ops.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import loader

from .ref import MODES


def embedding_bag_cuda(ids: torch.Tensor, table: torch.Tensor,
                       mode: str = "sum") -> torch.Tensor:
    """ids (B, L) int32 (-1 padded), table (V, D) f32 -> (B, D) f32, as
    :func:`embedding_bag_ref` returns it.

    CUDA tensors only, contiguous; any other dtype raises ``TypeError``
    (no cast).  Raises ``ValueError`` for a mode other than ``"sum"`` and
    ``"mean"`` and for an empty table.  Adds one to
    ``embedding_bag_cuda.launches`` per kernel launch."""
    if mode not in MODES:
        raise ValueError(mode)
    loader.check_tensors("embedding_bag_cuda", table.device,
                         [("ids", ids, torch.int32, 2),
                          ("table", table, torch.float32, 2)])
    b, l = ids.shape
    v, d = table.shape
    if v < 1:
        raise ValueError("embedding_bag_cuda: the table has no rows")
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    lib = loader.library()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = lib.repro_embedding_bag(ids.data_ptr(), table.data_ptr(),
                                     out.data_ptr(), b, l, v, d,
                                     int(mode == "mean"), stream)
        embedding_bag_cuda.launches += 1
    loader.check(rc, "embedding_bag")
    return out


embedding_bag_cuda.launches = 0
