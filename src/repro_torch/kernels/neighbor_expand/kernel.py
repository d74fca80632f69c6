"""Launcher of the neighbor_expand CUDA kernel (``csrc/neighbor_expand.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/neighbor_expand/kernel.py::neighbor_expand_pallas``.
The source's header says what bounds the kernel on an H100 and what its
design does about it.  Edge cases follow the TPU wrapper: a zero-width head
(``m_beta = 0``) or tail (``m_beta = cap``) contributes nothing, an empty
level table (``n_l = 0``) makes every 2-hop row absent, and under
'compress' a tail id whose row is absent is still itself a candidate.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import loader

STRATEGIES = {"filter": 0, "compress": 1, "two_hop": 2}

# shared memory a block may take on an H100 (the kernel opts in above 48 KB)
_SMEM_LIMIT = 227 * 1024


def neighbor_expand_cuda(row: torch.Tensor, nbr_table: torch.Tensor,
                         pos: torch.Tensor,
                         pass_mask: Optional[torch.Tensor] = None,
                         visited: Optional[torch.Tensor] = None, *,
                         strategy: str, m: int, m_beta: int = 0
                         ) -> torch.Tensor:
    """row (B, cap), nbr_table (n_l, cap), pos (n,) int32; pass_mask /
    visited (B, n) bool or None -> (B, m) int32 ids, -1 padded.

    CUDA tensors only, contiguous.  Adds one to
    ``neighbor_expand_cuda.launches`` per kernel launch."""
    if strategy not in STRATEGIES:
        raise ValueError(strategy)
    dev = row.device
    named = [("row", row, torch.int32, 2), ("nbr_table", nbr_table,
             torch.int32, 2), ("pos", pos, torch.int32, 1)]
    if pass_mask is not None:
        named.append(("pass_mask", pass_mask, torch.bool, 2))
    if visited is not None:
        named.append(("visited", visited, torch.bool, 2))
    loader.check_tensors("neighbor_expand_cuda", dev, named)
    b, cap = row.shape
    n = pos.shape[0]
    n_l = nbr_table.shape[0]
    if nbr_table.shape[1] != cap:
        raise ValueError(f"nbr_table width {nbr_table.shape[1]} != row "
                         f"width {cap}")
    for name, t in (("pass_mask", pass_mask), ("visited", visited)):
        if t is not None and t.shape != (b, n):
            raise ValueError(f"{name} shape {tuple(t.shape)} != ({b}, {n})")
    if b == 0 or m <= 0 or cap == 0:
        return torch.full((b, max(m, 0)), -1, dtype=torch.int32, device=dev)
    if n < 1:
        raise ValueError("neighbor_expand_cuda: pos is empty")
    m_beta = min(max(m_beta, 0), cap)
    lib = loader.library()
    smem = lib.repro_neighbor_expand_smem_bytes(cap, m)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"neighbor_expand_cuda: cap={cap}, m={m} needs "
                         f"{smem} B of shared memory (> {_SMEM_LIMIT}); its "
                         "dedup set grows with m")
    out = torch.empty((b, m), dtype=torch.int32, device=dev)  # kernel fills
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_neighbor_expand(
            row.data_ptr(), nbr_table.data_ptr(), pos.data_ptr(),
            ptr(pass_mask), ptr(visited), out.data_ptr(), b, cap, n, n_l, m,
            m_beta, STRATEGIES[strategy], stream)
        neighbor_expand_cuda.launches += 1
    loader.check(rc, "neighbor_expand")
    return out


neighbor_expand_cuda.launches = 0
