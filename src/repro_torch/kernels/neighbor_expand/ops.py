"""Public op: fused 2-hop neighbor expansion, routed by device.

A CPU tensor runs the plain PyTorch version (``ref.py``); a CUDA tensor
launches the CUDA kernel (``kernel.py``) or raises.  There is no fallback
from CUDA to the plain version.  Both are bit-identical to the argsort
formulation (``ref.neighbor_expand_argsort``).  A ``meta`` tensor computes
nothing: it gets a ``meta`` output and reports the kernel's cost to the
dry run's counter (:func:`repro_torch.kernels.cost.record_kernel`).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..cost import neighbor_expand_dense_cost, record_kernel
from .kernel import neighbor_expand_cuda
from .ref import neighbor_expand_ref


def neighbor_expand_meta(row: torch.Tensor, pass_mask, visited, *,
                         strategy: str, m: int, m_beta: int) -> torch.Tensor:
    """The (B, m) int32 output on ``meta``, and the kernel's cost with
    every lane scanning its whole candidate stream of distinct valid
    ids."""
    b, cap = row.shape
    record_kernel("neighbor_expand", *neighbor_expand_dense_cost(
        b, cap, m, strategy, m_beta, masked=pass_mask is not None,
        visited=visited is not None), torch.int32)
    return torch.empty((b, m), dtype=torch.int32, device="meta")


def neighbor_expand(row: torch.Tensor, nbr_table: torch.Tensor,
                    pos: torch.Tensor, pass_mask: Optional[torch.Tensor] = None,
                    visited: Optional[torch.Tensor] = None, *, strategy: str,
                    m: int, m_beta: int = 0) -> torch.Tensor:
    """Up-to-m expansion ids per lane, in candidate order, -1 padded.

    row (B, cap) int32 1-hop neighbor ids (-1 padded); nbr_table (n_l, cap)
    the level's neighbor table; pos (n,) global id -> level row (or -1);
    pass_mask / visited (B, n) bool or None (None = all pass / none
    visited).  strategy in {'filter', 'compress', 'two_hop'} (Figure 4);
    ``m_beta`` is the compressed head width (compress only).
    """
    if row.device.type == "meta":
        return neighbor_expand_meta(row, pass_mask, visited,
                                    strategy=strategy, m=m, m_beta=m_beta)
    if row.device.type == "cpu":
        return neighbor_expand_ref(row, nbr_table, pos, pass_mask, visited,
                                   strategy=strategy, m=m, m_beta=m_beta)
    c = lambda t: None if t is None else t.contiguous()  # noqa: E731
    return neighbor_expand_cuda(c(row), c(nbr_table), c(pos), c(pass_mask),
                                c(visited), strategy=strategy, m=m,
                                m_beta=m_beta)
