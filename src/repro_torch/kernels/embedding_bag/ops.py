"""Public EmbeddingBag op, routed by device, with its gradient.

The forward runs the plain PyTorch version (``ref.py``) on a CPU table and
launches the CUDA kernel (``kernel.py``) on a CUDA table, or raises; there
is no fallback from CUDA to the plain version.  The backward is the
reference's ``_bag_bwd`` (``repro/kernels/embedding_bag/ops.py``), plain
PyTorch on both devices, as it is plain jnp outside any Pallas kernel in
the reference.  A ``meta`` table computes nothing: the forward gets a
``meta`` output and reports the kernel's cost to the dry run's counter
(:func:`repro_torch.kernels.cost.record_kernel`).
"""
from __future__ import annotations

import torch

from ..cost import embedding_bag_cost, record_kernel
from .kernel import embedding_bag_cuda
from .ref import embedding_bag_ref

Tensor = torch.Tensor


def embedding_bag_meta(ids: Tensor, table: Tensor, mode: str) -> Tensor:
    """The (B, D) output on ``meta``, and the kernel's cost with every id
    valid and distinct (min(B·L, V) rows read)."""
    (b, l), (v, d) = ids.shape, table.shape
    record_kernel("embedding_bag", *embedding_bag_cost(
        b, l, d, mode, valid=b * l, rows=min(b * l, v),
        table_bytes=table.element_size(), id_bytes=ids.element_size()),
        table.dtype)
    return torch.empty((b, d), dtype=table.dtype, device="meta")


def _bag_bwd(ids: Tensor, g: Tensor, table_shape, mode: str) -> Tensor:
    """d table of the bag reduce: g (B, D), divided by the count for
    mean, scatter-added into the rows of the valid (clipped) ids."""
    valid = ids >= 0
    if mode == "mean":
        g = g / valid.sum(dim=1, keepdim=True).clamp_min(1).to(g.dtype)
    v, d = table_shape
    b, l = ids.shape
    contrib = g[:, None, :].expand(b, l, d)[valid]
    rows = ids[valid].clamp(0, v - 1).long()
    return g.new_zeros(table_shape).index_add_(0, rows, contrib)


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, table, mode):
        ctx.save_for_backward(ids)
        ctx.mode, ctx.table_shape = mode, tuple(table.shape)
        if table.device.type == "meta":
            return embedding_bag_meta(ids, table, mode)
        if table.device.type == "cpu":
            return embedding_bag_ref(ids, table, mode)
        return embedding_bag_cuda(ids, table, mode)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[1]:
            return None, None, None
        (ids,) = ctx.saved_tensors
        return None, _bag_bwd(ids, g, ctx.table_shape, ctx.mode), None


def embedding_bag(ids: Tensor, table: Tensor, mode: str = "sum") -> Tensor:
    """ids (B, L) (-1 padded), table (V, D) -> (B, D): the sum or mean of
    the table rows of each bag, differentiable in ``table``.

    Ids are clipped into [0, V-1]: an id >= V reads row V-1 and counts as
    valid, as in the reference; an id < 0 adds nothing.  Mean divides by
    max(count, 1).  On the card, ids must be int32 and the table fp32,
    bf16 or fp16 (``TypeError`` otherwise, no cast); the output has the
    table's dtype, a 16-bit table summed in fp32 and rounded once.  Raises ``ValueError`` for a mode
    other than ``"sum"`` and ``"mean"`` on both devices, where the
    reference's Pallas route silently sums (a quirk not reproduced)."""
    return _EmbeddingBag.apply(ids, table, mode)
