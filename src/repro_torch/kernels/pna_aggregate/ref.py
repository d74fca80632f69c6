"""Plain PyTorch versions of the PNA multi-aggregator (dense and segment
forms), twins of ``repro/kernels/pna_aggregate/ref.py``.

Both return ``[mean | max | min | std]`` along the last axis.  The
variance is the reference's ``max(ssq / denom - mean^2, 0)`` (not
Welford), evaluated in float64 from the fp32 sums, so ``std = sqrt(var +
1e-12)`` inherits the sums' cancellation: for a node whose neighbours
carry nearly equal values it is sensitive to the order of summation, up
to about sqrt(eps) |h|.  A node with no in-neighbour gets 0 for mean, max
and min and 1e-6 for std.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def _moments(cnt: Tensor, s: Tensor, ssq: Tensor):
    """mean and std from the count, sum and sum of squares, the arithmetic
    in float64 (at least): where var = 0 (a node of degree 1) the std's
    gradient is 1 / (2 sqrt(1e-12)) = 5e5, and the fp32 rounding of
    ``ssq / n - mean^2`` it multiplies dominated the gradients of the early
    layers (43 % relative L2 from float64 at the molecule shape; the
    reference's fused XLA arithmetic 0.8 %, float64 moments 0.5 %)."""
    dt = s.dtype
    cnt, s, ssq = (t.to(torch.promote_types(dt, torch.float64))
                   for t in (cnt, s, ssq))
    denom = cnt.clamp_min(1.0)
    mean = s / denom
    # torch.maximum, not clamp_min: at var == 0 it passes half the
    # gradient, as the reference's jnp.maximum does (clamp_min passes all)
    var = torch.maximum(ssq / denom - mean * mean, ssq.new_zeros(()))
    return mean.to(dt), torch.sqrt(var + 1e-12).to(dt)


def pna_aggregate_ref(adj: Tensor, feats: Tensor) -> Tensor:
    """adj (B, N, N) in {0, 1}, row = destination, column = source;
    feats (B, N, F) -> (B, N, 4F)."""
    cnt = adj.sum(dim=2, keepdim=True)
    s = torch.einsum("bij,bjf->bif", adj, feats)
    ssq = torch.einsum("bij,bjf->bif", adj, feats * feats)
    mean, std = _moments(cnt, s, ssq)
    m = adj[:, :, :, None] > 0
    h = feats[:, None, :, :]
    hmax = torch.where(m, h, -1e30).amax(dim=2)
    hmin = torch.where(m, h, 1e30).amin(dim=2)
    has = cnt > 0
    hmax = torch.where(has, hmax, 0.0)
    hmin = torch.where(has, hmin, 0.0)
    return torch.cat([mean, hmax, hmin, std], dim=2)


def pna_aggregate_segment_ref(messages: Tensor, dst: Tensor,
                              num_nodes: int) -> Tensor:
    """Sparse form: messages (E, F) scattered to dst (E,) -> (N, 4F).  As
    ``jax.ops.segment_*``, an edge whose ``dst`` lies outside [0, N)
    (negatives included) is dropped: it lands on a spare row N that is
    cut off at the end."""
    e, f = messages.shape
    idx = dst.long()
    idx = torch.where((idx >= 0) & (idx < num_nodes), idx, num_nodes)
    rows = num_nodes + 1
    cnt = messages.new_zeros(rows).index_add_(
        0, idx, messages.new_ones(e))[:num_nodes, None]
    s = messages.new_zeros((rows, f)).index_add_(0, idx, messages)
    ssq = messages.new_zeros((rows, f)).index_add_(
        0, idx, messages * messages)
    mean, std = _moments(cnt, s[:num_nodes], ssq[:num_nodes])
    idx2 = idx[:, None].expand(e, f)
    # from -inf / +inf, not from zeros with include_self=False: torch's
    # backward counts a base value equal to the result as one more tie
    hmax = messages.new_full((rows, f), float("-inf")).scatter_reduce(
        0, idx2, messages, "amax")[:num_nodes]
    hmin = messages.new_full((rows, f), float("inf")).scatter_reduce(
        0, idx2, messages, "amin")[:num_nodes]
    has = cnt > 0
    hmax = torch.where(has, hmax, 0.0)
    hmin = torch.where(has, hmin, 0.0)
    return torch.cat([mean, hmax, hmin, std], dim=1)
