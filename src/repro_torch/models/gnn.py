"""PNA — Principal Neighbourhood Aggregation (arXiv:2004.05718).

The reference's three regimes (``repro/models/gnn.py``):

* dense-batched (``molecule``): :func:`forward_dense` runs the fused
  multi-aggregator ``pna_aggregate`` (a CUDA kernel on the card) once per
  layer; training passes ``use_kernel=False``, as the reference's train
  step does, so the plain aggregator runs on the tensors' device and has a
  gradient, which the kernel has not.
* sparse, whole graph (``full_graph_sm``, ``ogb_products``):
  :func:`forward_sparse` over an edge list ``src -> dst``.
* minibatch (``minibatch_lg``): :func:`forward_minibatch` over the blocks
  of the neighbour sampler :func:`sample_fanout` (numpy, on the host, as in
  the reference).

The sparse layer's plain version, :func:`pna_layer_sparse_ref`, is the
reference's op for op.  :func:`pna_layer_sparse` computes the same through
:class:`SegmentAggregate`, which streams the edges in chunks of
``EDGE_CHUNK`` and recomputes each chunk's messages in its backward, so no
(E, F) tensor outlives a chunk: at ``ogb_products`` (62M edges) the
reference's saved ``h[src]`` and messages would be 37 GB a layer.  Both
read rows as the reference's ``jnp`` indexing does (:func:`take_rows`) and
drop edges whose ``dst`` lies outside [0, N), as ``jax.ops.segment_*``
do.

The reference keeps parameters as a pytree; here they are a :class:`PNA`
module with the reference's names and layouts ((d_in, d_out) matrices, no
biases), so ``h @ w`` reads the same.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.pna_aggregate import (pna_aggregate,
                                               pna_aggregate_ref,
                                               pna_aggregate_segment_ref)
from repro_torch.kernels.pna_aggregate.ref import _moments

from .common import (cross_entropy, dense_init, set_params, source_rows,
                     take_rows)

Tensor = torch.Tensor

N_AGG = 4      # mean / max / min / std
N_SCALE = 3    # identity / amplification / attenuation
# edges per chunk of SegmentAggregate: its (chunk, F) workspaces are 1.26 GB
# (fp32) to 2.5 GB (float64) at F = 75
EDGE_CHUNK = 1 << 22


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_in: int = 1433
    d_hidden: int = 75
    n_classes: int = 40
    avg_log_degree: float = 2.0   # delta: E[log(deg+1)] over training graph
    dtype: torch.dtype = torch.float32


def _meta(shape, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device="meta"),
                        requires_grad=False)


class PNALayer(nn.Module):
    """One message-passing layer: ``w_msg`` (d, d) and ``w_upd``
    (13 d, d), bias-free."""

    def __init__(self, d_hidden: int, dtype: torch.dtype):
        super().__init__()
        self.w_msg = _meta((d_hidden, d_hidden), dtype)
        self.w_upd = _meta((d_hidden * (1 + N_AGG * N_SCALE), d_hidden),
                           dtype)


class PNA(nn.Module):
    """Encoder ``enc`` (d_in, d_hidden), ``n_layers`` :class:`PNALayer`
    and decoder ``dec`` (d_hidden, n_classes), as ``init_pna`` of the
    reference makes them.  Constructed on the ``meta`` device:
    :func:`init_pna` draws the parameters and
    ``repro_torch.convert.pna_params_from_arrays`` carries a reference
    tree in, both through :func:`set_pna_params`."""

    def __init__(self, cfg: PNAConfig):
        super().__init__()
        self.cfg = cfg
        self.enc = _meta((cfg.d_in, cfg.d_hidden), cfg.dtype)
        self.dec = _meta((cfg.d_hidden, cfg.n_classes), cfg.dtype)
        self.layers = nn.ModuleList(PNALayer(cfg.d_hidden, cfg.dtype)
                                    for _ in range(cfg.n_layers))


def set_pna_params(model: PNA, enc: Tensor, dec: Tensor,
                   layers: Sequence[Tuple[Tensor, Tensor]]) -> PNA:
    """Give ``model`` (built on the ``meta`` device) its encoder, decoder
    and per-layer ``(w_msg, w_upd)``.  The tensors become the parameters
    as they are, without a copy, and do not require grad."""
    layers = list(layers)
    if len(layers) != len(model.layers):
        raise ValueError(f"{len(layers)} layers given, the model has "
                         f"{len(model.layers)}")
    slots = [(model, "enc", enc), (model, "dec", dec)]
    for lay, (w_msg, w_upd) in zip(model.layers, layers):
        slots += [(lay, "w_msg", w_msg), (lay, "w_upd", w_upd)]
    set_params(slots)
    return model


def init_pna(cfg: PNAConfig, generator: Optional[torch.Generator] = None,
             device: DeviceLike = "cuda") -> PNA:
    """A :class:`PNA` on ``device`` with the reference's initial law
    (every matrix N(0, 1/d_in)), drawn from ``generator`` (on ``device``;
    a fresh one seeded 0 if None) in the reference's order: ``enc``,
    ``dec``, then ``w_msg`` and ``w_upd`` of each layer."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, model on {dev}")
    d = cfg.d_hidden
    enc = dense_init(generator, cfg.d_in, d, cfg.dtype)
    dec = dense_init(generator, d, cfg.n_classes, cfg.dtype)
    layers = [(dense_init(generator, d, d, cfg.dtype),
               dense_init(generator, d * (1 + N_AGG * N_SCALE), d, cfg.dtype))
              for _ in range(cfg.n_layers)]
    return set_pna_params(PNA(cfg), enc, dec, layers)


def _scale(agg: Tensor, deg: Tensor, delta: float) -> Tensor:
    """PNA's degree scalers: agg (..., N, 4F), deg (..., N) -> (..., N,
    12F) ``[agg | agg * amp | agg * att]``."""
    logd = torch.log(deg + 1.0)[..., None]
    amp = logd / delta
    att = delta / logd.clamp_min(1e-6)
    att = torch.where(deg[..., None] > 0, att, 0.0)
    return torch.cat([agg, agg * amp, agg * att], dim=-1)


def forward_dense(cfg: PNAConfig, model: PNA, feats: Tensor,
                  adj: Tensor, use_kernel: bool = True) -> Tensor:
    """feats (B, N, d_in), adj (B, N, N) in {0, 1} (row = destination) ->
    graph logits (B, C).  The pool is a mean over all N nodes, padding
    nodes included, as in the reference.  ``use_kernel=False`` runs the
    plain aggregator on the tensors' device (differentiable) instead of
    ``pna_aggregate``'s device routing."""
    aggregate = pna_aggregate if use_kernel else pna_aggregate_ref
    h = torch.relu(feats @ model.enc)
    deg = adj.sum(-1)
    for lay in model.layers:
        msgs = h @ lay.w_msg
        agg = aggregate(adj, msgs)                              # (B, N, 4F)
        z = torch.cat([h, _scale(agg, deg, cfg.avg_log_degree)], dim=-1)
        h = torch.relu(z @ lay.w_upd)
    return h.mean(dim=1) @ model.dec


def loss_dense(cfg: PNAConfig, model: PNA, feats: Tensor, adj: Tensor,
               labels: Tensor, use_kernel: bool = True) -> Tensor:
    """Graph-classification cross-entropy of :func:`forward_dense`."""
    return cross_entropy(forward_dense(cfg, model, feats, adj,
                                       use_kernel=use_kernel), labels)


# ---------------------------------------------------------------------------
# sparse regime: edge lists
# ---------------------------------------------------------------------------


def _dest_rows(dst: Tensor, n: int) -> Tensor:
    """int64 rows of ``dst`` for a segment reduction over n segments: an
    index outside [0, n) (negatives included) goes to a spare row n, the
    edge dropped as ``jax.ops.segment_*`` drop it."""
    d = dst.long()
    return torch.where((d >= 0) & (d < n), d, n)


class SegmentAggregate(torch.autograd.Function):
    """The reference's five segment reductions of the messages
    ``take_rows(h, src) @ w_msg`` over ``dst``: ``(cnt, s, ssq, hmax,
    hmin)`` of shapes (N,) and (N, F), the edge count, sum, sum of squares,
    max and min per node, edges with ``dst`` outside [0, N) dropped.

    The edges stream in chunks of ``EDGE_CHUNK``; no (E, F) tensor is kept.
    ``cnt``, ``s`` and ``ssq`` accumulate in float64 (chunking changes the
    order of summation, and the std's gradient at var = 0 is 5e5), ``hmax``
    and ``hmin`` in ``h``'s dtype (a node without an in-edge holds -inf and
    +inf; the caller masks them).  The backward recomputes each chunk's
    messages ``m`` and forms ``g_m = g_s[dst] + 2 m g_ssq[dst] + [m ==
    hmax[dst]] g_hmax[dst] / n_max[dst] + (the same for min)``, where
    ``n_max`` counts a node's ties (one more pass over the edges): JAX's
    ``segment_max`` and torch's ``scatter_reduce`` both split a tie's
    gradient evenly.  ``cnt`` has no gradient."""

    @staticmethod
    def forward(ctx, h: Tensor, w_msg: Tensor, src: Tensor, dst: Tensor,
                n_nodes: int):
        f = w_msg.shape[1]
        acc = torch.promote_types(h.dtype, torch.float64)
        rows = n_nodes + 1                 # row n_nodes takes dropped edges
        cnt = h.new_zeros(rows, dtype=acc)
        s = h.new_zeros((rows, f), dtype=acc)
        ssq = h.new_zeros((rows, f), dtype=acc)
        hmax = h.new_full((rows, f), float("-inf"))
        hmin = h.new_full((rows, f), float("inf"))
        for lo in range(0, src.shape[0], EDGE_CHUNK):
            read, _ = source_rows(src[lo:lo + EDGE_CHUNK], h.shape[0])
            d = _dest_rows(dst[lo:lo + EDGE_CHUNK], n_nodes)
            m = h.index_select(0, read) @ w_msg
            del read
            d2 = d[:, None].expand(m.shape)
            hmax.scatter_reduce_(0, d2, m, "amax")
            hmin.scatter_reduce_(0, d2, m, "amin")
            cnt.index_add_(0, d, cnt.new_ones(d.shape[0]))
            md = m.to(acc)               # m itself when h is float64
            s.index_add_(0, d, md)
            ssq.index_add_(0, d, md.mul_(md))
            del m, md
        ctx.save_for_backward(h, w_msg, src, dst, hmax, hmin)
        ctx.n_nodes = n_nodes
        out = tuple(t[:n_nodes] for t in (cnt, s, ssq, hmax, hmin))
        ctx.mark_non_differentiable(out[0])
        return out

    @staticmethod
    def backward(ctx, _g_cnt, g_s, g_ssq, g_max, g_min):
        h, w_msg, src, dst, hmax, hmin = ctx.saved_tensors
        n, f = ctx.n_nodes, w_msg.shape[1]
        acc = torch.promote_types(h.dtype, torch.float64)

        def padded(g, dtype):     # (n + 1, f); the spare row's gradient is 0
            out = h.new_zeros((n + 1, f), dtype=dtype)
            if g is not None:
                out[:n] = g
            return out

        def chunks():
            for lo in range(0, src.shape[0], EDGE_CHUNK):
                read, write = source_rows(src[lo:lo + EDGE_CHUNK],
                                           h.shape[0])
                x = h.index_select(0, read)
                yield x, x @ w_msg, write, _dest_rows(
                    dst[lo:lo + EDGE_CHUNK], n)

        ties = [(t, g) for t, g in ((hmax, g_max), (hmin, g_min))
                if g is not None]
        if ties:                   # each node's count of maxima (minima)
            counts = [h.new_zeros((n + 1, f)) for _ in ties]
            for _, m, _, d in chunks():
                for (t, _), c in zip(ties, counts):
                    c.index_add_(0, d, (m == t.index_select(0, d)).to(
                        h.dtype))
            ties = [(t, padded(g / c[:n].clamp_min(1.0), h.dtype))
                    for (t, g), c in zip(ties, counts)]
            del counts
        gs, gq = padded(g_s, acc), padded(g_ssq, acc)
        g_h = h.new_zeros((h.shape[0] + 1, h.shape[1]))
        g_w = torch.zeros_like(w_msg)
        for x, m, write, d in chunks():
            gm = gs.index_select(0, d)
            gm.addcmul_(m.to(acc), gq.index_select(0, d), value=2.0)
            gm = gm.to(h.dtype)
            for t, gt in ties:
                gm += (m == t.index_select(0, d)) * gt.index_select(0, d)
            del m
            g_w.addmm_(x.t(), gm)
            del x
            g_h.index_add_(0, write, gm @ w_msg.t())
        return g_h[:h.shape[0]], g_w, None, None, None


def pna_layer_sparse_ref(lay: PNALayer, h: Tensor, src: Tensor, dst: Tensor,
                         n_nodes: int, delta: float) -> Tensor:
    """The reference's ``pna_layer_sparse`` op for op (the plain version):
    every (E, F) tensor made at once, autograd through them."""
    msgs = take_rows(h, src) @ lay.w_msg
    agg = pna_aggregate_segment_ref(msgs, dst, n_nodes)     # (N, 4F)
    d = _dest_rows(dst, n_nodes)
    deg = h.new_zeros(n_nodes + 1).index_add_(
        0, d, h.new_ones(d.shape[0]))[:n_nodes]
    z = torch.cat([h, _scale(agg, deg, delta)], dim=-1)
    return torch.relu(z @ lay.w_upd)


def pna_layer_sparse(lay: PNALayer, h: Tensor, src: Tensor, dst: Tensor,
                     n_nodes: int, delta: float) -> Tensor:
    """One sparse layer through :class:`SegmentAggregate`: the moments in
    float64 from its float64 sums, then the reference's masking, scalers,
    concat and ``w_upd``, all on (N, ·) tensors."""
    cnt, s, ssq, hmax, hmin = SegmentAggregate.apply(h, lay.w_msg, src, dst,
                                                     n_nodes)
    mean, std = _moments(cnt[:, None], s, ssq)
    has = cnt[:, None] > 0
    agg = torch.cat([mean.to(h.dtype), torch.where(has, hmax, 0.0),
                     torch.where(has, hmin, 0.0), std.to(h.dtype)], dim=1)
    z = torch.cat([h, _scale(agg, cnt.to(h.dtype), delta)], dim=-1)
    return torch.relu(z @ lay.w_upd)


def _layers(cfg: PNAConfig, model: PNA, h: Tensor, blocks, n_nodes: int,
            layer) -> Tensor:
    """``layer`` over ``zip(model.layers, blocks)``, each under a
    non-reentrant checkpoint when grad is on: between layers only h is
    kept, and the backward runs each layer's forward again."""
    for lay, (src, dst) in zip(model.layers, blocks):
        if torch.is_grad_enabled():
            h = checkpoint(layer, lay, h, src, dst, n_nodes,
                           cfg.avg_log_degree, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = layer(lay, h, src, dst, n_nodes, cfg.avg_log_degree)
    return h


def forward_sparse(cfg: PNAConfig, model: PNA, feats: Tensor, src: Tensor,
                   dst: Tensor, layer=pna_layer_sparse) -> Tensor:
    """feats (N, d_in), edge list src -> dst (E,) -> logits (N, C).
    ``layer=pna_layer_sparse_ref`` runs the plain layer instead."""
    h = torch.relu(feats @ model.enc)
    h = _layers(cfg, model, h, [(src, dst)] * len(model.layers),
                feats.shape[0], layer)
    return h @ model.dec


def loss_sparse(cfg: PNAConfig, model: PNA, feats: Tensor, src: Tensor,
                dst: Tensor, labels: Tensor, label_mask: Tensor,
                layer=pna_layer_sparse) -> Tensor:
    """Node-classification cross-entropy of :func:`forward_sparse` over the
    nodes ``label_mask`` weighs."""
    return cross_entropy(forward_sparse(cfg, model, feats, src, dst, layer),
                         labels, label_mask)


def forward_minibatch(cfg: PNAConfig, model: PNA, feats_block: Tensor,
                      blocks: Sequence[Tuple[Tensor, Tensor]],
                      n_block_nodes: int, layer=pna_layer_sparse) -> Tensor:
    """Forward over sampled blocks ((src, dst) per hop, deepest first);
    logits for all block nodes (the caller selects the seeds' rows).  As
    the reference's ``zip``, layers beyond the number of blocks are
    skipped."""
    h = torch.relu(feats_block @ model.enc)
    h = _layers(cfg, model, h, blocks, n_block_nodes, layer)
    return h @ model.dec


# ---------------------------------------------------------------------------
# neighbour sampler (numpy on the host, a copy of the reference's)
# ---------------------------------------------------------------------------


def build_csr(n_nodes: int, src: np.ndarray, dst: np.ndarray):
    """Incoming-edge CSR: for each node, the sources pointing at it."""
    order = np.argsort(dst, kind="stable")
    indices = src[order].astype(np.int32)
    counts = np.bincount(dst, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, indices


def sample_fanout(indptr, indices, seeds: np.ndarray, fanouts,
                  rng: np.random.Generator):
    """GraphSAGE-style layered fanout sampling (with replacement).

    Returns ``(nodes, blocks, seed_idx)``: the block's nodes (sorted
    global ids), per-hop blocks [(src, dst)] in aggregation order (deepest
    hop first) whose indices are block-local, and the block-local rows of
    the unique seeds.  A node with no in-edge samples itself."""
    layers: List[Tuple[np.ndarray, np.ndarray]] = []
    frontier = np.unique(seeds).astype(np.int32)
    all_nodes = [frontier]
    for f in fanouts:
        deg = (indptr[frontier + 1] - indptr[frontier]).astype(np.int64)
        has = deg > 0
        # sample f incoming neighbours per frontier node
        offs = rng.integers(0, np.maximum(deg, 1)[:, None],
                            size=(len(frontier), f))
        srcs = indices[np.minimum(indptr[frontier, None] + offs,
                                  indptr[frontier + 1, None] - 1)]
        srcs = np.where(has[:, None], srcs, frontier[:, None])  # self-loop
        dsts = np.repeat(frontier, f)
        layers.append((srcs.reshape(-1).astype(np.int32),
                       dsts.astype(np.int32)))
        frontier = np.unique(srcs.reshape(-1)).astype(np.int32)
        all_nodes.append(frontier)
    nodes = np.unique(np.concatenate(all_nodes)).astype(np.int32)
    remap = np.full(int(nodes.max()) + 1, -1, np.int32)
    remap[nodes] = np.arange(len(nodes), dtype=np.int32)
    blocks = [(remap[s], remap[d]) for s, d in reversed(layers)]
    return nodes, blocks, remap[np.unique(seeds).astype(np.int32)]
