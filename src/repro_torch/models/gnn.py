"""PNA — Principal Neighbourhood Aggregation (arXiv:2004.05718).

Ported so far: the dense-batched (``molecule``) regime,
:func:`forward_dense`, which runs the fused multi-aggregator
``pna_aggregate`` (a CUDA kernel on the card) once per layer, and its
loss :func:`loss_dense`.  Training passes ``use_kernel=False``, as the
reference's train step does: the plain aggregator then runs on whatever
device the tensors are on and has a gradient, which the kernel has not.
The reference (``repro/models/gnn.py``) keeps parameters as a pytree;
here they are a :class:`PNA` module with the reference's names and
layouts ((d_in, d_out) matrices, no biases), so ``h @ w`` reads the same.

Still to port (ROADMAP.md queue 1 item 5b): ``forward_sparse``,
``forward_minibatch``, ``build_csr``, ``sample_fanout`` and
``loss_sparse``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.pna_aggregate import (pna_aggregate,
                                               pna_aggregate_ref)

from .common import cross_entropy, dense_init, set_params

Tensor = torch.Tensor

N_AGG = 4      # mean / max / min / std
N_SCALE = 3    # identity / amplification / attenuation


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
    """PNA's degree scalers, batched: agg (B, N, 4F), deg (B, N) ->
    (B, N, 12F) ``[agg | agg * amp | agg * att]``."""
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
