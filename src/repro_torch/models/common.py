"""Parameter initialisers, losses, the reference's public helpers
(``mlp``, ``layer_norm``, ``rms_norm``, ``swiglu``, RoPE) and its ``jnp``
row indexing (``take_rows``), shared by the models.

Each initialiser draws from a ``torch.Generator`` on the target device (the
tensors are made on the generator's device).  Torch cannot reproduce
``jax.random``, so the parity tests carry the reference's parameters
across with ``repro_torch.convert`` instead of re-drawing them.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32,
               scale: Optional[float] = None) -> torch.Tensor:
    """(d_in, d_out) normal weights with std ``scale`` (1/sqrt(d_in))."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.empty((d_in, d_out), dtype=torch.float32,
                    device=generator.device)
    return w.normal_(0.0, scale, generator=generator).to(dtype)


def embed_init(generator: torch.Generator, v: int, d: int,
               dtype: torch.dtype = torch.float32,
               scale: float = 0.02) -> torch.Tensor:
    """(v, d) normal embedding table with std ``scale``."""
    t = torch.empty((v, d), dtype=torch.float32, device=generator.device)
    return t.normal_(0.0, scale, generator=generator).to(dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in fp32 (float64 stays
    float64) and cast back to ``x``'s dtype, as the reference's."""
    dt = x.dtype
    ct = torch.promote_types(dt, torch.float32)
    x = x.to(ct)
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.to(ct) + b.to(ct)).to(dt)


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis with the ``(1 + w)`` gain (``w`` starts
    at zero), computed in fp32 (float64 stays float64) and cast back to
    ``x``'s dtype, as the reference's."""
    dt = x.dtype
    ct = torch.promote_types(dt, torch.float32)
    x = x.to(ct)
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.to(ct))).to(dt)


def rope_freqs(head_dim: int, theta: float = 1e4,
               device=None) -> torch.Tensor:
    """(head_dim / 2,) fp32 rotation frequencies ``theta^(-2i / hd)``."""
    i = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x (..., S, H, hd), positions (..., S) -> x rotated, in ``x``'s
    dtype.  Interleaved pairs rotate (``x[..., ::2]``, ``x[..., 1::2]``,
    stacked back as pairs), not the two halves of HF's ``rotate_half``;
    computed in fp32 (float64 stays float64)."""
    hd = x.shape[-1]
    ct = torch.promote_types(x.dtype, torch.float32)
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang).to(ct), torch.sin(ang).to(ct)
    xf = x.to(ct)
    x1, x2 = xf[..., ::2], xf[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """``(silu(x @ w_gate) * (x @ w_up)) @ w_down``; weights (d_in, d_out)."""
    return (torch.nn.functional.silu(x @ w_gate) * (x @ w_up)) @ w_down


def mlp(x: torch.Tensor, ws: Sequence[torch.Tensor],
        bs: Sequence[torch.Tensor], act: Callable = torch.relu,
        final_act: bool = False) -> torch.Tensor:
    """``x @ w + b`` for each (d_in, d_out) ``w`` and its ``b``, ``act``
    between layers and, with ``final_act``, after the last."""
    for i, (w, b) in enumerate(zip(ws, bs)):
        x = x @ w + b
        if i < len(ws) - 1 or final_act:
            x = act(x)
    return x


def source_rows(idx: torch.Tensor, n: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(read, write) int64 rows of ``idx`` into an (n, ...) tensor, as the
    reference's ``jnp`` indexing resolves them: a negative index wraps once
    (+n); ``read`` is then clamped to [0, n - 1], and ``write`` (where a
    gradient goes) is n, a spare row, for an index still out of range,
    since the gather's transpose drops it."""
    i = idx.long()
    i = torch.where(i < 0, i + n, i)
    return i.clamp(0, n - 1), torch.where((i >= 0) & (i < n), i, n)


def take_rows(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``h[idx]`` for a 1-D ``idx`` as the reference's ``jnp`` indexing
    computes it: a negative index wraps once, an index still outside
    [0, N) reads the nearest end row and passes no gradient."""
    read, write = source_rows(idx, h.shape[0])
    rows = h.index_select(0, read)
    if rows.requires_grad:
        keep = (write < h.shape[0]).view((-1,) + (1,) * (h.dim() - 1))
        rows = torch.where(keep, rows, rows.detach())
    return rows


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (..., C) of any float dtype, labels (...) int -> scalar fp32
    (float64 for float64 logits) mean negative log-likelihood (over
    ``mask``'s weight when given, at least 1).  As the reference's
    ``take_along_axis`` in ``"fill"`` mode: a label in [-C, 0) counts from
    the end, and a label outside [-C, C) gives NaN (the gather index is
    clamped first, so a CUDA gather never reads out of range)."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    c = logits.shape[-1]
    lse = torch.logsumexp(logits, dim=-1)
    idx = torch.where(labels < 0, labels + c, labels)
    ll = torch.gather(logits, -1,
                      idx.clamp(0, c - 1).long()[..., None])[..., 0]
    ll = torch.where((idx >= 0) & (idx < c), ll, float("nan"))
    nll = lse - ll
    if mask is not None:
        mask = mask.to(logits.dtype)
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Mean binary cross-entropy of logits against {0, 1} labels, in fp32
    (float64 logits stay float64), in the reference's stable form."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    labels = labels.to(logits.dtype)
    return (logits.clamp_min(0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def param_count(params: Any) -> int:
    """Elements in a module's parameters, or in a nested dict / list /
    tuple of tensors (or of anything with a ``shape``)."""
    if isinstance(params, nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return math.prod(params.shape)


def set_named_params(model: nn.Module,
                     named: Mapping[str, torch.Tensor]) -> nn.Module:
    """:func:`set_params` by dotted parameter name (``"mlp.w.0"``):
    ``named`` must hold every parameter of ``model`` and nothing else."""
    if sorted(named) != sorted(k for k, _ in model.named_parameters()):
        raise ValueError("the names do not match the model's parameters")
    slots = []
    for name, t in named.items():
        owner, _, leaf = name.rpartition(".")
        slots.append((model.get_submodule(owner), leaf, t))
    set_params(slots)
    return model


def set_params(slots: Sequence[Tuple[nn.Module, str, torch.Tensor]]) -> None:
    """Make each tensor of ``(owner, name, tensor)`` the parameter
    ``owner.name`` as it is, without a copy and without grad, after
    checking that every one has the shape and dtype of the parameter it
    replaces (so a module built on ``meta`` is filled all or nothing)."""
    for owner, name, t in slots:
        old = getattr(owner, name)
        if old.shape != t.shape or old.dtype != t.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, expected "
                             f"{tuple(old.shape)} {old.dtype}")
    for owner, name, t in slots:
        setattr(owner, name, nn.Parameter(t, requires_grad=False))
