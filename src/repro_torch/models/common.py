"""Parameter initialisers and losses shared by the models.

Each initialiser draws from a ``torch.Generator`` on the target device (the
tensors are made on the generator's device).  Torch cannot reproduce
``jax.random``, so the parity tests carry the reference's parameters
across with ``repro_torch.convert`` instead of re-drawing them.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

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
    """Mean binary cross-entropy of logits against {0, 1} labels, in fp32,
    in the reference's stable form."""
    logits = logits.float()
    labels = labels.float()
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
