"""Parameter initialisers shared by the models.

Each draws from a ``torch.Generator`` on the target device (the tensors are
made on the generator's device).  Torch cannot reproduce ``jax.random``,
so the parity tests carry the reference's parameters across with
``repro_torch.convert`` instead of re-drawing them.
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
