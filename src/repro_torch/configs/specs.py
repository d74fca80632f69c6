"""Specs shared by the arches' cells: :class:`CellDef`, :class:`TensorSpec`
(the port's ``jax.ShapeDtypeStruct``) and :func:`param_specs`."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass
class CellDef:
    shape: str
    kind: str
    skip: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor that is not made (the counterpart of
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def param_specs(module: torch.nn.Module) -> Dict[str, TensorSpec]:
    """Parameter name -> :class:`TensorSpec` of a module (on ``meta``)."""
    return {name: TensorSpec(tuple(p.shape), p.dtype)
            for name, p in module.named_parameters()}
