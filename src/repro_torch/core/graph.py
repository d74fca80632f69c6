"""Fixed-shape layered proximity graph (HNSW storage as padded tensors).

All neighbor lists are padded ``int32`` tensors holding *global* node ids
with ``-1`` padding.  Level ``l`` stores only the nodes whose assigned
maximum level is >= l; ``pos[l]`` maps global id -> level-local row (or -1).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike

Tensor = torch.Tensor

INVALID = -1


class LayeredGraph(NamedTuple):
    # per level l: (n_l, cap_l) int32 global neighbor ids, -1 padded
    neighbors: Tuple[Tensor, ...]
    # per level l: (n,) int32 -> row index in neighbors[l], or -1
    pos: Tuple[Tensor, ...]
    # per level l: (n_l,) int32 global ids present at level l
    node_ids: Tuple[Tensor, ...]
    entry_point: Tensor  # () int32 global id
    levels: Tensor       # (n,) int32 max level per node

    @property
    def num_levels(self) -> int:
        return len(self.neighbors)

    @property
    def n(self) -> int:
        return int(self.levels.shape[0])

    @property
    def device(self) -> torch.device:
        return self.levels.device

    def cap(self, level: int) -> int:
        return int(self.neighbors[level].shape[1])

    def to(self, device: DeviceLike) -> "LayeredGraph":
        """A copy of every field on ``device``."""
        mv = lambda ts: tuple(t.to(device) for t in ts)  # noqa: E731
        return LayeredGraph(mv(self.neighbors), mv(self.pos),
                            mv(self.node_ids), self.entry_point.to(device),
                            self.levels.to(device))


def level_constant(M: int) -> float:
    """m_L = 1 / ln(M): HNSW's level normalization (paper §6.3.1)."""
    return 1.0 / math.log(M)


def assign_levels(generator: Optional[torch.Generator], n: int, M: int,
                  max_level: Optional[int] = None,
                  levels: Optional[np.ndarray] = None) -> Tensor:
    """Exponentially-decaying level assignment, identical in law to HNSW.

    The draw comes from ``generator`` (a CPU ``torch.Generator``); it
    cannot reproduce the JAX package's ``jax.random`` draw, so a caller
    that needs the reference's exact levels passes them as ``levels``.
    Returns a CPU (n,) int32 tensor.
    """
    if levels is not None:
        lv = torch.from_numpy(np.array(levels, dtype=np.int32))
        if lv.shape != (n,):
            raise ValueError(f"levels shape {tuple(lv.shape)} != ({n},)")
        return lv.cpu()
    mL = level_constant(M)
    u = torch.rand((n,), generator=generator, dtype=torch.float32)
    u = u * (1.0 - 1e-12) + 1e-12
    lv = torch.floor(-torch.log(u) * mL).to(torch.int32)
    if max_level is None:
        max_level = max(1, int(math.log(max(n, 2)) / math.log(M)) + 1)
    return torch.clamp(lv, max=max_level)


def neighbor_rows(graph: LayeredGraph, level: int, gids: Tensor) -> Tensor:
    """Neighbor lists for global ids ``gids`` at ``level`` -> (..., cap_l).

    Invalid gids (or gids absent from the level) yield all -1 rows.
    """
    pos = graph.pos[level]
    nbr = graph.neighbors[level]
    if nbr.shape[0] == 0:
        return torch.full(gids.shape + (nbr.shape[1],), INVALID,
                          dtype=torch.int32, device=gids.device)
    rows = pos[gids.clamp(0, pos.shape[0] - 1).long()]
    present = (gids >= 0) & (rows >= 0)
    nbrs = nbr[rows.clamp(0, nbr.shape[0] - 1).long()]
    return torch.where(present[..., None], nbrs,
                       torch.full_like(nbrs, INVALID))


def memory_bytes(graph: LayeredGraph) -> int:
    """Index space footprint in bytes (edges only; vectors counted apart)."""
    total = 0
    for group in (graph.neighbors, graph.pos, graph.node_ids):
        for a in group:
            total += a.numel() * a.element_size()
    return total


def average_out_degree(graph: LayeredGraph, level: int) -> float:
    nb = graph.neighbors[level]
    if nb.shape[0] == 0:
        return 0.0
    return float((nb >= 0).sum(dim=1).float().mean())
