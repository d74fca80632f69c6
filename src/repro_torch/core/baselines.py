"""Baseline hybrid-search methods the paper compares against (§3.2, §7.2).

* pre-filtering  — exact masked brute force (perfect recall, O(s·n)); also
  the §5.2 low-selectivity route of ``HybridIndex``.
* post-filtering — over-search an HNSW index for ~K/s candidates, then
  filter (the paper's strengthened variant: K/s, not K).
* oracle partition — one HNSW per predicate over X_p: the theoretical
  ideal (§4) ACORN emulates; only constructible for small known
  predicate sets.

Everything runs on the device of its tensors; the graph searches route
their kernels by it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .bruteforce import masked_topk
from .build import build_hnsw
from .graph import INVALID, LayeredGraph
from .search import ann_search

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# pre-filtering
# ---------------------------------------------------------------------------


def prefilter_search(xq: Tensor, x: Tensor, pass_mask: Tensor, k: int,
                     metric: str = "l2") -> Tuple[Tensor, Tensor]:
    """Exact brute force over the predicate-passing rows."""
    return masked_topk(xq, x, pass_mask, k, metric=metric)


# ---------------------------------------------------------------------------
# post-filtering
# ---------------------------------------------------------------------------


def _bucket(v: int, lo: int, hi: int) -> int:
    """Round up to lo times a power of two, capped at hi (bounds the
    number of distinct search shapes)."""
    b = lo
    while b < min(v, hi):
        b *= 2
    return min(b, hi)


def postfilter_pool(k: int, selectivity: float, ef: int,
                    max_oversearch: int = 4096) -> Tuple[int, int]:
    """(candidate pool kk, search ef) of :func:`postfilter_search`: K/s
    over-search, both bucketed to powers of two."""
    s = max(selectivity, 1e-6)
    want = int(math.ceil(k / s))
    kk = _bucket(max(want, k), k, max_oversearch)
    ef_eff = _bucket(max(ef, kk), max(ef, k), max(max_oversearch, ef))
    return kk, ef_eff


def postfilter_search(
    graph: LayeredGraph,
    x: Tensor,
    xq: Tensor,
    pass_mask: Tensor,
    k: int,
    selectivity: float,
    ef: int = 64,
    m: int = 32,
    metric: str = "l2",
    max_oversearch: int = 4096,
) -> Tuple[Tensor, Tensor]:
    """HNSW post-filtering with K/s over-search (paper §7.2).

    ``selectivity`` is the (estimated) predicate selectivity used to size
    the candidate pool (:func:`postfilter_pool`).  Returns ids (B, k) and
    dists (B, k), -1 / +inf where fewer than k pool members pass."""
    kk, ef_eff = postfilter_pool(k, selectivity, ef, max_oversearch)
    ids, dists, _ = ann_search(graph, x, xq, k=kk, ef=ef_eff, m=m,
                               metric=metric)
    safe = ids.clamp(0, pass_mask.shape[1] - 1).long()
    ok = (ids >= 0) & torch.gather(pass_mask, 1, safe)
    dists = torch.where(ok, dists, float("inf"))
    order = torch.argsort(dists, dim=1, stable=True)[:, :k]
    out_ids = torch.gather(torch.where(ok, ids, INVALID), 1, order)
    out_d = torch.gather(dists, 1, order)
    out_ids = torch.where(torch.isfinite(out_d), out_ids, INVALID)
    return out_ids, out_d


# ---------------------------------------------------------------------------
# oracle partition index (§4)
# ---------------------------------------------------------------------------


@dataclass
class OraclePartitionIndex:
    """One HNSW index per (known) predicate id. The impractical ideal."""

    # pid -> (graph, x_p, global ids of x_p's rows)
    partitions: Dict[int, Tuple[LayeredGraph, Tensor, Tensor]]
    m: int

    @staticmethod
    def build(x: Tensor, masks: Mapping[int, Tensor],
              generator: Optional[torch.Generator] = None, M: int = 16,
              efc: Optional[int] = None,
              levels: Optional[Mapping[int, np.ndarray]] = None
              ) -> "OraclePartitionIndex":
        """Build one HNSW graph per pid on ``x``'s device, in ``masks``'
        order (each an (n,) bool mask, numpy or torch).  ``levels``
        ({pid: (n_p,) levels}) fixes each partition's level draw (the
        reference's, for parity); otherwise ``generator`` draws them."""
        parts = {}
        for pid, mask in masks.items():
            mask = torch.as_tensor(mask, device=x.device).bool()
            gids = torch.nonzero(mask)[:, 0].to(torch.int32)
            xp = x[gids.long()]
            g = build_hnsw(xp, generator, M=M, efc=efc,
                           levels=None if levels is None else levels[pid])
            parts[pid] = (g, xp, gids)
        return OraclePartitionIndex(partitions=parts, m=M)

    def search(self, pid: int, xq: Tensor, k: int, ef: int = 64,
               metric: str = "l2"):
        """ann_search in partition ``pid``; ids mapped back to global."""
        graph, xp, gids = self.partitions[pid]
        ids, dists, stats = ann_search(graph, xp, xq, k=k, ef=ef, m=self.m,
                                       metric=metric)
        out = torch.where(
            ids >= 0, gids[ids.clamp(0, gids.shape[0] - 1).long()],
            INVALID)
        return out, dists, stats
