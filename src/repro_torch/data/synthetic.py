"""Synthetic hybrid-search datasets reproducing the paper's workload axes.

LCPS (SIFT1M/Paper-style): random attribute int in [0, card), equality
predicates, predicate-set cardinality = card (12 in the paper).  The
generator is seeded through numpy with the reference's exact call
sequence, so both packages make the same data from the same seed; the
port then places it on ``device``.  The HCPS family and the other
workload kinds wait for a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.bruteforce import ground_truth
from repro_torch.core.plan import compile_predicates
from repro_torch.core.predicates import AttributeTable, Equals, Predicate
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


@dataclass
class Dataset:
    x: Tensor                          # (n, d) float32
    table: AttributeTable
    cluster_of: Optional[np.ndarray] = None   # (n,) int
    centers: Optional[np.ndarray] = None      # (C, d)
    cluster_keywords: Optional[np.ndarray] = None  # (C, kw_per_cluster)
    name: str = "synthetic"

    @property
    def n(self) -> int:
        return int(self.x.shape[0])

    @property
    def d(self) -> int:
        return int(self.x.shape[1])


@dataclass
class Workload:
    xq: Tensor                         # (B, d)
    predicates: List[Predicate]
    k: int = 10
    name: str = "workload"
    _gt: Optional[Tensor] = field(default=None, repr=False)
    _masks: Optional[Tensor] = field(default=None, repr=False)

    def masks(self, ds: Dataset) -> Tensor:
        if self._masks is None:
            self._masks = compile_predicates(self.predicates,
                                             ds.table).evaluate(ds.table)
        return self._masks

    def gt(self, ds: Dataset) -> Tensor:
        if self._gt is None:
            self._gt = ground_truth(self.xq, ds.x, self.masks(ds), self.k)
        return self._gt

    def avg_selectivity(self, ds: Dataset) -> float:
        return float(self.masks(ds).float().mean(dim=1).mean())


def make_lcps_dataset(n: int = 20000, d: int = 32, card: int = 12,
                      seed: int = 0, clustered: bool = True,
                      center_scale: float = 1.2,
                      device: DeviceLike = "cuda") -> Dataset:
    """center_scale controls cluster separation; the default (1.2 with unit
    within-cluster noise) gives overlapping, manifold-like clusters like
    the paper's real datasets."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if clustered:
        n_c = 32
        centers = rng.normal(size=(n_c, d)).astype(np.float32) * center_scale
        cluster_of = rng.integers(0, n_c, size=n)
        x = centers[cluster_of] + rng.normal(size=(n, d)).astype(np.float32)
    else:
        centers, cluster_of = None, None
        x = rng.normal(size=(n, d)).astype(np.float32)
    # balanced label assignment (selectivity exactly 1/card)
    attr = rng.permutation(np.arange(n) % card).astype(np.int32)
    table = AttributeTable(int_cols={"label": torch.as_tensor(attr,
                                                              device=dev)},
                           bitset_cols={}, str_cols={}, n_keywords={})
    return Dataset(x=torch.as_tensor(x, device=dev), table=table,
                   cluster_of=cluster_of, centers=centers, name=f"lcps{n}")


def make_workload(ds: Dataset, kind: str = "equals",
                  correlation: str = "none", n_queries: int = 64,
                  k: int = 10, seed: int = 1, card: int = 12) -> Workload:
    """A query workload over ``ds`` on ``ds``'s device.  Only
    ``kind='equals'`` (LCPS) is ported."""
    if kind != "equals":
        raise NotImplementedError(
            f"workload kind {kind!r} waits for make_hcps_dataset's port")
    rng = np.random.default_rng(seed)
    n, d = ds.n, ds.d
    qi = rng.integers(0, n, size=n_queries)
    base = ds.x[torch.as_tensor(qi, device=ds.x.device)].cpu().numpy()
    xq = base + 0.1 * rng.normal(size=(n_queries, d)).astype(np.float32)
    preds: List[Predicate] = [Equals("label", int(rng.integers(0, card)))
                              for _ in range(n_queries)]
    name = f"{kind}-{correlation}" if correlation != "none" else kind
    return Workload(xq=torch.as_tensor(xq, device=ds.x.device),
                    predicates=preds, k=k, name=name)
