"""Synthetic hybrid-search datasets reproducing the paper's workload axes.

Two families mirroring §7.1:

* LCPS (SIFT1M/Paper-style): random attribute int in [0, card); equality
  predicates; predicate-set cardinality = card (12 in the paper).
* HCPS (TripClick/LAION-style): Gaussian-mixture vectors with
  *predicate clustering* — each cluster carries its own keyword set — plus a
  date column and a caption string column.  Query workloads control the
  paper's three correlation regimes (Figure 2): keywords of the query's own
  cluster (pos-cor), keywords of a far cluster (neg-cor), or random keywords
  (no-cor), and optionally date-range and regex predicates.

The generators are seeded through numpy with the reference's exact call
sequence, so both packages make the same data from the same seed; the
port then places it on ``device``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.bruteforce import ground_truth
from repro_torch.core.plan import compile_predicates
from repro_torch.core.predicates import (AttributeTable, Between,
                                         ContainsAny, Equals, Predicate,
                                         RegexMatch)
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor

KEYWORD_NAMES = [
    "animal", "scary", "green", "blue", "red", "vintage", "portrait", "city",
    "nature", "food", "car", "beach", "night", "snow", "art", "music",
    "sport", "baby", "dog", "cat", "flower", "mountain", "ocean", "forest",
    "sunset", "abstract", "retro", "neon", "minimal", "cozy",
]


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


def make_hcps_dataset(n: int = 20000, d: int = 32, n_clusters: int = 0,
                      kw_per_cluster: int = 3, n_keywords: int = 30,
                      date_range: int = 120, seed: int = 0,
                      center_scale: float = 1.5,
                      noise_kw_prob: float = 0.5,
                      device: DeviceLike = "cuda") -> Dataset:
    """Gaussian mixture with cluster-correlated keyword sets (predicate
    clustering per Figure 2) + a date column + caption strings.  Clusters
    overlap (center_scale 1.5 vs unit noise) as in real embedding manifolds;
    noise keywords give every region nonzero passing density, mirroring how
    CLIP keyword lists mix across LAION image clusters.

    The per-row loop makes the reference's draws in its order (one
    ``rng.random()`` per row, one ``rng.integers`` per noise keyword); the
    keyword bits and captions are then assembled per cluster instead of
    per row, which gives the same arrays."""
    dev = resolve_device(device)
    if n_keywords > len(KEYWORD_NAMES):
        raise ValueError(f"n_keywords={n_keywords}: captions name at most "
                         f"{len(KEYWORD_NAMES)} keywords")
    rng = np.random.default_rng(seed)
    if n_clusters <= 0:
        # ~256 rows per cluster, so graph radius vs cluster size is
        # n-invariant (as in the reference)
        n_clusters = max(12, n // 256)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * center_scale
    cluster_of = rng.integers(0, n_clusters, size=n)
    x = centers[cluster_of] + rng.normal(size=(n, d)).astype(np.float32)

    cluster_kws = np.stack([
        rng.choice(n_keywords, size=kw_per_cluster, replace=False)
        for _ in range(n_clusters)
    ])
    noise = np.full(n, -1, np.int64)      # each row's noise keyword, or -1
    random, integers = rng.random, rng.integers
    for i in range(n):
        if random() < noise_kw_prob:
            noise[i] = int(integers(0, n_keywords))
    words = (n_keywords + 31) // 32
    bit = np.uint32(1) << (np.arange(n_keywords) % 32).astype(np.uint32)
    word = np.arange(n_keywords) // 32
    cluster_bits = np.zeros((n_clusters, words), np.uint32)
    for j in range(kw_per_cluster):
        np.bitwise_or.at(cluster_bits, (np.arange(n_clusters),
                                        word[cluster_kws[:, j]]),
                         bit[cluster_kws[:, j]])
    bits = cluster_bits[cluster_of]
    has = np.nonzero(noise >= 0)[0]
    np.bitwise_or.at(bits, (has, word[noise[has]]), bit[noise[has]])
    base = np.array(["photo of " + " ".join(KEYWORD_NAMES[k] for k in kws)
                     for kws in cluster_kws], dtype=object)
    names = np.array([" " + w for w in KEYWORD_NAMES[:n_keywords]] + [""],
                     dtype=object)
    captions = base[cluster_of] + names[noise]   # index -1: no suffix
    dates = rng.integers(0, date_range, size=n).astype(np.int32)

    # bitset words stored as int32 holding the uint32 bits
    table = AttributeTable(
        int_cols={"date": torch.as_tensor(dates, device=dev)},
        bitset_cols={"keywords": torch.as_tensor(bits.view(np.int32),
                                                 device=dev)},
        str_cols={"caption": captions}, n_keywords={"keywords": n_keywords})
    return Dataset(x=torch.as_tensor(x, device=dev), table=table,
                   cluster_of=cluster_of, centers=centers,
                   cluster_keywords=cluster_kws, name=f"hcps{n}")


# ---------------------------------------------------------------------------


def _far_cluster(centers: np.ndarray, c: int) -> int:
    d = np.sum((centers - centers[c]) ** 2, axis=1)
    return int(np.argmax(d))


def make_workload(ds: Dataset, kind: str = "equals",
                  correlation: str = "none", n_queries: int = 64,
                  k: int = 10, seed: int = 1, card: int = 12,
                  date_width: int = 30) -> Workload:
    """A query workload over ``ds`` on ``ds``'s device.

    kind: 'equals' (LCPS), 'contains', 'between', 'contains+between',
          'regex' (HCPS).
    correlation: 'none' | 'pos' | 'neg' — matches Figure 2 / §7.1.2. Only
          meaningful for 'contains' on clustered HCPS data.
    """
    rng = np.random.default_rng(seed)
    n, d = ds.n, ds.d
    qi = rng.integers(0, n, size=n_queries)
    base = ds.x[torch.as_tensor(qi, device=ds.x.device)].cpu().numpy()
    xq = base + 0.1 * rng.normal(size=(n_queries, d)).astype(np.float32)

    preds: List[Predicate] = []
    if kind == "equals":
        for _ in range(n_queries):
            preds.append(Equals("label", int(rng.integers(0, card))))
    elif kind in ("contains", "contains+between", "between", "regex"):
        if ds.cluster_keywords is None and kind != "between":
            raise ValueError(f"workload kind {kind!r} needs an HCPS dataset "
                             "(cluster keywords)")
        for i in range(n_queries):
            qc = int(ds.cluster_of[qi[i]])
            if kind == "between":
                lo = int(rng.integers(0, 120 - date_width))
                preds.append(Between("date", lo, lo + date_width))
                continue
            if correlation == "pos":
                kws = ds.cluster_keywords[qc]
            elif correlation == "neg":
                kws = ds.cluster_keywords[_far_cluster(ds.centers, qc)]
            else:
                rc = int(rng.integers(0, len(ds.cluster_keywords)))
                kws = ds.cluster_keywords[rc]
            kws = tuple(int(w) for w in kws[: rng.integers(1, len(kws) + 1)])
            if kind == "regex":
                word = KEYWORD_NAMES[kws[0]]
                preds.append(RegexMatch("caption", rf"\b{word}\b"))
            else:
                p: Predicate = ContainsAny("keywords", kws)
                if kind == "contains+between":
                    lo = int(rng.integers(0, 120 - date_width))
                    p = p & Between("date", lo, lo + date_width)
                preds.append(p)
    else:
        raise ValueError(kind)

    name = f"{kind}-{correlation}" if correlation != "none" else kind
    return Workload(xq=torch.as_tensor(xq, device=ds.x.device),
                    predicates=preds, k=k, name=name)
