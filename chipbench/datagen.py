"""The corpora of the configurations, made on the device from the seed.

A configuration is one deployment, so its rows are one draw, fixed by
the dataset's ``data_seed``; a run's ``--seed`` draws the requests
(``traffic.py``).  A corpus drawn anew from each seed, or its rows put
in another order by the seed, changed the graph's entry point and with
it the graph route's recall from seed to seed (0.790-0.867) far more
than two checks of one index differ (0.825, 0.826).

Frozen copies of the two synthetic families of
``src/repro_torch/data/synthetic.py`` (``make_lcps_dataset`` and
``make_hcps_dataset``, commit 041aa84): the same distributions and
parameters, drawn with one ``torch.Generator`` on the device in a few
large calls instead of numpy on the host, and without the caption column
(no predicate of these cells reads one).

* ``lcps``: a Gaussian mixture of ``clusters`` centres N(0, scale^2) with
  unit noise, and an exactly balanced ``label`` column of ``card`` values
  (a permutation of row id mod card).
* ``hcps``: a Gaussian mixture of ``clusters`` centres with unit noise;
  each cluster owns ``kw_per_cluster`` distinct keywords of
  ``n_keywords``; each row holds its cluster's keywords plus, with
  probability ``noise_kw_prob``, one uniform noise keyword (a packed
  uint32 bitset stored as int32, as ``AttributeTable`` wants); a uniform
  ``date`` column in [0, date_range).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

# rows per block when adding cluster centres (bounds the gather's scratch)
_ROW_BLOCK = 1 << 18


@dataclass
class Corpus:
    """Vectors and attribute columns, as the benchmark made them."""

    x: torch.Tensor                          # (n, d) float32
    int_cols: Dict[str, torch.Tensor]        # name -> (n,) int32
    bitset_cols: Dict[str, torch.Tensor]     # name -> (n, W) int32
    n_keywords: Dict[str, int] = field(default_factory=dict)
    # host copies the traffic generator draws from
    cluster_of: Optional[np.ndarray] = None        # (n,) int64
    cluster_keywords: Optional[np.ndarray] = None  # (C, kw_per_cluster)

    @property
    def n(self) -> int:
        return int(self.x.shape[0])

    @property
    def d(self) -> int:
        return int(self.x.shape[1])


def seed_stream(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of draws under the run's ``seed``."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _mixture(n: int, d: int, clusters: int, scale: float,
             gen: torch.Generator, dev: torch.device):
    centers = torch.randn((clusters, d), generator=gen, device=dev) * scale
    cluster_of = torch.randint(0, clusters, (n,), generator=gen, device=dev)
    x = torch.randn((n, d), generator=gen, device=dev)
    for s in range(0, n, _ROW_BLOCK):
        x[s:s + _ROW_BLOCK] += centers[cluster_of[s:s + _ROW_BLOCK]]
    return x, cluster_of


def make_lcps(p: dict, seed: int, dev: torch.device) -> Corpus:
    gen = torch.Generator(device=dev).manual_seed(seed_stream(seed, 1))
    n, card = p["n"], p["card"]
    x, cluster_of = _mixture(n, p["d"], p["clusters"], p["center_scale"],
                             gen, dev)
    labels = (torch.randperm(n, generator=gen, device=dev) % card).to(
        torch.int32)
    return Corpus(x=x, int_cols={"label": labels}, bitset_cols={},
                  cluster_of=cluster_of.cpu().numpy())


def _as_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 holding the same 32 bits."""
    return torch.where(words >= (1 << 31), words - (1 << 32), words).to(
        torch.int32)


def make_hcps(p: dict, seed: int, dev: torch.device) -> Corpus:
    gen = torch.Generator(device=dev).manual_seed(seed_stream(seed, 1))
    n, n_kw, kpc = p["n"], p["n_keywords"], p["kw_per_cluster"]
    clusters = p["clusters"]
    x, cluster_of = _mixture(n, p["d"], clusters, p["center_scale"], gen, dev)
    # kw_per_cluster distinct keywords a cluster
    cluster_kws = torch.argsort(
        torch.rand((clusters, n_kw), generator=gen, device=dev), dim=1
    )[:, :kpc]
    has_noise = torch.rand((n,), generator=gen, device=dev) < p["noise_kw_prob"]
    noise_kw = torch.randint(0, n_kw, (n,), generator=gen, device=dev)
    words = (n_kw + 31) // 32
    one = torch.ones((), dtype=torch.int64, device=dev)
    cbits = torch.zeros((clusters, words), dtype=torch.int64, device=dev)
    for j in range(kpc):
        kw = cluster_kws[:, j]
        cbits.scatter_(1, (kw // 32)[:, None],
                       cbits.gather(1, (kw // 32)[:, None])
                       | (one << (kw % 32))[:, None])
    bits = cbits[cluster_of]
    nb = torch.where(has_noise, one << (noise_kw % 32), 0)
    bits.scatter_(1, (noise_kw // 32)[:, None],
                  bits.gather(1, (noise_kw // 32)[:, None]) | nb[:, None])
    dates = torch.randint(0, p["date_range"], (n,), generator=gen,
                          device=dev).to(torch.int32)
    return Corpus(x=x, int_cols={"date": dates},
                  bitset_cols={"keywords": _as_int32_bits(bits)},
                  n_keywords={"keywords": n_kw},
                  cluster_of=cluster_of.cpu().numpy(),
                  cluster_keywords=cluster_kws.cpu().numpy())


FAMILIES = {"lcps": make_lcps, "hcps": make_hcps}


def make_corpus(dataset: dict, dev: torch.device) -> Corpus:
    """The configuration's rows, drawn from ``dataset["data_seed"]``, on
    ``dev``."""
    return FAMILIES[dataset["family"]](dataset, dataset["data_seed"], dev)
