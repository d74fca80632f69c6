"""The general request generator: one traffic mix file's parameters in,
requests out.

A mix (``chipbench/traffic/<mix>.json``) gives the batch ``B`` of user
queries a request coalesces, ``k``, ``ef`` (null: the index's default),
the ``route`` forced on the router (null: the router decides),
``query_noise`` (a query is a uniformly drawn corpus row plus this times
N(0, 1) noise), the ``predicate`` template, and the counts of requests
checked, traced and used to warm up.

Predicate templates (one parameter drawn per query):

* ``{"equals": {"column": c, "values": [lo, hi]}}``: value uniform in
  [lo, hi);
* ``{"between": {"column": c, "lo": [a, b], "width": w}}``: lo uniform in
  [a, b), hi = lo + w (inclusive);
* ``{"contains_any": {"column": c, "from": "own_cluster", "count": n}}``:
  n distinct keywords of the query row's own cluster;
* ``{"and": [...]}``: every template, each drawn per query.

Request ``i`` of a run is a pure function of the seed and ``i``: the
window draws them one at a time, and the check draws the sampled ones
again.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from chipbench.datagen import Corpus, seed_stream

# streams of draws under the run's seed (datagen takes 1)
WINDOW, WARMUP, TRACE, SAMPLE = 2, 3, 4, 5


@dataclass
class Request:
    stream: int
    index: int
    xq: torch.Tensor    # (B, d) float32 on the corpus's device
    tree: tuple         # plain description (reference/predicates.py)


class Traffic:
    def __init__(self, mix: dict, corpus: Corpus, seed: int):
        self.mix = mix
        self.corpus = corpus
        self.seed = seed
        self.batch = int(mix["batch"])
        self.k = int(mix["k"])
        self.ef: Optional[int] = mix.get("ef")
        self.route: Optional[str] = mix.get("route")
        self._gen = torch.Generator(device=corpus.x.device)

    def request(self, stream: int, index: int) -> Request:
        """Request ``index`` of ``stream``."""
        rng = np.random.default_rng(seed_stream(self.seed, stream, index, 0))
        c, b = self.corpus, self.batch
        qi = rng.integers(0, c.n, size=b)
        self._gen.manual_seed(seed_stream(self.seed, stream, index, 1))
        noise = torch.randn((b, c.d), generator=self._gen,
                            device=c.x.device)
        xq = c.x[torch.as_tensor(qi, device=c.x.device)] \
            + float(self.mix["query_noise"]) * noise
        tree = self._draw(self.mix["predicate"], rng, qi)
        return Request(stream=stream, index=index, xq=xq, tree=tree)

    # ------------------------------------------------------------------
    def _draw(self, t: dict, rng, qi) -> tuple:
        (kind, p), = t.items()
        b = len(qi)
        if kind == "equals":
            lo, hi = p["values"]
            return ("equals", p["column"], rng.integers(lo, hi, size=b))
        if kind == "between":
            a, z = p["lo"]
            lo = rng.integers(a, z, size=b)
            return ("between", p["column"], lo, lo + int(p["width"]))
        if kind == "contains_any":
            return ("contains_any", p["column"], self._keywords(p, rng, qi))
        if kind == "and":
            return (kind, [self._draw(s, rng, qi) for s in p])
        raise ValueError(f"unknown predicate template {kind!r}")

    def _keywords(self, p: dict, rng, qi) -> np.ndarray:
        """(B, count) keywords of each query row's own cluster."""
        if p["from"] != "own_cluster":
            raise ValueError(f"unknown keyword source {p['from']!r}")
        kws = self.corpus.cluster_keywords
        order = np.argsort(rng.random((len(qi), kws.shape[1])), axis=1)
        picked = np.take_along_axis(kws[self.corpus.cluster_of[qi]], order,
                                    axis=1)
        return picked[:, :int(p["count"])]
