"""High-level hybrid-search index with ACORN's cost-based routing (§5.2).

``HybridIndex`` owns the vectors, attribute table, the ACORN graph and a
selectivity sketch, and implements the paper's routing rule: queries whose
estimated selectivity falls below s_min = 1/γ are answered by pre-filtered
brute force (exact); all others traverse the predicate subgraph.  Both
routes run through the same batch buckets.  Everything lives on one
device; kernel routing follows it.  ``AcornConfig.data_parallel`` > 1
splits the graph route's queries over ranks of the default process group
(``repro_torch.distributed.query_parallel``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

from .baselines import prefilter_search
from .batched import (DEFAULT_BUCKETS, VariantCache, pad_rows, plan_chunks,
                      search_batch)
from .build import build_acorn_1, build_acorn_gamma
from .graph import INVALID, LayeredGraph, memory_bytes
from .plan import (ExecutionSpec, PredicateProgram, SearchRequest,
                   SearchResult, compile_predicates, resolve_execution_spec)
from .predicates import AttributeTable, Predicate, SelectivitySketch

Tensor = torch.Tensor


@dataclass
class AcornConfig:
    M: int = 16
    gamma: int = 8
    m_beta: Optional[int] = None       # default 2M
    ef_search: int = 64
    variant: str = "acorn-gamma"       # or "acorn-1"
    metric: str = "l2"
    compress: bool = True
    max_expansions: int = 512
    buckets: Tuple[int, ...] = DEFAULT_BUCKETS  # batch buckets
    # query-data-parallel mesh devices for the graph route: 1 = single
    # device, None/0 = all ranks of the default process group, N = min(N,
    # that count)
    data_parallel: Optional[int] = 1
    # corpus-mesh axis size for corpus-sharded serving
    # (repro_torch.distributed.corpus_parallel via ServingEngine): None/0 =
    # auto (one device per corpus shard when there are enough); an
    # explicit value must equal the engine's shard count.  A single
    # HybridIndex is always one corpus shard.
    corpus_parallel: Optional[int] = None

    @property
    def s_min(self) -> float:
        return 1.0 / self.gamma

    def resolved_m_beta(self) -> int:
        return self.m_beta if self.m_beta is not None else 2 * self.M

    def execution_spec(self) -> ExecutionSpec:
        return ExecutionSpec(data_parallel=self.data_parallel,
                             corpus_parallel=self.corpus_parallel)


@dataclass
class HybridIndex:
    x: Tensor
    table: AttributeTable
    graph: LayeredGraph
    config: AcornConfig
    sketch: SelectivitySketch
    build_seconds: float = 0.0
    cache: VariantCache = field(default_factory=VariantCache)

    # ------------------------------------------------------------------
    @staticmethod
    def build(x: Tensor, table: AttributeTable, config: AcornConfig,
              seed: int = 0, device: DeviceLike = "cuda",
              levels: Optional[np.ndarray] = None) -> "HybridIndex":
        """Build on ``device`` (vectors and table move there).

        ``levels`` fixes the level assignment (e.g. the reference's own
        draw, for parity); otherwise a ``torch.Generator`` seeded with
        ``seed`` draws it.  The sketch sample is drawn from ``seed`` with
        numpy, as in the reference."""
        dev = resolve_device(device)
        x = torch.as_tensor(x).to(dev, dtype=torch.float32).contiguous()
        if table.device != dev:
            table = AttributeTable(
                int_cols={k: v.to(dev) for k, v in table.int_cols.items()},
                bitset_cols={k: v.to(dev)
                             for k, v in table.bitset_cols.items()},
                str_cols=dict(table.str_cols),
                n_keywords=dict(table.n_keywords))
        gen = torch.Generator().manual_seed(seed)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if config.variant == "acorn-gamma":
            graph = build_acorn_gamma(
                x, gen, M=config.M, gamma=config.gamma,
                m_beta=config.resolved_m_beta(), compress=config.compress,
                levels=levels)
        elif config.variant == "acorn-1":
            graph = build_acorn_1(x, gen, M=config.M, levels=levels)
        else:
            raise ValueError(config.variant)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        tti = time.perf_counter() - t0
        sketch = SelectivitySketch.build(table, seed=seed)
        return HybridIndex(x=x, table=table, graph=graph, config=config,
                           sketch=sketch, build_seconds=tti)

    # ------------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.x.device

    @property
    def index_bytes(self) -> int:
        return memory_bytes(self.graph)

    @property
    def total_bytes(self) -> int:
        return self.index_bytes + self.x.numel() * self.x.element_size()

    # ------------------------------------------------------------------
    def prefilter(self, xq: Tensor, masks: Tensor, k: int
                  ) -> Tuple[Tensor, Tensor]:
        """Exact pre-filtered brute force through the batch buckets.

        Returns (B, k) ids / dists on the index's device."""
        cfg = self.config
        b = xq.shape[0]
        out_ids = torch.full((b, k), INVALID, dtype=torch.int32,
                             device=self.device)
        out_d = torch.full((b, k), float("inf"), dtype=torch.float32,
                           device=self.device)
        start = 0
        for take, bucket in plan_chunks(b, cfg.buckets):
            sl = slice(start, start + take)
            q, msk = xq[sl], masks[sl]
            if take < bucket:
                q = pad_rows(q, bucket - take)
                msk = pad_rows(msk, bucket - take)
            ids, d = prefilter_search(q, self.x, msk, k, metric=cfg.metric)
            out_ids[sl] = ids[:take]
            out_d[sl] = d[:take]
            start += take
        return out_ids, out_d

    # ------------------------------------------------------------------
    def compile(self, predicates: Sequence[Predicate]) -> PredicateProgram:
        """Compile predicate trees against this index's table schema."""
        return compile_predicates(predicates, self.table)

    # ------------------------------------------------------------------
    def search(
        self,
        request: Union[SearchRequest, Tensor],
        predicates: Union[Sequence[Predicate], PredicateProgram, None] = None,
        k: int = 10,
        ef: Optional[int] = None,
        force_route: Optional[str] = None,
        spec: Optional[ExecutionSpec] = None,
        use_kernel: Optional[bool] = None,
        interpret: Optional[bool] = None,
        expand_kernel: Optional[bool] = None,
        data_parallel: Optional[int] = None,
        corpus_parallel: Optional[int] = None,
    ) -> SearchResult:
        """Batched hybrid search with per-query cost-based routing.

        ``index.search(SearchRequest(xq=q, predicates=preds, k=10))``.
        ``request.predicates`` may be predicate trees (compiled here) or a
        compiled :class:`PredicateProgram`.  The retired knob kwargs raise
        ``TypeError``.  Returns a :class:`SearchResult` (ids (B, k), dists
        (B, k) on the index's device, per-query stats and routes);
        ``ids, d, info = index.search(...)`` unpacks it.
        """
        cfg = self.config
        if isinstance(request, SearchRequest):
            if predicates is not None:
                raise TypeError(
                    "pass predicates inside the SearchRequest, not alongside")
            xq = request.xq
            predicates = request.predicates
            k = request.k if request.k is not None else k
            ef = request.ef if request.ef is not None else ef
            force_route = (request.route if request.route is not None
                           else force_route)
        else:
            xq = request
        ef = ef or cfg.ef_search
        spec = resolve_execution_spec(
            spec, "HybridIndex.search", base=cfg.execution_spec(),
            use_kernel=use_kernel, interpret=interpret,
            expand_kernel=expand_kernel, data_parallel=data_parallel,
            corpus_parallel=corpus_parallel)
        xq = torch.as_tensor(xq).to(self.device, dtype=torch.float32)

        b = xq.shape[0]
        if predicates is None:
            if force_route == "prefilter":
                raise ValueError(
                    "route='prefilter' (exact masked brute force) needs "
                    "predicates; pass TruePredicate() per query for an "
                    "explicit match-all")
            ids, d, stats = search_batch(
                self.graph, self.x, xq, None, k=k, ef=ef,
                variant=cfg.variant, m=cfg.M, m_beta=cfg.resolved_m_beta(),
                metric=cfg.metric, compressed_level0=False,
                max_expansions=cfg.max_expansions, spec=spec,
                buckets=cfg.buckets, cache=self.cache)
            return SearchResult(
                ids=ids, dists=d,
                stats=dict(selectivity_est=np.ones((b,)),
                           dist_comps=stats.dist_comps.cpu().numpy()),
                routes=np.full((b,), "graph"), legacy_arity=3)

        # -- compile once: one pass for masks, one for estimates --
        program = (predicates if isinstance(predicates, PredicateProgram)
                   else compile_predicates(predicates, self.table))
        if program.n_queries != b:
            raise ValueError(
                f"{b} queries but {program.n_queries} predicates")
        masks = program.evaluate(self.table)          # (B, n), one pass
        s_est = self.sketch.estimate_batch(program)   # (B,), one pass
        if force_route == "graph":
            use_pre = np.zeros(b, bool)
        elif force_route == "prefilter":
            use_pre = np.ones(b, bool)
        else:
            use_pre = s_est < cfg.s_min

        out_ids = torch.full((b, k), INVALID, dtype=torch.int32,
                             device=self.device)
        out_d = torch.full((b, k), float("inf"), dtype=torch.float32,
                           device=self.device)
        dist_comps = np.zeros((b,), np.int64)

        pre_idx = np.nonzero(use_pre)[0]
        gr_idx = np.nonzero(~use_pre)[0]
        if len(pre_idx):
            ti = torch.as_tensor(pre_idx, device=self.device)
            ids_p, d_p = self.prefilter(xq[ti], masks[ti], k)
            out_ids[ti] = ids_p
            out_d[ti] = d_p
            dist_comps[pre_idx] = masks[ti].sum(dim=1).cpu().numpy()
        if len(gr_idx):
            ti = torch.as_tensor(gr_idx, device=self.device)
            variant = cfg.variant
            ids, d, stats = search_batch(
                self.graph, self.x, xq[ti], masks[ti], k=k, ef=ef,
                variant=variant, m=cfg.M, m_beta=cfg.resolved_m_beta(),
                metric=cfg.metric,
                compressed_level0=cfg.compress and variant == "acorn-gamma",
                max_expansions=cfg.max_expansions, spec=spec,
                buckets=cfg.buckets, cache=self.cache)
            out_ids[ti] = ids
            out_d[ti] = d
            dist_comps[gr_idx] = stats.dist_comps.cpu().numpy()

        return SearchResult(
            ids=out_ids, dists=out_d,
            stats=dict(selectivity_est=np.asarray(s_est),
                       dist_comps=dist_comps),
            routes=np.where(use_pre, "prefilter", "graph"), legacy_arity=3)
