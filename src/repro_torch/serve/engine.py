"""Hybrid-search serving engine.

Operational wrapper around HybridIndex for production serving:

  * request batching — queries accumulate into ``batch_size`` chunks and
    each shard dispatches them through the bucketed batch pipeline
    (``repro_torch.core.batched.search_batch`` via ``HybridIndex.search``),
    so a ragged request stream runs against a handful of batch shapes;
  * compiled predicate programs — each batch's predicate trees compile
    ONCE (``repro_torch.core.plan.compile_predicates``) into a columnar
    program shared by every shard;
  * corpus sharding through the **host loop** (:meth:`search_batch_host`):
    a Python walk over the shards, each an ACORN index on the engine's
    device, with local ids offset to global ids and the (distance,
    global id) merge (``repro_torch.distributed.merge_topk``) run on the
    device.  The reference's SPMD path (one program on a ``(data,
    corpus)`` mesh) waits for the port of ``distributed/`` (``ROADMAP.md``
    queue 1 item 3); the reference gives bit-identical results on both
    paths and takes the host loop on one device, as the port always does;
  * execution policy as ONE value — ``EngineConfig.spec``
    (:class:`repro_torch.core.plan.ExecutionSpec`); the retired per-knob
    ``EngineConfig`` fields raise ``TypeError`` with a migration hint;
  * typed results — every serving surface returns a
    :class:`repro_torch.core.plan.SearchResult` (ids/dists/per-query
    stats + route summary + shed/degraded flags); ``ids, d =
    engine.serve(...)`` tuple unpacking works;
  * per-query cost-based routing (ACORN graph vs pre-filter, §5.2) —
    inside each shard's HybridIndex;
  * straggler mitigation — every shard query optionally runs on a mirror
    (duplicate dispatch); the merge collapses identical answers, so the
    protocol tolerates a slow or failed shard;
  * failure recovery — ``rebuild_shard`` re-materializes a shard's
    subgraph from the source vectors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import AcornConfig, HybridIndex, Predicate
from repro_torch.core.plan import (_KNOB_NAMES, ExecutionSpec,
                                   PredicateProgram, SearchRequest,
                                   SearchResult, TableSchema,
                                   compile_predicates, sentinel_result)
from repro_torch.core.predicates import AttributeTable
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.collectives import merge_topk  # noqa: F401  (re-export)

Tensor = torch.Tensor
Predicates = Union[Sequence[Predicate], PredicateProgram]

_SPMD_WAITS = ("the SPMD corpus-mesh path waits for the port of "
               "distributed/ (ROADMAP.md, queue 1 item 3); the port serves "
               "through the host loop")


@dataclasses.dataclass
class EngineConfig:
    batch_size: int = 64
    k: int = 10
    ef: int = 64
    n_shards: int = 1
    duplicate_dispatch: bool = False  # straggler mitigation (mirrored shards)
    # execution policy as one value; None = derive from AcornConfig
    spec: Optional[ExecutionSpec] = None
    # RETIRED legacy per-knob overlay: the fields remain declared so that
    # old configs fail with a migration hint instead of a silent ignore —
    # any non-None value raises TypeError in __post_init__
    use_kernel: Optional[bool] = None
    interpret: Optional[bool] = None
    expand_kernel: Optional[bool] = None
    data_parallel: Optional[int] = None
    corpus_parallel: Optional[int] = None

    def __post_init__(self):
        passed = sorted(n for n in _KNOB_NAMES
                        if getattr(self, n) is not None)
        if passed:
            hints = ", ".join(f"spec=ExecutionSpec({n}=...)" for n in passed)
            raise TypeError(
                f"EngineConfig: the legacy knob fields {passed} were "
                f"removed; pass {hints} instead")


@dataclasses.dataclass
class _Shard:
    index: HybridIndex
    base: int                  # global id offset
    healthy: bool = True


class ServingEngine:
    """Shards a corpus row-wise, builds one ACORN index per shard on
    ``device``, serves batched hybrid queries with a global top-k merge
    through the host loop."""

    def __init__(self, x, table: AttributeTable, acorn: AcornConfig,
                 cfg: EngineConfig, seed: int = 0,
                 device: DeviceLike = "cuda",
                 indexes: Optional[Sequence[HybridIndex]] = None):
        """``indexes``: the shards already built, one per ``cfg.n_shards``,
        covering ``x``'s rows in order (``convert.engine_from_arrays``
        carries them across); ``None`` builds shard ``s`` from its rows
        with ``seed + s``."""
        dev = resolve_device(device)
        n = x.shape[0]
        if indexes is None:
            per = (n + cfg.n_shards - 1) // cfg.n_shards
            indexes = [HybridIndex.build(
                x[s * per:min((s + 1) * per, n)],
                table.take(np.arange(s * per, min((s + 1) * per, n))),
                acorn, seed=seed + s, device=dev)
                for s in range(cfg.n_shards)]
        sizes = [int(i.x.shape[0]) for i in indexes]
        if len(indexes) != cfg.n_shards or sum(sizes) != n:
            raise ValueError(
                f"{len(indexes)} shards of {sum(sizes)} rows for "
                f"n_shards={cfg.n_shards} over {n} rows")
        bases = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        self.cfg = cfg
        self.acorn = acorn
        self.device = dev
        self._x = x
        self._table = table
        self.shards: List[_Shard] = [_Shard(index=i, base=int(b))
                                     for i, b in zip(indexes, bases)]
        self.stats: Dict[str, float] = {"queries": 0, "batches": 0,
                                        "prefilter_routed": 0,
                                        "graph_routed": 0,
                                        "duplicated_dispatches": 0}

    # ------------------------------------------------------------------
    # execution-spec + mesh geometry resolution
    # ------------------------------------------------------------------
    def execution_spec(self) -> ExecutionSpec:
        """The engine's resolved execution policy: ``EngineConfig.spec``
        when set, else the AcornConfig spec."""
        if self.cfg.spec is not None:
            return self.cfg.spec
        return self.acorn.execution_spec()

    def spmd_mesh_shape(self) -> Optional[Tuple[int, int]]:
        """The ``(data, corpus)`` mesh the SPMD path would run on, or
        ``None`` when this engine serves through the host loop — always,
        in the port: the spec's mesh sizes are 1 (larger ones raise where
        the spec is made), and on one device the reference resolves that
        to the host loop too."""
        return None

    def compile(self, predicates: Sequence[Predicate]) -> PredicateProgram:
        """Compile predicate trees once against the corpus schema; the
        program is valid for every shard (``take`` preserves the schema)."""
        return compile_predicates(predicates, self._table)

    @staticmethod
    def _unpack(request, predicates):
        if isinstance(request, SearchRequest):
            if predicates is not None:
                raise TypeError(
                    "pass predicates inside the SearchRequest, not alongside")
            return (request.xq, request.predicates, request.k, request.ef,
                    request.route)
        return request, predicates, None, None, None

    # ------------------------------------------------------------------
    def search_batch(self, request: Union[SearchRequest, Tensor],
                     predicates: Optional[Predicates] = None):
        """One batched step across all shards + merge.

        Accepts a :class:`SearchRequest` (whose ``k``/``ef``/``route``
        override the engine defaults for this call) or the legacy
        ``(xq, predicates)`` pair; ``predicates`` may be trees or a
        pre-compiled program.  Returns a :class:`SearchResult`
        (``ids, d = ...`` unpacking works).
        """
        xq, preds, k, ef, route = self._unpack(request, predicates)
        shape = self.spmd_mesh_shape()
        if shape is None:
            return self._search_batch_host(xq, preds, k=k, ef=ef,
                                           route=route)
        return self._search_batch_spmd(xq, preds, *shape, k=k, ef=ef,
                                       route=route)

    # ------------------------------------------------------------------
    def _program(self, preds: Predicates, b: int) -> PredicateProgram:
        if preds is None:
            raise TypeError(
                "ServingEngine requires predicates (trees or a compiled "
                "program); pass TruePredicate() per query for match-all")
        if isinstance(preds, PredicateProgram):
            # programs read columns by compile-time slot number — one
            # compiled against a different column layout would silently
            # read the wrong slots, so reject it at the public surface
            schema = TableSchema.of(self._table)
            if preds.schema is not None and preds.schema != schema:
                raise ValueError(
                    f"program compiled against schema {preds.schema} but "
                    f"this engine's corpus has {schema} — compile with "
                    "engine.compile(...) (shards share that one layout)")
            prog = preds
        else:
            prog = self.compile(preds)
        if prog.n_queries != b:
            raise ValueError(f"{b} queries but {prog.n_queries} predicates")
        return prog

    def _search_batch_spmd(self, xq, preds: Predicates, dp: int, cp: int,
                           k: Optional[int] = None, ef: Optional[int] = None,
                           route: Optional[str] = None):
        """The mesh-native path of the reference."""
        raise NotImplementedError(_SPMD_WAITS)

    # ------------------------------------------------------------------
    @staticmethod
    def _result(ids, d, dist_comps, pre_counts, n_alive: int,
                degraded: bool) -> SearchResult:
        """Assemble the engine's typed result: per-query route summary
        across the shards that answered (``mixed`` = the shard sketches
        disagreed), total distance comps, and the degraded flag (some
        configured shard contributed nothing — results are incomplete
        but serving continued)."""
        b = int(ids.shape[0])
        pre_counts = np.asarray(pre_counts)
        routes = np.where(pre_counts >= n_alive, "prefilter",
                          np.where(pre_counts == 0, "graph", "mixed"))
        return SearchResult(
            ids=ids, dists=d,
            stats=dict(dist_comps=np.asarray(dist_comps)),
            routes=routes, shed=np.zeros((b,), bool),
            degraded=np.full((b,), degraded), legacy_arity=2)

    # ------------------------------------------------------------------
    def search_batch_host(self, request: Union[SearchRequest, Tensor],
                          predicates: Optional[Predicates] = None):
        """The host-side shard walk + merge."""
        xq, preds, k, ef, route = self._unpack(request, predicates)
        return self._search_batch_host(xq, preds, k=k, ef=ef, route=route)

    def _search_batch_host(self, xq, preds: Predicates,
                           k: Optional[int] = None,
                           ef: Optional[int] = None,
                           route: Optional[str] = None):
        cfg = self.cfg
        b = xq.shape[0]
        k = cfg.k if k is None else k
        ef = ef if ef is not None else cfg.ef
        # compile once, share across shards (one schema corpus-wide); each
        # HybridIndex is exactly one corpus shard on one device
        program = self._program(preds, b)
        shard_spec = dataclasses.replace(self.execution_spec(),
                                         corpus_parallel=1)
        all_ids, all_d = [], []
        pre_counts = np.zeros((b,), np.int64)
        dist_comps = np.zeros((b,), np.int64)
        n_alive = 0
        for shard in self.shards:
            mirrors = 2 if (cfg.duplicate_dispatch and cfg.n_shards > 1) else 1
            result = None
            for attempt in range(mirrors):
                if not shard.healthy and attempt == 0:
                    if mirrors > 1:
                        # only count an actual mirror dispatch; without
                        # duplicate_dispatch the unhealthy primary simply
                        # drops out and no duplicate work happens
                        self.stats["duplicated_dispatches"] += 1
                    continue  # primary "failed"; mirror answers
                result = shard.index.search(
                    SearchRequest(xq=xq, predicates=program, k=k, ef=ef,
                                  route=route),
                    spec=shard_spec)
                break
            if result is None:  # all mirrors down -> shard contributes none
                continue
            n_alive += 1
            gids = torch.where(result.ids >= 0, result.ids + shard.base,
                               torch.full_like(result.ids, -1))
            all_ids.append(gids)
            all_d.append(result.dists)
            pre_counts += result.routes == "prefilter"
            dist_comps += np.asarray(result.stats["dist_comps"])
            self.stats["prefilter_routed"] += int(
                (result.routes == "prefilter").sum())
            self.stats["graph_routed"] += int(
                (result.routes == "graph").sum())
        self.stats["queries"] += b
        self.stats["batches"] += 1
        if not all_ids:
            # every shard (and mirror) down: degrade to an empty result set
            # instead of crashing the serving path — availability first
            return sentinel_result(b, k, device=self.device)
        ids = torch.cat(all_ids, dim=1)
        d = torch.cat(all_d, dim=1)
        mi, md = merge_topk(ids, d, k)
        return self._result(mi, md, dist_comps=dist_comps,
                            pre_counts=pre_counts, n_alive=n_alive,
                            degraded=n_alive < cfg.n_shards)

    # ------------------------------------------------------------------
    def serve(self, request: Union[SearchRequest, Tensor],
              predicates: Optional[Predicates] = None):
        """Batch an arbitrary request stream into cfg.batch_size chunks.

        Accepts a :class:`SearchRequest` or the legacy ``(xq,
        predicates)`` pair; predicate trees compile once for the whole
        stream and the compiled program is row-sliced per chunk.  Chunks
        are NOT padded here: each shard's ``HybridIndex.search`` pads to
        its batch buckets."""
        xq, preds, k, ef, route = self._unpack(request, predicates)
        b = self.cfg.batch_size
        n = xq.shape[0]
        program = self._program(preds, n)
        outs: List[SearchResult] = []
        for start in range(0, n, b):
            stop = min(start + b, n)
            req = SearchRequest(xq=xq[start:stop],
                                predicates=program.take(slice(start, stop)),
                                k=self.cfg.k if k is None else k, ef=ef,
                                route=route)
            outs.append(self.search_batch(req))
        return SearchResult.concatenate(outs)

    # ------------------------------------------------------------------
    def trace_counts(self) -> Dict[int, Dict[int, int]]:
        """Per-shard variant-cache entries by batch bucket (regression
        guard: steady-state serving must not mint new shapes)."""
        return {s: shard.index.cache.bucket_traces()
                for s, shard in enumerate(self.shards)}

    def spmd_traces(self) -> Dict[int, int]:
        """SPMD-kernel traces by bucket: none, as the port has no SPMD
        path yet."""
        return {}

    # ------------------------------------------------------------------
    # fault tolerance
    # ------------------------------------------------------------------
    def fail_shard(self, s: int):
        self.shards[s].healthy = False

    def rebuild_shard(self, s: int, seed: int = 0):
        """Re-materialize a failed shard from the source-of-truth arrays
        (in production: from the checkpoint artifact)."""
        shard = self.shards[s]
        per = shard.index.x.shape[0]
        lo = shard.base
        shard.index = HybridIndex.build(
            self._x[lo:lo + per], self._table.take(np.arange(lo, lo + per)),
            self.acorn, seed=seed + s, device=self.device)
        shard.healthy = True
