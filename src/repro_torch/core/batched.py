"""Bucketed batch execution for the hybrid-search pipeline.

Serving traffic arrives as ragged query sets.  ``search_batch`` pads each
request to a small, fixed set of batch buckets and dispatches through a
variant cache keyed on ``(bucket, k, ef, variant, ..., ExecutionSpec)``.
PyTorch runs eagerly, so nothing is compiled per key: :class:`VariantCache`
records one entry per key on first use, and ``bucket_traces()`` counts
those entries, so a steady-state server shows exactly one per
(bucket, search-config) pair, as the reference's trace count does.

Chunk planning minimizes padded compute with a small per-dispatch penalty
(``DISPATCH_COST_QUERIES``): 37 queries against buckets {16, 64} run as
16 + 16 + pad(5 -> 16) rather than one pad(37 -> 64) launch.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .graph import LayeredGraph
from .plan import ExecutionSpec, resolve_execution_spec
from .search import SearchStats, _search_impl

Tensor = torch.Tensor

DEFAULT_BUCKETS: Tuple[int, ...] = (1, 16, 64, 256)

# A dispatch costs roughly this many queries' worth of work; biases the
# planner toward padding a tail into one launch.
DISPATCH_COST_QUERIES = 4


def mesh_buckets(buckets: Tuple[int, ...],
                 multiple_of: int) -> Tuple[int, ...]:
    """Round each bucket up to a multiple of the mesh size and dedup."""
    bs = sorted(set(int(b) for b in buckets))
    if multiple_of <= 1:
        return tuple(bs)
    return tuple(sorted(set(
        -(-b // multiple_of) * multiple_of for b in bs)))


def plan_chunks(total: int, buckets: Tuple[int, ...],
                multiple_of: int = 1) -> List[Tuple[int, int]]:
    """Split ``total`` queries into (take, bucket) chunks.

    Greedy: each step picks the bucket minimizing padded compute plus the
    dispatch penalty for the remaining queries; ties prefer the larger
    bucket (fewer launches)."""
    if total < 0:
        raise ValueError(total)
    if multiple_of < 1:
        raise ValueError(f"invalid multiple_of {multiple_of}")
    bs = sorted(set(int(b) for b in buckets))
    if not bs or bs[0] < 1:
        raise ValueError(f"invalid buckets {buckets}")
    bs = list(mesh_buckets(bs, multiple_of))
    chunks: List[Tuple[int, int]] = []
    rem = total
    while rem > 0:
        best_b, best_cost = None, None
        for b in bs:
            launches = math.ceil(rem / b)
            cost = (launches * b + launches * DISPATCH_COST_QUERIES, -b)
            if best_cost is None or cost < best_cost:
                best_b, best_cost = b, cost
        take = min(rem, best_b)
        chunks.append((take, best_b))
        rem -= take
    return chunks


def bucket_for(n: int, buckets: Tuple[int, ...],
               multiple_of: int = 1) -> int:
    """The bucket a dispatch of ``n`` queries pads into — the first chunk
    :func:`plan_chunks` would plan."""
    if n < 1:
        raise ValueError(n)
    return plan_chunks(n, buckets, multiple_of=multiple_of)[0][1]


def coalesce_take(queued: int, buckets: Tuple[int, ...],
                  multiple_of: int = 1) -> int:
    """How many queued queries to drain into one coalesced dispatch: up to
    the largest bucket."""
    if queued < 0:
        raise ValueError(queued)
    bs = mesh_buckets(buckets, multiple_of)
    return min(queued, bs[-1])


@dataclass
class VariantCache:
    """Variant cache: one callable per (bucket, search-config) key.

    ``trace_counts`` records each key once, on first use — the
    counterpart of the reference's trace count, so the serving regression
    guard (no new entries on a repeated shape mix) keeps its meaning."""
    fns: Dict[tuple, Callable] = field(default_factory=dict)
    trace_counts: Dict[tuple, int] = field(default_factory=dict)

    def get(self, key: tuple, builder: Callable[[], Callable]) -> Callable:
        fn = self.fns.get(key)
        if fn is None:
            fn = self.fns[key] = builder()
            self.trace_counts[key] = self.trace_counts.get(key, 0) + 1
        return fn

    def bucket_traces(self) -> Dict[int, int]:
        """Entries per bucket size (key[0])."""
        out: Dict[int, int] = {}
        for key, n in self.trace_counts.items():
            out[key[0]] = out.get(key[0], 0) + n
        return out

    @property
    def num_traces(self) -> int:
        return sum(self.trace_counts.values())


def _build_variant(statics: dict, has_mask: bool) -> Callable:
    spec: ExecutionSpec = statics["spec"]
    if spec.data_parallel > 1:
        # queries + masks split along the 'data' mesh of ranks, graph and
        # vectors replicated (distributed/query_parallel.py)
        from repro_torch.distributed.query_parallel import sharded_search_fn
        return sharded_search_fn(spec.data_parallel, has_mask, statics)

    def fn(graph, x, xq, masks):
        return _search_impl(graph, x, xq, masks, **statics)
    return fn


def pad_rows(a: Tensor, pad: int) -> Tensor:
    """Pad a batch by repeating its last row ``pad`` times (discarded by
    the caller after the bucketed dispatch)."""
    return torch.cat([a, a[-1:].expand((pad,) + tuple(a.shape[1:]))])


def search_batch(
    graph: LayeredGraph,
    x: Tensor,
    xq: Tensor,
    pass_masks: Optional[Tensor],
    k: int = 10,
    ef: int = 64,
    variant: str = "acorn-gamma",
    m: int = 16,
    m_beta: int = 32,
    metric: str = "l2",
    compressed_level0: bool = True,
    max_expansions: int = 512,
    spec: Optional[ExecutionSpec] = None,
    buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
    cache: Optional[VariantCache] = None,
    use_kernel: Optional[bool] = None,
    interpret: Optional[bool] = None,
    expand_kernel: Optional[bool] = None,
    data_parallel: Optional[int] = None,
    corpus_parallel: Optional[int] = None,
) -> Tuple[Tensor, Tensor, SearchStats]:
    """Ragged-batch hybrid search through the batch buckets.

    Identical results to :func:`repro_torch.core.search.hybrid_search` on
    the same queries (padding lanes are discarded).  ``pass_masks=None``
    runs the unfiltered plain-HNSW substrate for every variant.  The
    retired knob kwargs raise ``TypeError``.  ``cache=None`` uses a fresh
    cache for this call.

    ``spec.data_parallel`` > 1 splits each bucket's queries over that many
    ranks of the default process group (``None``/``0`` = all of them;
    clamped to the group's size) through
    ``repro_torch.distributed.query_parallel``: every rank calls this with
    the whole batch and gets the whole result; buckets round up to
    mesh-size multiples and results stay bit-identical to the
    single-device path.  ``spec.corpus_parallel`` must resolve to 1
    (``None``/``0`` mean 1): this entry point searches ONE corpus shard;
    a sharded corpus runs through ``repro_torch.distributed.
    corpus_parallel.corpus_search_batch``.  The variant-cache key ends
    with the resolved spec.

    Returns ids (B, k), dists (B, k), SearchStats with (B,) fields.
    """
    cache = VariantCache() if cache is None else cache
    spec = resolve_execution_spec(
        spec, "search_batch", use_kernel=use_kernel, interpret=interpret,
        expand_kernel=expand_kernel, data_parallel=data_parallel,
        corpus_parallel=corpus_parallel)
    if spec.corpus_parallel not in (None, 0, 1):
        raise ValueError(
            f"corpus_parallel={spec.corpus_parallel}: search_batch searches "
            "a single corpus shard; use repro_torch.distributed."
            "corpus_parallel.corpus_search_batch (via ServingEngine) for a "
            "sharded corpus")
    if pass_masks is None:
        # without a predicate mask the filter/compress/two_hop strategies
        # are undefined, so every variant runs the plain-HNSW substrate
        variant = "hnsw"
        compressed_level0 = False
    dp = 1
    if spec.data_parallel != 1:  # None/0 -> every rank; N -> clamp
        from repro_torch.distributed.query_parallel import (
            resolve_data_parallel)
        dp = resolve_data_parallel(spec.data_parallel)
    spec = spec.resolve(data_parallel=dp, corpus_parallel=1)
    total = xq.shape[0]
    dev = xq.device
    if total == 0:
        z = torch.zeros((0,), dtype=torch.int32, device=dev)
        return (torch.zeros((0, k), dtype=torch.int32, device=dev),
                torch.zeros((0, k), dtype=torch.float32, device=dev),
                SearchStats(dist_comps=z, hops=z))
    statics = dict(k=k, ef=ef, variant=variant, m=m, m_beta=m_beta,
                   metric=metric, compressed_level0=compressed_level0,
                   max_expansions=max_expansions, spec=spec)
    outs = []
    start = 0
    for take, bucket in plan_chunks(total, buckets, multiple_of=dp):
        q = xq[start:start + take]
        msk = None if pass_masks is None else pass_masks[start:start + take]
        if take < bucket:
            q = pad_rows(q, bucket - take)
            if msk is not None:
                msk = pad_rows(msk, bucket - take)
        key = (bucket, k, ef, variant, m, m_beta, metric, compressed_level0,
               max_expansions, msk is not None, spec)
        fn = cache.get(key, lambda: _build_variant(
            statics, has_mask=msk is not None))
        ids, d, stats = fn(graph, x, q, msk)
        outs.append((ids[:take], d[:take], stats.dist_comps[:take],
                     stats.hops[:take]))
        start += take
    ids = torch.cat([o[0] for o in outs])
    d = torch.cat([o[1] for o in outs])
    stats = SearchStats(dist_comps=torch.cat([o[2] for o in outs]),
                        hops=torch.cat([o[3] for o in outs]))
    return ids, d, stats
