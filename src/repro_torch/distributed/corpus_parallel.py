"""Mesh-native corpus sharding: SPMD per-shard search + collective merge.

The serving engine shards its corpus row-wise into per-shard ACORN
indexes.  Its host loop walks them one after another; here the whole
fan-out runs as ONE SPMD program on a 2-D ``(data, corpus)`` mesh of
ranks (:mod:`repro_torch.distributed.collectives` says how ranks make a
mesh and how inputs and outputs map onto them):

  * the corpus is stacked on a leading shard axis (:class:`ShardedCorpus`:
    vectors, graph tables and packed attribute columns, padded to a common
    envelope) and the rank at corpus coordinate ``s`` searches shard ``s``;
  * queries are split along ``data`` and replicated along ``corpus``;
  * predicates arrive as a compiled :class:`repro_torch.core.plan.
    PredicateProgram` — per-query instruction rows split along ``data``
    like the queries — plus per-shard ``aux`` regex-leaf bitmaps; each
    rank evaluates its own shard's pass-masks in-program against the
    shard's columns (:func:`repro_torch.core.plan.evaluate_program`), so
    no ``(B, n_shard)`` mask crosses the host;
  * each rank runs the batched ACORN search (``core.search._search_impl``)
    on its shard, turns local row ids into global ids with its shard's
    base offset, and the cross-shard top-k merge is an all-gather of k
    candidates per shard along ``corpus`` + the deterministic (distance,
    global id) merge (:func:`repro_torch.distributed.collectives.
    gathered_topk_merge`); the batch slices are then all-gathered along
    ``data``, so every rank returns the whole, identical result.

The engine's state stays replicated on every rank (each rank holds every
shard, as the reference's one process does); the program reads only the
rank's own shard.

Shape-padding parity: stacking pads each shard's graph to the max level
count / row count / neighbor cap across shards with ``-1`` (and vectors
with zero rows).  Padded levels have an all ``-1`` ``pos`` table, so every
lookup degrades to an empty neighbor row and the greedy descent freezes
without a distance computation; padded rows never appear in any neighbor
table, so they are never visited or scored.  Padded *attribute* rows are
zero-filled and could satisfy a predicate (label 0 is a real value), so
the in-program evaluation masks rows ``>= n_rows`` to False.  Per-shard
results are therefore bit-identical to searching the shard's own unpadded
graph (``tests/test_torch_corpus_parallel.py``).

Fault injection and routing ride in as data: an ``alive`` (S,) mask drops
a failed shard's candidates before the merge, and per-(shard, query)
pre-filter routing decisions select host-computed exact results over the
graph search, keeping ACORN's §5.2 router bit-identical to the host loop.

Execution policy is ONE resolved :class:`repro_torch.core.plan.
ExecutionSpec` (``data_parallel`` × ``corpus_parallel`` = the mesh shape);
it ends every variant-cache key as ``(..., program_shape_sig, spec,
"corpus")``.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.batched import VariantCache, pad_rows, plan_chunks
from repro_torch.core.graph import INVALID, LayeredGraph
from repro_torch.core.plan import (_EVAL_ELEMS, ExecutionSpec, PackedColumns,
                                   PredicateProgram, TableSchema,
                                   evaluate_program, pack_columns, regex_aux)
from repro_torch.core.search import _search_impl

from .collectives import Mesh, all_gather_cat, gathered_topk_merge, get_mesh
from .query_parallel import local_device_count

Tensor = torch.Tensor


class ShardedCorpus(NamedTuple):
    """Row-sharded corpus stacked on a leading shard axis.

    Every field carries the shard axis first.  ``columns`` holds the packed
    attribute columns (``ints (S, C_int, n_max)``, ``bitsets (S, C_bit,
    n_max, W)``) the SPMD program evaluates compiled predicate programs
    against; ``None`` when the corpus was stacked without tables (graph-only
    parity harnesses) — such a corpus cannot serve predicate programs.
    """

    graph: LayeredGraph  # every field stacked: (S, ...)
    x: Tensor            # (S, n_max, d) vectors, zero-padded rows
    bases: Tensor        # (S,) int32 global row offset per shard
    n_rows: Tensor       # (S,) int32 valid rows per shard
    columns: Optional[PackedColumns] = None  # stacked: fields (S, ...)

    @property
    def n_shards(self) -> int:
        return int(self.bases.shape[0])


def stack_corpus(graphs: Sequence[LayeredGraph], xs: Sequence[Tensor],
                 bases: Sequence[int],
                 tables: Optional[Sequence] = None) -> ShardedCorpus:
    """Stack per-shard graphs/vectors (and attribute tables) into one
    :class:`ShardedCorpus` on the device of ``xs[0]``.

    Shards are padded to a common envelope: max level count, per-level max
    row count and neighbor cap (``-1`` filled), max corpus rows (zero-filled
    vectors, ``-1`` ``pos``, zero-filled attribute columns).  Padding is
    invisible to the search (see the module docstring).  ``tables``
    (per-shard ``AttributeTable``s sharing one schema) fills ``columns``.
    """
    s_count = len(graphs)
    if not s_count == len(xs) == len(bases):
        raise ValueError(f"{s_count} graphs, {len(xs)} vector blocks, "
                         f"{len(bases)} bases")
    dev = xs[0].device
    num_levels = max(g.num_levels for g in graphs)
    n_max = max(int(x.shape[0]) for x in xs)
    dim = int(xs[0].shape[1])

    x_stack = torch.zeros((s_count, n_max, dim), dtype=xs[0].dtype,
                          device=dev)
    for s, x in enumerate(xs):
        x_stack[s, : x.shape[0]] = x

    def full(*shape):
        return torch.full(shape, INVALID, dtype=torch.int32, device=dev)

    neighbors: List[Tensor] = []
    pos: List[Tensor] = []
    node_ids: List[Tensor] = []
    for lvl in range(num_levels):
        have = [g for g in graphs if lvl < g.num_levels]
        rows = max(1, max(int(g.neighbors[lvl].shape[0]) for g in have))
        cap = max(1, max(int(g.neighbors[lvl].shape[1]) for g in have))
        nb, po, ni = full(s_count, rows, cap), full(s_count, n_max), \
            full(s_count, rows)
        for s, g in enumerate(graphs):
            if lvl >= g.num_levels:
                continue  # all -1: the level is empty for this shard
            a = g.neighbors[lvl]
            nb[s, : a.shape[0], : a.shape[1]] = a
            po[s, : g.pos[lvl].shape[0]] = g.pos[lvl]
            ni[s, : g.node_ids[lvl].shape[0]] = g.node_ids[lvl]
        neighbors.append(nb)
        pos.append(po)
        node_ids.append(ni)

    levels = torch.zeros((s_count, n_max), dtype=torch.int32, device=dev)
    for s, g in enumerate(graphs):
        levels[s, : g.levels.shape[0]] = g.levels
    graph = LayeredGraph(
        neighbors=tuple(neighbors), pos=tuple(pos), node_ids=tuple(node_ids),
        entry_point=torch.stack([g.entry_point.reshape(()).to(
            device=dev, dtype=torch.int32) for g in graphs]),
        levels=levels)

    columns = None
    if tables is not None:
        if len(tables) != s_count:
            raise ValueError(f"{len(tables)} tables for {s_count} shards")
        schema = TableSchema.of(tables[0])
        for s, t in enumerate(tables[1:], start=1):
            if TableSchema.of(t) != schema:
                # slot lookups are positional: a shard with different
                # columns (or a different dict order) would silently pack
                # into the wrong slots and bend every compiled program
                raise ValueError(
                    f"shard {s} table schema {TableSchema.of(t)} != shard "
                    f"0 schema {schema} — corpus shards must share one "
                    "column layout")
        per = [pack_columns(t, schema) for t in tables]
        ci = per[0].ints.shape[0]
        cb, w = per[0].bitsets.shape[0], per[0].bitsets.shape[2]
        ints = torch.zeros((s_count, ci, n_max), dtype=torch.int32,
                           device=dev)
        bitsets = torch.zeros((s_count, cb, n_max, w), dtype=torch.int32,
                              device=dev)
        for s, pc in enumerate(per):
            n_s = pc.ints.shape[1]
            ints[s, :, :n_s] = pc.ints
            bitsets[s, :, :n_s] = pc.bitsets
        columns = PackedColumns(ints=ints, bitsets=bitsets)
    return ShardedCorpus(
        graph=graph, x=x_stack,
        bases=torch.as_tensor(np.asarray(list(bases), np.int32), device=dev),
        n_rows=torch.as_tensor(np.array([x.shape[0] for x in xs], np.int32),
                               device=dev),
        columns=columns)


def stack_regex_aux(tables: Sequence, n_max: int,
                    regex_leaves: Tuple[Tuple[str, str], ...]) -> Tensor:
    """Per-shard host-evaluated regex-leaf bitmaps, stacked (S, A, n_max).

    Rows pad with False beyond each shard's length; served from each
    table's ``(column, pattern)`` cache, so a repeated pattern costs one
    string-column scan per shard in all, not one per batch.
    """
    blocks = [regex_aux(t, regex_leaves) for t in tables]
    out = torch.zeros((len(tables), max(1, len(regex_leaves)), n_max),
                      dtype=torch.bool, device=blocks[0].device)
    for s, block in enumerate(blocks):
        out[s, : block.shape[0], : block.shape[1]] = block
    return out


def shard_slice(corpus: ShardedCorpus, s: int) -> Tuple[LayeredGraph, Tensor]:
    """Shard ``s``'s (padded) graph and vectors — the tensors the SPMD
    program searches on the rank at corpus coordinate ``s``."""
    g = corpus.graph
    graph = LayeredGraph(
        neighbors=tuple(a[s] for a in g.neighbors),
        pos=tuple(a[s] for a in g.pos),
        node_ids=tuple(a[s] for a in g.node_ids),
        entry_point=g.entry_point[s], levels=g.levels[s])
    return graph, corpus.x[s]


# ---------------------------------------------------------------------------
# mesh construction
# ---------------------------------------------------------------------------


def corpus_mesh(dp: int, cp: int) -> Mesh:
    """A 2-D ``(data, corpus)`` mesh over ranks ``0 … dp·cp−1`` (cached)."""
    ndev = dp * cp
    if ndev > local_device_count():
        raise ValueError(
            f"(data={dp}) x (corpus={cp}) mesh needs {ndev} devices but "
            f"only {local_device_count()} are in the process group")
    return get_mesh((dp, cp), ("data", "corpus"))


def resolve_corpus_mesh_shape(
    n_shards: int,
    data_parallel: Optional[int] = None,
    corpus_parallel: Optional[int] = None,
) -> Optional[Tuple[int, int]]:
    """Pick the ``(data, corpus)`` mesh shape for an ``n_shards`` corpus.

    The corpus axis holds exactly one shard per device, so its size is
    pinned to ``n_shards``; an explicit ``corpus_parallel`` naming any
    other value raises.  ``corpus_parallel=None``/``0`` means *auto*: use
    the SPMD path whenever there are at least ``n_shards`` devices and the
    corpus is actually sharded (``n_shards > 1``); pass
    ``corpus_parallel == n_shards`` explicitly to request SPMD even for a
    single shard.  The data axis takes ``data_parallel`` clamped to the
    leftover device budget (``None``/``0`` = all of it).  Returns ``None``
    when the devices cannot hold the mesh: the engine then serves through
    its host loop (availability first).
    """
    auto = corpus_parallel in (None, 0)
    if not auto and int(corpus_parallel) != n_shards:
        raise ValueError(
            f"corpus_parallel={corpus_parallel} but the corpus has "
            f"{n_shards} shards — the corpus mesh axis holds exactly one "
            "shard per device")
    if auto and n_shards <= 1:
        return None
    cp = n_shards
    ndev = local_device_count()
    if ndev < cp:
        return None
    budget = ndev // cp
    if not data_parallel:  # None / 0 -> all leftover devices
        dp = budget
    else:
        dp = max(1, min(int(data_parallel), budget))
    return dp, cp


# ---------------------------------------------------------------------------
# the SPMD program
# ---------------------------------------------------------------------------


def _shard_masks(program: PredicateProgram, columns: PackedColumns, s: int,
                 aux: Tensor, n_valid: Tensor) -> Tensor:
    """Shard ``s``'s (B, n_max) pass-masks, rows >= ``n_valid`` (a 0-d
    tensor on the device, read there: no host sync) False, in query chunks
    within the evaluator's element budget (as ``PredicateProgram.evaluate``
    chunks)."""
    b = program.n_queries
    ints, bitsets = columns.ints[s], columns.bitsets[s]
    step = max(1, _EVAL_ELEMS // max(int(ints.shape[1]), 1))
    return torch.cat([
        evaluate_program(program.take(slice(i, min(i + step, b))), ints,
                         bitsets, aux[s], n_valid=n_valid)
        for i in range(0, b, step)])


def corpus_search_fn(dp: int, cp: int, statics: dict) -> Callable:
    """The corpus-sharded SPMD search of one variant.

    Returns ``f(corpus, xq, program, aux, pre_ids, pre_d, use_pre, alive)``,
    called by every rank with the same whole inputs:

      * ``corpus``  — :class:`ShardedCorpus` (with ``columns``); the rank
        at corpus coordinate ``s`` reads shard ``s``;
      * ``xq``      — (B, d) queries, split along ``data``;
      * ``program`` — :class:`PredicateProgram`, per-query rows split
        along ``data`` like the queries (operands, not masks);
      * ``aux``     — (S, A, n_max) host-evaluated regex-leaf bitmaps;
      * ``pre_ids``/``pre_d`` — (S, B, k) host-computed exact pre-filter
        results for the (shard, query) pairs routed off the graph;
      * ``use_pre`` — (S, B) bool per-(shard, query) route decisions;
      * ``alive``   — (S,) bool; a dead shard contributes no candidates.

    Each rank evaluates its shard's pass-masks in-program (padded rows
    False), searches, applies the route swap, the global-id offset and
    ``alive``, and merges along ``corpus``; the slices are gathered along
    ``data``.  Output: merged global ids/dists (B, k) plus per-shard (S, B)
    dist_comps/hops, whole and identical on every rank.  ``B`` must be a
    multiple of ``dp``.
    """
    mesh = corpus_mesh(dp, cp)
    k = statics["k"]

    def apply(corpus, xq, program, aux, pre_ids, pre_d, use_pre, alive):
        b = xq.shape[0]
        outs = None
        if mesh.coordinate is not None:
            rows = mesh.block(b, "data")
            s = mesh.axis_index("corpus")
            graph, x = shard_slice(corpus, s)
            # in-program predicate evaluation against the shard's columns;
            # envelope-padded rows (>= n_rows) forced False
            mask = _shard_masks(program.take(rows), corpus.columns, s, aux,
                                corpus.n_rows[s])
            ids, d, st = _search_impl(graph, x, xq[rows], mask, **statics)
            # §5.2 routing: low-selectivity (shard, query) pairs take the
            # exact pre-filter answer computed on the host; the graph lanes
            # they rode are fixed-shape padding and are discarded here
            route_pre = use_pre[s, rows][:, None]
            ids = torch.where(route_pre, pre_ids[s, rows], ids)
            d = torch.where(route_pre, pre_d[s, rows], d)
            # local-id -> global-id offset; dead shards contribute nothing
            gids = torch.where((ids >= 0) & alive[s], ids + corpus.bases[s],
                               torch.full_like(ids, INVALID))
            d = torch.where(gids >= 0, d, torch.full_like(d, float("inf")))
            out_ids, out_d = gathered_topk_merge(gids, d, k, "corpus", mesh)
            outs = [all_gather_cat(t, mesh, "data", dim=0)
                    for t in (out_ids, out_d)]
            outs += [all_gather_cat(
                all_gather_cat(t, mesh, "data", dim=0)[None], mesh,
                "corpus", dim=0) for t in (st.dist_comps, st.hops)]
        n_s = corpus.n_shards
        return mesh.share(
            outs, [((b, k), torch.int32), ((b, k), torch.float32),
                   ((n_s, b), torch.int32), ((n_s, b), torch.int32)],
            xq.device)

    return apply


def _pad_queries(a: Tensor, pad: int) -> Tensor:
    """Pad the query axis (axis 1) of a per-shard tensor by repeating the
    last query's entry (discarded after the bucketed dispatch)."""
    tail = a[:, -1:].expand((a.shape[0], pad) + tuple(a.shape[2:]))
    return torch.cat([a, tail], dim=1)


def corpus_search_batch(
    corpus: ShardedCorpus,
    xq: Tensor,
    program: PredicateProgram,
    aux: Tensor,
    pre_ids: Tensor,
    pre_d: Tensor,
    use_pre: Tensor,
    alive: Tensor,
    *,
    k: int,
    ef: int,
    variant: str,
    m: int,
    m_beta: int,
    metric: str,
    compressed_level0: bool,
    max_expansions: int,
    spec: ExecutionSpec,
    buckets: Tuple[int, ...],
    cache: VariantCache,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Ragged-batch corpus-sharded SPMD search through the batch buckets.

    The corpus-sharded sibling of ``repro_torch.core.batched.search_batch``:
    queries (and the program's rows) are planned into mesh-multiple
    buckets (``plan_chunks(multiple_of=spec.data_parallel)``) and
    dispatched through ``cache``, whose keys end with
    ``(program_shape_sig, spec, "corpus")``, so a steady-state server
    records one entry per (bucket, config, program shape, mesh).  Returns
    merged global ids (B, k), dists (B, k), and per-shard dist_comps/hops
    (S, B).

    The reference fetches each chunk's outputs to the host here, against a
    GSPMD quirk of its compiler (a replicated output fed into a further
    traced op could compile to a cross-replica sum); torch has no such
    compiler step, and the outputs stay on the device.
    """
    spec = spec.resolve()
    dp, cp = spec.data_parallel, spec.corpus_parallel
    if not isinstance(dp, int) or not isinstance(cp, int) or dp < 1:
        raise ValueError(
            f"corpus_search_batch needs a resolved mesh spec, got {spec}")
    if corpus.n_shards != cp:
        raise ValueError(
            f"corpus has {corpus.n_shards} shards but corpus_parallel={cp}")
    if corpus.columns is None:
        raise ValueError(
            "corpus was stacked without attribute tables — in-program "
            "predicate evaluation needs the shards' columns "
            "(stack_corpus(..., tables=...))")
    statics = dict(k=k, ef=ef, variant=variant, m=m, m_beta=m_beta,
                   metric=metric, compressed_level0=compressed_level0,
                   max_expansions=max_expansions, spec=spec)
    total = xq.shape[0]
    dev = xq.device
    if total == 0:  # mirror search_batch's empty-batch contract
        z = torch.zeros((corpus.n_shards, 0), dtype=torch.int32, device=dev)
        return (torch.zeros((0, k), dtype=torch.int32, device=dev),
                torch.zeros((0, k), dtype=torch.float32, device=dev), z, z)
    outs = []
    start = 0
    for take, bucket in plan_chunks(total, buckets, multiple_of=dp):
        sl = slice(start, start + take)
        q = xq[sl]
        prog = program.take(sl)
        pi, pd = pre_ids[:, sl], pre_d[:, sl]
        up = use_pre[:, sl]
        if take < bucket:
            pad = bucket - take
            q = pad_rows(q, pad)
            prog = PredicateProgram.concat(
                [prog, prog.take(np.full(pad, take - 1))])
            pi, pd = _pad_queries(pi, pad), _pad_queries(pd, pad)
            up = _pad_queries(up, pad)
        key = (bucket, k, ef, variant, m, m_beta, metric, compressed_level0,
               max_expansions, program.shape_sig, spec, "corpus")
        fn = cache.get(key, lambda: corpus_search_fn(dp, cp, statics))
        ids, d, dcs, hps = fn(corpus, q, prog, aux, pi, pd, up, alive)
        outs.append((ids[:take], d[:take], dcs[:, :take], hps[:, :take]))
        start += take
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]),
            torch.cat([o[2] for o in outs], dim=1),
            torch.cat([o[3] for o in outs], dim=1))
