"""Query-plan API: compiled predicate programs + execution specs.

1. **Compiled predicate programs** (:func:`compile_predicates` →
   :class:`PredicateProgram`): a batch of heterogeneous predicate trees
   compiles on the host into one flat columnar program — per-query
   instruction rows (op-code + column slot + operand arrays, numpy).
   :func:`evaluate_program` runs the whole batch as one pass over the
   slot-stacked columns (:class:`PackedColumns`): a postorder stack
   machine whose op-codes are data, so any mix of predicate shapes shares
   one evaluator.  Host-only leaves (``RegexMatch``) are evaluated once
   per ``(column, pattern)`` into cached bitmaps that ride into the pass
   as ``aux`` rows.
2. **ExecutionSpec**: the execution knobs as one frozen value.  In the
   port kernel routing follows the tensors' device, so only the mesh knobs
   remain, and this slice runs one device.
3. **SearchRequest / SearchResult**: one batch of work and its typed
   result, for :meth:`repro_torch.core.index.HybridIndex.search`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

from .predicates import (REGEX_MASK_CACHE_MAX, And, AttributeTable, Between,
                         ContainsAny, Equals, Not, OneOf, Or, Predicate,
                         RegexMatch, TruePredicate, _fifo_put,
                         keywords_to_bitset)

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# ExecutionSpec
# ---------------------------------------------------------------------------

_WAITS = ("waits for the port of distributed/ (ROADMAP.md, queue 1 item "
          "3); the port runs one device")


@dataclass(frozen=True)
class ExecutionSpec:
    """How a search executes, independent of what it searches.

    ``data_parallel``   — query-shard the batch over this many devices;
    ``corpus_parallel`` — corpus-mesh axis size for sharded serving.

    The reference's ``use_kernel``/``interpret``/``expand_kernel`` have no
    counterpart: a CUDA tensor runs the kernels, a CPU tensor their plain
    versions.  Any mesh size other than 1 raises ``NotImplementedError``.
    Frozen + hashable: the spec is the last component of every
    variant-cache key.
    """

    data_parallel: int = 1
    corpus_parallel: int = 1

    def __post_init__(self):
        for name in ("data_parallel", "corpus_parallel"):
            v = getattr(self, name)
            if v != 1:
                raise NotImplementedError(f"ExecutionSpec({name}={v!r}) "
                                          + _WAITS)


_KNOB_NAMES = ("use_kernel", "interpret", "expand_kernel", "data_parallel",
               "corpus_parallel")


def resolve_execution_spec(spec: Optional[ExecutionSpec], where: str,
                           base: Optional[ExecutionSpec] = None,
                           **legacy) -> ExecutionSpec:
    """Resolve the ``spec=`` argument; reject the retired knob kwargs.

    Passing any of ``use_kernel``/``interpret``/``expand_kernel``/
    ``data_parallel``/``corpus_parallel`` (non-``None``) raises
    ``TypeError``, as in the reference."""
    passed = {k: v for k, v in legacy.items() if v is not None}
    unknown = set(passed) - set(_KNOB_NAMES)
    if unknown:
        raise TypeError(f"{where}: unknown execution knobs {sorted(unknown)}")
    if passed:
        raise TypeError(
            f"{where}: the legacy execution-knob kwargs {sorted(passed)} "
            "were removed; kernel routing follows the tensors' device and "
            "mesh knobs ride in spec=ExecutionSpec(...)")
    if spec is not None:
        return spec
    return base or ExecutionSpec()


# ---------------------------------------------------------------------------
# SearchRequest / SearchResult
# ---------------------------------------------------------------------------


@dataclass
class SearchRequest:
    """One batch of hybrid-search work.

    ``predicates``: predicate trees (compiled on entry), a compiled
    :class:`PredicateProgram`, or ``None`` for unfiltered ANN.  ``k``/``ef``
    of ``None`` defer to the consumer's default.  ``route`` forces the §5.2
    router: ``None`` (cost-based), ``"graph"`` or ``"prefilter"``.
    """

    xq: Tensor
    predicates: Union[Sequence[Predicate], "PredicateProgram", None] = None
    k: Optional[int] = None
    ef: Optional[int] = None
    route: Optional[str] = None


@dataclass(frozen=True)
class SearchResult:
    """Typed result of a hybrid search.

    ``ids`` (B, k) int32 global row ids (-1 = empty slot); ``dists``
    (B, k) float32 (``inf`` on empty slots); ``stats`` per-query numpy stat
    arrays by name; ``routes`` (B,) route taken per query; ``shed`` /
    ``degraded`` (B,) bool.  Tuple unpacking yields ``(ids, dists)`` or,
    with ``legacy_arity=3``, ``(ids, dists, info)``.
    """

    ids: Tensor
    dists: Tensor
    stats: Dict[str, Any] = field(default_factory=dict)
    routes: Optional[np.ndarray] = None
    shed: Optional[np.ndarray] = None
    degraded: Optional[np.ndarray] = None
    legacy_arity: int = 2

    @property
    def info(self) -> Dict[str, Any]:
        out = dict(self.stats)
        if self.routes is not None:
            out["routes"] = self.routes
        return out

    @property
    def n_queries(self) -> int:
        return int(self.ids.shape[0])

    def __iter__(self):
        yield self.ids
        yield self.dists
        if self.legacy_arity >= 3:
            yield self.info

    def __len__(self) -> int:
        return max(2, self.legacy_arity)

    def __getitem__(self, i):
        return tuple(self)[i]

    def take(self, idx) -> "SearchResult":
        """Row-subset the result (a slice or an index array)."""
        if isinstance(idx, slice):
            tidx = idx
        else:
            idx = np.asarray(idx)
            tidx = torch.as_tensor(idx, dtype=torch.int64,
                                   device=self.ids.device)
        stats = {name: np.asarray(v)[idx] for name, v in self.stats.items()}
        return SearchResult(
            ids=self.ids[tidx], dists=self.dists[tidx], stats=stats,
            routes=None if self.routes is None else self.routes[idx],
            shed=None if self.shed is None else self.shed[idx],
            degraded=None if self.degraded is None else self.degraded[idx],
            legacy_arity=self.legacy_arity)

    @staticmethod
    def concatenate(results: Sequence["SearchResult"]) -> "SearchResult":
        """Row-concatenate results from one surface."""
        if not results:
            raise ValueError("concatenate needs at least one result")
        first = results[0]
        stats = {name: np.concatenate(
                     [np.asarray(r.stats[name]) for r in results])
                 for name in first.stats}

        def _cat(get):
            vals = [get(r) for r in results]
            return None if vals[0] is None else np.concatenate(vals)

        return SearchResult(
            ids=torch.cat([r.ids for r in results]),
            dists=torch.cat([r.dists for r in results]),
            stats=stats, routes=_cat(lambda r: r.routes),
            shed=_cat(lambda r: r.shed), degraded=_cat(lambda r: r.degraded),
            legacy_arity=first.legacy_arity)


def sentinel_result(b: int, k: int, shed: bool = False,
                    legacy_arity: int = 2,
                    device: DeviceLike = "cuda") -> SearchResult:
    """The -1/inf empty result set (all-shards-down / shed-load shape)."""
    dev = resolve_device(device)
    return SearchResult(
        ids=torch.full((b, k), -1, dtype=torch.int32, device=dev),
        dists=torch.full((b, k), float("inf"), dtype=torch.float32,
                         device=dev),
        stats=dict(dist_comps=np.zeros((b,), np.int64)),
        routes=np.full((b,), "none"),
        shed=np.full((b,), shed),
        degraded=np.full((b,), not shed),
        legacy_arity=legacy_arity)


# ---------------------------------------------------------------------------
# Table schema + slot-stacked columns
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TableSchema:
    """Column-name → slot layout a program compiles against."""

    int_cols: Tuple[str, ...]
    bitset_cols: Tuple[str, ...]
    n_keywords: Tuple[int, ...]          # per bitset column
    str_cols: Tuple[str, ...]

    @staticmethod
    def of(table_or_schema) -> "TableSchema":
        if isinstance(table_or_schema, TableSchema):
            return table_or_schema
        t = table_or_schema
        return TableSchema(
            int_cols=tuple(t.int_cols),
            bitset_cols=tuple(t.bitset_cols),
            n_keywords=tuple(t.n_keywords[c] for c in t.bitset_cols),
            str_cols=tuple(t.str_cols))

    @property
    def bitset_words(self) -> int:
        """Packed-word width of the widest bitset column (min 1)."""
        return max([(nk + 31) // 32 for nk in self.n_keywords], default=1)

    def int_slot(self, column: str) -> int:
        return self.int_cols.index(column)

    def bitset_slot(self, column: str) -> int:
        return self.bitset_cols.index(column)


class PackedColumns(NamedTuple):
    """Slot-indexed view of an AttributeTable.

    ``ints``    — (C_int, n) int32, stacked in schema slot order;
    ``bitsets`` — (C_bit, n, W) int32 bit words, zero-padded to the
                  schema's ``bitset_words`` width.
    Both carry at least one (zeroed) column, never referenced by valid
    instructions.
    """

    ints: Tensor
    bitsets: Tensor


def pack_columns(table: AttributeTable,
                 schema: Optional[TableSchema] = None) -> PackedColumns:
    """Stack a table's columns into slot order (cached on the table)."""
    schema = TableSchema.of(table) if schema is None else schema
    cached = table._plan_cache.get("packed")
    if cached is not None and cached[0] == schema:
        return cached[1]
    n = table.n
    w = schema.bitset_words
    dev = table.device
    if schema.int_cols:
        cols = []
        i32 = torch.iinfo(torch.int32)
        for c in schema.int_cols:
            col = torch.as_tensor(table.int_cols[c], device=dev)
            if col.dtype != torch.int32:
                if bool(((col < i32.min) | (col > i32.max)).any()):
                    raise ValueError(
                        f"int column {c!r} ({col.dtype}) holds values "
                        "outside int32 range — the compiled program "
                        "evaluates int32 slots")
                col = col.to(torch.int32)
            cols.append(col)
        ints = torch.stack(cols)
    else:
        ints = torch.zeros((1, n), dtype=torch.int32, device=dev)
    if schema.bitset_cols:
        mats = []
        for c in schema.bitset_cols:
            col = torch.as_tensor(table.bitset_cols[c], device=dev)
            if col.shape[1] < w:
                col = torch.nn.functional.pad(col, (0, w - col.shape[1]))
            mats.append(col)
        bitsets = torch.stack(mats)
    else:
        bitsets = torch.zeros((1, n, w), dtype=torch.int32, device=dev)
    packed = PackedColumns(ints=ints, bitsets=bitsets)
    table._plan_cache["packed"] = (schema, packed)
    return packed


def regex_aux(table: AttributeTable,
              regex_leaves: Tuple[Tuple[str, str], ...]) -> Tensor:
    """The (A, n) aux bitmap block for a program's regex leaves (A >= 1),
    cached per leaf set on the table (bounded, FIFO)."""
    cache = table._plan_cache.setdefault("aux", {})
    block = cache.get(regex_leaves)
    if block is None:
        if not regex_leaves:
            block = torch.zeros((1, table.n), dtype=torch.bool,
                                device=table.device)
        else:
            block = torch.as_tensor(np.stack(
                [table.regex_mask(col, pat) for col, pat in regex_leaves]),
                device=table.device)
        _fifo_put(cache, regex_leaves, block, REGEX_MASK_CACHE_MAX)
    return block


# ---------------------------------------------------------------------------
# The predicate IR
# ---------------------------------------------------------------------------

OP_NOP = 0       # padding
OP_TRUE = 1      # push all-true
OP_EQ = 2        # push int_col[slot] == lo
OP_ONEOF = 3     # push int_col[slot] ∈ vals[:nval]
OP_BETWEEN = 4   # push lo <= int_col[slot] <= hi
OP_CONTAINS = 5  # push (bitset_col[slot] & qbits) != 0 (any word)
OP_AUX = 6       # push aux[slot] (host-evaluated regex leaf bitmap)
OP_AND = 7       # pop two, push and
OP_OR = 8        # pop two, push or
OP_NOT = 9       # negate top

# (B_chunk * n) element budget of one evaluation chunk
_EVAL_ELEMS = 1 << 25


@dataclass
class PredicateProgram:
    """A batch of predicate trees as one flat columnar program (numpy).

    ``B`` queries, ``L`` instruction slots, ``V`` OneOf operand width,
    ``W`` bitset words: ops (B, L) int32; slot (B, L) int32; lo/hi (B, L)
    int32; vals (B, L, V) int32; nval (B, L) int32; qbits (B, L, W) uint32.
    ``depth`` (stack depth), ``regex_leaves`` (the ordered
    ``(column, pattern)`` host leaves the ``aux`` rows map to) and
    ``schema`` (the :class:`TableSchema` the slots were compiled against)
    complete it.
    """

    ops: np.ndarray
    slot: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    vals: np.ndarray
    nval: np.ndarray
    qbits: np.ndarray
    depth: int = 2
    regex_leaves: Tuple[Tuple[str, str], ...] = ()
    schema: Optional[TableSchema] = None

    @property
    def n_queries(self) -> int:
        return int(self.ops.shape[0])

    @property
    def shape_sig(self) -> tuple:
        """Hashable program-shape signature."""
        return (int(self.ops.shape[1]), int(self.vals.shape[2]),
                int(self.qbits.shape[2]), self.depth,
                len(self.regex_leaves))

    def take(self, idx) -> "PredicateProgram":
        """Row-subset the program (e.g. the pre-filter-routed queries) by a
        slice or an index array."""
        if not isinstance(idx, slice):
            idx = np.asarray(idx)
        return PredicateProgram(
            ops=self.ops[idx], slot=self.slot[idx], lo=self.lo[idx],
            hi=self.hi[idx], vals=self.vals[idx], nval=self.nval[idx],
            qbits=self.qbits[idx], depth=self.depth,
            regex_leaves=self.regex_leaves, schema=self.schema)

    @staticmethod
    def concat(programs: Sequence["PredicateProgram"]) -> "PredicateProgram":
        """Row-concatenate programs sharing one admission shape."""
        if not programs:
            raise ValueError("concat needs at least one program")
        first = programs[0]
        for p in programs[1:]:
            if (p.shape_sig != first.shape_sig
                    or p.regex_leaves != first.regex_leaves
                    or p.schema != first.schema):
                raise ValueError(
                    f"cannot concat programs of different admission "
                    f"shapes: {p.shape_sig} vs {first.shape_sig} "
                    "(group by admission_key before coalescing)")
        if len(programs) == 1:
            return first
        cat = np.concatenate
        return PredicateProgram(
            ops=cat([p.ops for p in programs]),
            slot=cat([p.slot for p in programs]),
            lo=cat([p.lo for p in programs]),
            hi=cat([p.hi for p in programs]),
            vals=cat([p.vals for p in programs]),
            nval=cat([p.nval for p in programs]),
            qbits=cat([p.qbits for p in programs]),
            depth=first.depth, regex_leaves=first.regex_leaves,
            schema=first.schema)

    def evaluate(self, table: AttributeTable) -> Tensor:
        """(B, n) bool pass-masks over ``table``, on the table's device.

        Columns are packed by name through the program's compile-time
        schema.  Queries run in chunks so one chunk's (rows, n)
        intermediates stay within a fixed element budget."""
        b = self.n_queries
        n = table.n
        if b == 0:
            return torch.zeros((0, n), dtype=torch.bool, device=table.device)
        cols = pack_columns(table, self.schema)
        aux = regex_aux(table, self.regex_leaves)
        step = max(1, _EVAL_ELEMS // max(n, 1))
        return torch.cat([
            evaluate_program(self.take(np.arange(s, min(s + step, b))),
                             cols.ints, cols.bitsets, aux)
            for s in range(0, b, step)])


def admission_key(program: PredicateProgram, k: int, ef: int,
                  route: Optional[str]) -> tuple:
    """The admission-queue grouping key: programs sharing it concatenate
    cleanly (:meth:`PredicateProgram.concat`)."""
    return (program.shape_sig, program.regex_leaves, program.schema,
            int(k), int(ef), route)


def _bucket_up(x: int, multiple: int, floor: int) -> int:
    return max(floor, -(-x // multiple) * multiple)


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


class _Emitter:
    def __init__(self, schema: TableSchema,
                 regex_slots: Dict[Tuple[str, str], int]):
        self.schema = schema
        self.regex_slots = regex_slots
        self.instrs: List[tuple] = []  # (op, slot, lo, hi, vals, qbits)
        self.sp = 0
        self.max_sp = 0

    def _push(self, op, slot=0, lo=0, hi=0, vals=(), qbits=()):
        self.instrs.append((op, slot, lo, hi, tuple(vals), tuple(qbits)))
        self.sp += 1
        self.max_sp = max(self.max_sp, self.sp)

    def _combine(self, op):
        self.instrs.append((op, 0, 0, 0, (), ()))
        if op != OP_NOT:
            self.sp -= 1

    def emit(self, pred: Predicate) -> None:
        s = self.schema
        if isinstance(pred, TruePredicate):
            self._push(OP_TRUE)
        elif isinstance(pred, Equals):
            self._push(OP_EQ, slot=s.int_slot(pred.column),
                       lo=int(pred.value))
        elif isinstance(pred, OneOf):
            self._push(OP_ONEOF, slot=s.int_slot(pred.column),
                       vals=tuple(int(v) for v in pred.values))
        elif isinstance(pred, Between):
            self._push(OP_BETWEEN, slot=s.int_slot(pred.column),
                       lo=int(pred.lo), hi=int(pred.hi))
        elif isinstance(pred, ContainsAny):
            nk = s.n_keywords[s.bitset_slot(pred.column)]
            q = keywords_to_bitset(pred.keywords, nk)
            self._push(OP_CONTAINS, slot=s.bitset_slot(pred.column),
                       qbits=tuple(int(w) for w in q))
        elif isinstance(pred, RegexMatch):
            key = (pred.column, pred.pattern)
            aux_row = self.regex_slots.setdefault(key, len(self.regex_slots))
            self._push(OP_AUX, slot=aux_row)
        elif isinstance(pred, (And, Or)):
            if not pred.parts:
                raise ValueError(f"{type(pred).__name__} needs >= 1 part")
            op = OP_AND if isinstance(pred, And) else OP_OR
            self.emit(pred.parts[0])
            for p in pred.parts[1:]:
                self.emit(p)
                self._combine(op)
        elif isinstance(pred, Not):
            self.emit(pred.part)
            self._combine(OP_NOT)
        else:
            raise TypeError(f"cannot compile predicate {type(pred)}")


def compile_predicates(preds: Sequence[Predicate],
                       schema) -> PredicateProgram:
    """Compile a batch of predicate trees against a table schema.

    ``schema`` is a :class:`TableSchema` or an :class:`AttributeTable`.
    Instruction count, OneOf operand width and stack depth are bucketed
    (multiples of 4 / powers of two) exactly as in the reference, so both
    packages compile a batch into the same arrays.  Regex leaves are
    deduplicated across the batch by ``(column, pattern)``.
    """
    schema = TableSchema.of(schema)
    if len(preds) == 0:
        raise ValueError("compile_predicates needs at least one predicate")
    regex_slots: Dict[Tuple[str, str], int] = {}
    emitters = []
    for p in preds:
        e = _Emitter(schema, regex_slots)
        e.emit(p)
        if e.sp != 1:
            raise ValueError("postorder compilation must leave one result")
        emitters.append(e)

    b = len(emitters)
    length = _bucket_up(max(len(e.instrs) for e in emitters), 4, 4)
    depth = max(2, _next_pow2(max(e.max_sp for e in emitters)))
    vmax = max((len(i[4]) for e in emitters for i in e.instrs), default=0)
    vwidth = max(4, _next_pow2(vmax)) if vmax else 4
    w = schema.bitset_words

    ops = np.zeros((b, length), np.int32)
    slot = np.zeros((b, length), np.int32)
    lo = np.zeros((b, length), np.int32)
    hi = np.zeros((b, length), np.int32)
    vals = np.zeros((b, length, vwidth), np.int32)
    nval = np.zeros((b, length), np.int32)
    qbits = np.zeros((b, length, w), np.uint32)
    for qi, e in enumerate(emitters):
        for li, (op, sl, l_, h_, vs, qb) in enumerate(e.instrs):
            ops[qi, li] = op
            slot[qi, li] = sl
            lo[qi, li], hi[qi, li] = l_, h_
            nval[qi, li] = len(vs)
            if vs:
                vals[qi, li, : len(vs)] = vs
            if qb:
                qbits[qi, li, : len(qb)] = qb
    regex_leaves = tuple(sorted(regex_slots, key=regex_slots.get))
    return PredicateProgram(
        ops=ops, slot=slot, lo=lo, hi=hi, vals=vals, nval=nval,
        qbits=qbits, depth=depth, regex_leaves=regex_leaves,
        schema=schema)


# ---------------------------------------------------------------------------
# The evaluator
# ---------------------------------------------------------------------------


def evaluate_program(prog: PredicateProgram, ints: Tensor, bitsets: Tensor,
                     aux: Tensor, n_valid: Optional[int] = None) -> Tensor:
    """Run the whole program batch in one pass: (B, n) bool masks.

    ``ints`` (C_int, n) int32 and ``bitsets`` (C_bit, n, W) int32 — a
    :class:`PackedColumns`; ``aux`` (A, n) bool regex-leaf bitmaps.
    ``n_valid``, when given, forces rows >= n_valid to False (the guard for
    padded corpus shards, whose zero-filled rows could otherwise satisfy a
    predicate the real shard never stored).

    The stack is a (B, S, n) bool tensor; each of the L instruction steps
    computes every leaf value once per query row and writes the stack at
    the per-query stack pointer.
    """
    dev = ints.device
    as_t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
    ops = as_t(prog.ops).long()
    slot = as_t(prog.slot).long()
    lo_all, hi_all = as_t(prog.lo), as_t(prog.hi)
    vals, nval = as_t(prog.vals), as_t(prog.nval)
    qbits = as_t(np.ascontiguousarray(prog.qbits, dtype=np.uint32)
                 .view(np.int32))
    b, length = ops.shape
    n = ints.shape[1]
    s_depth = prog.depth
    stack = torch.zeros((b, s_depth, n), dtype=torch.bool, device=dev)
    sp = torch.zeros((b,), dtype=torch.int64, device=dev)
    srange = torch.arange(s_depth, device=dev)
    rows = torch.arange(b, device=dev)

    def _top(ptr: Tensor) -> Tensor:
        """stack row at (clamped) ptr: (B, n)."""
        return stack[rows, ptr.clamp(0, s_depth - 1)]

    for step in range(length):
        op = ops[:, step]                                  # (B,)
        sl = slot[:, step]
        lo = lo_all[:, step][:, None]
        hi = hi_all[:, step][:, None]
        col = ints[sl.clamp(0, ints.shape[0] - 1)]         # (B, n)
        leaf_eq = col == lo
        leaf_bt = (col >= lo) & (col <= hi)
        vs = vals[:, step]                                 # (B, V)
        vmask = (torch.arange(vs.shape[1], device=dev)[None]
                 < nval[:, step][:, None])
        leaf_oneof = ((col[:, :, None] == vs[:, None, :])
                      & vmask[:, None, :]).any(dim=-1)
        bcol = bitsets[sl.clamp(0, bitsets.shape[0] - 1)]  # (B, n, W)
        qb = qbits[:, step][:, None, :]                    # (B, 1, W)
        leaf_ca = ((bcol & qb) != 0).any(dim=-1)
        leaf_aux = aux[sl.clamp(0, aux.shape[0] - 1)]      # (B, n)
        is_op = op[:, None]
        leaf = torch.zeros_like(leaf_eq)
        for code, val in ((OP_AUX, leaf_aux), (OP_CONTAINS, leaf_ca),
                          (OP_BETWEEN, leaf_bt), (OP_ONEOF, leaf_oneof),
                          (OP_EQ, leaf_eq),
                          (OP_TRUE, torch.ones_like(leaf_eq))):
            leaf = torch.where(is_op == code, val, leaf)

        top1 = _top(sp - 1)
        top2 = _top(sp - 2)
        is_leaf = (op >= OP_TRUE) & (op <= OP_AUX)
        value = torch.where(
            is_leaf[:, None], leaf,
            torch.where((op == OP_NOT)[:, None], ~top1,
                        torch.where((op == OP_AND)[:, None], top2 & top1,
                                    top2 | top1)))
        wpos = torch.where(is_leaf, sp,
                           torch.where(op == OP_NOT, sp - 1, sp - 2))
        active = op != OP_NOP
        write = (srange[None] == wpos[:, None]) & active[:, None]  # (B, S)
        stack = torch.where(write[:, :, None], value[:, None, :], stack)
        push = torch.where(is_leaf, 1, torch.where(op == OP_NOT, 0, -1))
        sp = sp + torch.where(active, push, 0)

    out = stack[:, 0]
    if n_valid is not None:
        out = out & (torch.arange(n, device=dev)[None] < n_valid)
    return out


def evaluate_predicates(preds: Sequence[Predicate],
                        table: AttributeTable) -> Tensor:
    """One-shot convenience: compile against ``table``'s schema and run
    the fused pass.  The program-compiled, bit-identical replacement for
    :func:`repro_torch.core.predicates.evaluate_batch`."""
    return compile_predicates(preds, table).evaluate(table)
