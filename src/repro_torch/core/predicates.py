"""Predicate-agnostic structured-filter system (paper §3.1, §7.1).

A predicate is a small expression tree over the columns of an
:class:`AttributeTable`: ``Equals`` (SIFT1M/Paper), ``Between`` over dates
(TripClick), ``ContainsAny`` over keyword lists (TripClick areas, LAION
keywords), ``RegexMatch`` over captions (LAION), and arbitrary boolean
combinations.  Trees compile into one columnar program
(``core/plan.py``) evaluated in one pass into (B, n) pass-masks;
:func:`evaluate` walks one tree directly, the oracle that program must
match bit for bit.  Regex has no tensor form: its leaves are evaluated on
the host with ``re`` into cached bitmaps.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# Attribute storage
# ---------------------------------------------------------------------------

_BITS = 32

# compiled-regex cache: ``re.compile`` once per distinct pattern,
# process-wide.  The predicate set is unbounded by design, so every
# query-content-keyed cache here is bounded with FIFO eviction.
_RE_CACHE: Dict[str, "re.Pattern"] = {}
_RE_CACHE_MAX = 1024
# per-table (column, pattern) mask entries (AttributeTable.regex_mask)
REGEX_MASK_CACHE_MAX = 256


def _fifo_put(cache: Dict, key, value, cap: int) -> None:
    if len(cache) >= cap:
        cache.pop(next(iter(cache)))
    cache[key] = value


def _compiled_regex(pattern: str) -> "re.Pattern":
    rx = _RE_CACHE.get(pattern)
    if rx is None:
        rx = re.compile(pattern)
        _fifo_put(_RE_CACHE, pattern, rx, _RE_CACHE_MAX)
    return rx


def pack_multihot(keyword_lists, n_keywords: int) -> np.ndarray:
    """Pack per-row keyword-id lists into a (n, ceil(n_keywords/32))
    uint32 bitset."""
    n = len(keyword_lists)
    words = (n_keywords + _BITS - 1) // _BITS
    out = np.zeros((n, words), dtype=np.uint32)
    for i, kws in enumerate(keyword_lists):
        for k in kws:
            out[i, k // _BITS] |= np.uint32(1) << np.uint32(k % _BITS)
    return out


def keywords_to_bitset(keywords, n_keywords: int) -> np.ndarray:
    words = (n_keywords + _BITS - 1) // _BITS
    q = np.zeros((words,), dtype=np.uint32)
    for k in keywords:
        q[k // _BITS] |= np.uint32(1) << np.uint32(k % _BITS)
    return q


@dataclass
class AttributeTable:
    """Columnar structured data attached to the vector dataset.

    int_cols:    name -> (n,) int32 tensor   (categories, dates, prices)
    bitset_cols: name -> (n, W) int32 tensor holding the bits of packed
                 uint32 multi-hot keyword sets (see ``convert.
                 table_from_arrays``)
    str_cols:    name -> np object array     (host-only; regex target)
    n_keywords:  name -> vocabulary size for each bitset column
    """

    int_cols: Dict[str, Tensor]
    bitset_cols: Dict[str, Tensor]
    str_cols: Dict[str, np.ndarray]
    n_keywords: Dict[str, int]
    # per-table plan-evaluation caches (never part of equality/printing):
    #   'regex'  -> {(column, pattern): (n,) np.bool_ mask}
    #   'packed' -> (TableSchema, PackedColumns)  [core/plan.py]
    #   'aux'    -> {regex leaf set: (A, n) bool tensor}
    _plan_cache: Dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def n(self) -> int:
        for c in self.int_cols.values():
            return int(c.shape[0])
        for c in self.bitset_cols.values():
            return int(c.shape[0])
        for c in self.str_cols.values():
            return int(len(c))
        raise ValueError("empty AttributeTable")

    @property
    def device(self) -> torch.device:
        """Device of the tensor columns (the CPU for a string-only table)."""
        for c in list(self.int_cols.values()) + list(self.bitset_cols.values()):
            return c.device
        return torch.device("cpu")

    def regex_mask(self, column: str, pattern: str) -> np.ndarray:
        """Host-evaluated ``pattern`` over ``str_cols[column]`` as a (n,)
        bool mask, cached by ``(column, pattern)``."""
        cache = self._plan_cache.setdefault("regex", {})
        key = (column, pattern)
        mask = cache.get(key)
        if mask is None:
            rx = _compiled_regex(pattern)
            col = self.str_cols[column]
            mask = np.fromiter((rx.search(s) is not None for s in col),
                               dtype=bool, count=len(col))
            _fifo_put(cache, key, mask, REGEX_MASK_CACHE_MAX)
        return mask

    def take(self, idx) -> "AttributeTable":
        """Row subset (sketch sample, corpus shard); regex leaf masks are
        sliced along instead of rescanned."""
        idx = np.asarray(idx)
        tidx = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
        sub = AttributeTable(
            int_cols={k: v[tidx] for k, v in self.int_cols.items()},
            bitset_cols={k: v[tidx] for k, v in self.bitset_cols.items()},
            str_cols={k: np.asarray(v, dtype=object)[idx]
                      for k, v in self.str_cols.items()},
            n_keywords=dict(self.n_keywords),
        )
        parent = self._plan_cache.get("regex")
        if parent:
            sub._plan_cache["regex"] = {k: v[idx] for k, v in parent.items()}
        return sub


# ---------------------------------------------------------------------------
# Predicate expression tree
# ---------------------------------------------------------------------------


class Predicate:
    """Base class. Composable with &, |, ~."""

    def __and__(self, other: "Predicate") -> "Predicate":
        return And((self, other))

    def __or__(self, other: "Predicate") -> "Predicate":
        return Or((self, other))

    def __invert__(self) -> "Predicate":
        return Not(self)

    @property
    def needs_host(self) -> bool:
        return False


@dataclass(frozen=True)
class Equals(Predicate):
    column: str
    value: int


@dataclass(frozen=True)
class OneOf(Predicate):
    column: str
    values: Tuple[int, ...]


@dataclass(frozen=True)
class Between(Predicate):
    """Inclusive range predicate (TripClick publication dates)."""

    column: str
    lo: int
    hi: int


@dataclass(frozen=True)
class ContainsAny(Predicate):
    """True when the row's keyword set intersects ``keywords``."""

    column: str
    keywords: Tuple[int, ...]


@dataclass(frozen=True)
class RegexMatch(Predicate):
    """Host-evaluated regex over a string column (LAION captions)."""

    column: str
    pattern: str

    @property
    def needs_host(self) -> bool:
        return True


@dataclass(frozen=True)
class And(Predicate):
    parts: Tuple[Predicate, ...]

    @property
    def needs_host(self) -> bool:
        return any(p.needs_host for p in self.parts)


@dataclass(frozen=True)
class Or(Predicate):
    parts: Tuple[Predicate, ...]

    @property
    def needs_host(self) -> bool:
        return any(p.needs_host for p in self.parts)


@dataclass(frozen=True)
class Not(Predicate):
    part: Predicate

    @property
    def needs_host(self) -> bool:
        return self.part.needs_host


@dataclass(frozen=True)
class TruePredicate(Predicate):
    """Matches everything — hybrid search degenerates to plain ANN."""


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


def evaluate(pred: Predicate, table: AttributeTable) -> Tensor:
    """Evaluate ``pred`` into a (n,) bool pass-mask on the table's device.

    A tree walk in tensor ops, except ``RegexMatch`` leaves: those run on
    the host (``AttributeTable.regex_mask``) and their masks move to the
    table's device before the combination."""
    if isinstance(pred, TruePredicate):
        return torch.ones((table.n,), dtype=torch.bool, device=table.device)
    if isinstance(pred, Equals):
        return table.int_cols[pred.column] == pred.value
    if isinstance(pred, OneOf):
        col = table.int_cols[pred.column]
        vals = torch.as_tensor(pred.values, dtype=col.dtype,
                               device=col.device).reshape(-1)
        return (col[:, None] == vals[None, :]).any(dim=-1)
    if isinstance(pred, Between):
        col = table.int_cols[pred.column]
        return (col >= pred.lo) & (col <= pred.hi)
    if isinstance(pred, ContainsAny):
        col = table.bitset_cols[pred.column]
        q = keywords_to_bitset(pred.keywords, table.n_keywords[pred.column])
        qt = torch.as_tensor(q.view(np.int32), device=col.device)
        return ((col & qt[None, :]) != 0).any(dim=-1)
    if isinstance(pred, RegexMatch):
        return torch.as_tensor(table.regex_mask(pred.column, pred.pattern),
                               device=table.device)
    if isinstance(pred, And):
        out = evaluate(pred.parts[0], table)
        for p in pred.parts[1:]:
            out = out & evaluate(p, table)
        return out
    if isinstance(pred, Or):
        out = evaluate(pred.parts[0], table)
        for p in pred.parts[1:]:
            out = out | evaluate(p, table)
        return out
    if isinstance(pred, Not):
        return ~evaluate(pred.part, table)
    raise TypeError(f"unknown predicate {type(pred)}")


def evaluate_batch(preds, table: AttributeTable) -> Tensor:
    """Evaluate a list of predicates -> (B, n) bool."""
    return torch.stack([evaluate(p, table) for p in preds], dim=0)


def _float32_mean(mask: Tensor) -> np.ndarray:
    """The float32 mean of each row of a bool mask, as count * (1 / n) in
    float32: the form XLA compiles the reference's float32 mean into."""
    count = mask.sum(dim=-1).cpu().numpy().astype(np.float32)
    return count * (np.float32(1) / np.float32(mask.shape[-1]))


def selectivity(pred: Predicate, table: AttributeTable) -> float:
    """Share of the table's rows that pass ``pred``."""
    return float(_float32_mean(evaluate(pred, table)))


# ---------------------------------------------------------------------------
# Selectivity estimation (cost-based routing, paper §5.2)
# ---------------------------------------------------------------------------


@dataclass
class SelectivitySketch:
    """Uniform row sample used to estimate predicate selectivity.

    The paper's cost model routes queries with estimated s < 1/γ to
    pre-filtering.  The sample is drawn with numpy exactly as the
    reference draws it, so the estimates, and therefore the routing, match
    the reference on the same table and seed.
    """

    sample: AttributeTable
    n_total: int

    @staticmethod
    def build(table: AttributeTable, sample_size: int = 4096,
              seed: int = 0) -> "SelectivitySketch":
        n = table.n
        rng = np.random.default_rng(seed)
        idx = rng.choice(n, size=min(sample_size, n), replace=False)
        return SelectivitySketch(sample=table.take(idx), n_total=n)

    def estimate(self, pred: Predicate) -> float:
        return float(self.estimate_batch([pred])[0])

    def estimate_batch(self, preds) -> np.ndarray:
        """Estimate a whole batch's selectivities in one fused pass over
        the sample.  ``preds`` is a sequence of predicate trees or a
        compiled ``PredicateProgram``.  Returns (B,) float64 holding the
        float32 product count * (1 / sample size): the form XLA compiles
        the reference's float32 mean into, so estimates (and routing)
        match it bit for bit."""
        from .plan import PredicateProgram, compile_predicates
        prog = (preds if isinstance(preds, PredicateProgram)
                else compile_predicates(preds, self.sample))
        return _float32_mean(prog.evaluate(self.sample)).astype(np.float64)
