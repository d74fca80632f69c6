"""Paper-faithful incremental (sequential-insert) construction (§5.2).

This builder reproduces the *cost structure* of ACORN's construction —
TTI scaling as O(n·γ·log n·log γ) versus HNSW's O(n·log n) — which the
bulk builder (build.py) intentionally does not (its per-level exact-KNN
cost is γ-independent).  Table-4 style TTI measurements use it; large
search workloads use the bulk one.

Mechanics per inserted node v (HNSW with ACORN's changes):
  1. its level l(v), drawn from the exponential distribution or given;
  2. greedy descent from the entry point through the levels above l(v),
     with metadata-agnostic truncated lookups (first M entries — §5.2);
  3. for levels min(l(v), L)..0: a beam search with ef = efc·γ (ACORN) /
     efc (HNSW) whose first cap entries become v's list;
  4. reverse edges: each candidate links back to v, evicting its
     farthest neighbor on overflow.

The insert loop runs on the host over tensors on ``x``'s device.  The
reference jits one fixed-shape insert; here:

* levels that the reference masks out (above min(l(v), entry level), or
  not above l(v) in the descent) are skipped: they change nothing;
* the beam and descent loops are guarded (a finished loop's state is
  frozen), so their termination is read only every :data:`BEAM_STEPS` /
  :data:`GREEDY_STEPS` iterations; on a CUDA device a level's
  :data:`BEAM_STEPS` beam iterations replay as one captured CUDA graph;
* the reverse edges are one vectorised update over v's candidates
  instead of a loop over them: the candidates are distinct (the beam's
  visited set admits each id once), so no update reads another's row.
  Each level's table has a spare last row that absent candidates write
  to, so the update needs no host sync.

Ties fall as in the reference: the beam's sort is stable and ``argmin`` /
``argmax`` pick the first of equal values.  Where a level's cap exceeds
the beam width (``efc`` < 2M for HNSW and ACORN-1, e.g. M = 32 with
efc = 40), the list takes the beam's ``ef`` entries and -1 padding; the
reference raises a shape error there.
"""
from __future__ import annotations

import math
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .graph import INVALID, LayeredGraph, assign_levels

Tensor = torch.Tensor

INF = float("inf")

# greedy-descent step cap per upper level (as in the reference)
GREEDY_MAX_STEPS = 64
# loop iterations between the host's reads of a loop's condition
BEAM_STEPS = 8
GREEDY_STEPS = 4


class IncrementalState(NamedTuple):
    # per level: (n + 1, cap_l) global ids; row n is the spare row
    neighbors: Tuple[Tensor, ...]
    # per level: (n + 1,) valid-entry counts
    counts: Tuple[Tensor, ...]
    entry: int
    entry_level: int


def new_state(n: int, caps: Tuple[int, ...], entry_level: int,
              device) -> IncrementalState:
    """The empty graph of ``n`` nodes: every list -1, entry node 0."""
    return IncrementalState(
        neighbors=tuple(torch.full((n + 1, c), INVALID, dtype=torch.int32,
                                   device=device) for c in caps),
        counts=tuple(torch.zeros((n + 1,), dtype=torch.int32, device=device)
                     for _ in caps),
        entry=0, entry_level=int(entry_level))


def _dists_to(x: Tensor, ids: Tensor, xq: Tensor) -> Tensor:
    """Squared L2 from ``xq`` (d,) to the rows ``ids`` name; +inf for -1."""
    safe = ids.clamp(0, x.shape[0] - 1).long()
    d = ((x[safe] - xq) ** 2).sum(dim=-1)
    return torch.where(ids >= 0, d, INF)


class _Beam:
    """The construction-time beam search over one level's table ``nb``
    (metadata-agnostic truncated lookups: first ``m_trunc`` entries),
    its state held in place so that one insert after another reuses it.

    ``_step`` is one iteration of the reference's loop, guarded by the
    loop's condition: an iteration that runs after the condition turned
    false changes nothing, so its body needs no other guard (an expanded
    id is always valid while the loop is active).  The host reads the
    condition once every :data:`BEAM_STEPS` iterations.  On a CUDA
    device those iterations are one CUDA graph, captured once per level
    table, so a replay costs one launch instead of ~40 eager ops each."""

    def __init__(self, nb: Tensor, x: Tensor, ef: int, m_trunc: int):
        n, d = x.shape
        dev = x.device
        self.nb, self.x, self.ef, self.m_trunc = nb, x, ef, m_trunc
        self.bi = torch.empty((ef,), dtype=torch.int64, device=dev)
        self.bd = torch.empty((ef,), dtype=x.dtype, device=dev)
        self.be = torch.empty((ef,), dtype=torch.bool, device=dev)
        self.visited = torch.empty((n,), dtype=torch.bool, device=dev)
        self.it = torch.empty((), dtype=torch.int32, device=dev)
        self.xq = torch.empty((d,), dtype=x.dtype, device=dev)
        self.anchor = torch.empty((1,), dtype=torch.int64, device=dev)
        self.active = torch.empty((), dtype=torch.bool, device=dev)
        self.no_new = torch.zeros((m_trunc,), dtype=torch.bool, device=dev)
        self.true = torch.ones((), dtype=torch.bool, device=dev)
        self.graph = None
        if dev.type == "cuda":
            # warm up on a side stream (from a dummy start), then capture
            self.start(x[0], torch.zeros((1,), dtype=torch.int64, device=dev))
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._steps()
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self._steps()

    def _cond(self) -> Tuple[Tensor, Tensor]:
        valid = self.bi >= 0
        unexp = valid & ~self.be
        unexp_d = torch.where(unexp, self.bd, INF)
        worst = torch.where(valid.all(), self.bd.amax(), INF)
        active = (unexp.any() & (unexp_d.amin() <= worst)
                  & (self.it < 4 * self.ef))
        return active, unexp_d

    def _step(self) -> None:
        n = self.x.shape[0]
        active, unexp_d = self._cond()
        sel = torch.argmin(unexp_d).reshape(1)
        c = self.bi.gather(0, sel).clamp(0, n - 1)
        row = self.nb.index_select(0, c)[0, :self.m_trunc].long()
        ok = row >= 0
        safe = row.clamp(0, n - 1)
        fresh = ok & ~self.visited[safe]
        nd = torch.where(fresh, ((self.x[safe] - self.xq) ** 2).sum(dim=-1),
                         INF)
        # visited[row] |= row >= 0; other entries rewrite the anchor,
        # which is already True
        self.visited.index_put_(
            (torch.where(ok & active, safe, self.anchor),), self.true)
        ai = torch.cat([self.bi, torch.where(fresh, row, INVALID)])
        ad = torch.cat([self.bd, nd])
        ae = torch.cat([self.be.scatter(0, sel, True), self.no_new])
        order = torch.argsort(ad, stable=True)[:self.ef]
        self.bi.copy_(torch.where(active, ai[order], self.bi))
        self.bd.copy_(torch.where(active, ad[order], self.bd))
        self.be.copy_(torch.where(active, ae[order], self.be))
        self.it += active

    def _steps(self) -> None:
        for _ in range(BEAM_STEPS):
            self._step()
        self.active.copy_(self._cond()[0])

    def start(self, xq: Tensor, entry: Tensor) -> None:
        """Reset the search to ``entry`` (a (1,) id) for the query ``xq``."""
        n = self.x.shape[0]
        self.xq.copy_(xq)
        self.anchor.copy_(entry.clamp(0, n - 1))
        self.bi.fill_(INVALID)
        self.bi[:1].copy_(entry)
        self.bd.fill_(INF)
        self.bd[:1].copy_(_dists_to(self.x, entry, xq))
        self.be.zero_()
        self.visited.zero_()
        self.visited.index_put_((self.anchor,), self.true)
        self.it.zero_()
        self.active.copy_(self._cond()[0])

    def search(self, xq: Tensor, entry: Tensor) -> Tuple[Tensor, Tensor]:
        """The sorted beam from ``entry`` (a (1,) id): ids (ef,) int64,
        dists (ef,)."""
        self.start(xq, entry)
        while bool(self.active):
            if self.graph is not None:
                self.graph.replay()
            else:
                self._steps()
        return self.bi.clone(), self.bd.clone()


def _greedy(nb: Tensor, x: Tensor, xq: Tensor, e: Tensor,
            m_trunc: int) -> Tensor:
    """ef = 1 greedy descent at one upper level from ``e`` (a (1,) id);
    returns the landing id, (1,)."""
    ed = _dists_to(x, e, xq)
    moved = torch.ones((1,), dtype=torch.bool, device=x.device)
    it = torch.zeros((1,), dtype=torch.int32, device=x.device)
    step = 0
    while True:
        active = moved & (it < GREEDY_MAX_STEPS)
        if step % GREEDY_STEPS == 0 and not bool(active):
            break
        step += 1
        row = nb.index_select(0, e.clamp(0, x.shape[0] - 1))[0, :m_trunc]
        d = _dists_to(x, row, xq)
        j = torch.argmin(d).reshape(1)
        dj = d.gather(0, j)
        better = dj < ed
        e = torch.where(active & better, row.gather(0, j).long(), e)
        ed = torch.where(active & better, dj, ed)
        moved = torch.where(active, better, moved)
        it += active
    return e


def _connect(nb: Tensor, cnt: Tensor, x: Tensor, v: int, cand: Tensor,
             cap: int) -> None:
    """v -> candidates (v's list: ``cand``, (cap,) with -1 padding) and
    candidates -> v (reverse edges, evicting the farthest neighbor when a
    list is full), in place."""
    n = x.shape[0]
    xq = x[v]
    nb[v] = cand
    cnt[v] = (cand >= 0).sum().to(torch.int32)
    # every candidate at once: distinct ids, so no update reads another's
    # row; absent candidates write the spare row n
    u = cand
    ok = u >= 0
    us = u.clamp(0, n - 1).long()
    tgt = torch.where(ok, us, n)
    rows = nb[us]                                   # (C, cap)
    c_u = cnt[us]
    has_space = c_u < cap
    slot_app = c_u.clamp(max=cap - 1).long()
    d_row = torch.where(rows >= 0,
                        ((x[rows.clamp(0, n - 1).long()]
                          - x[us][:, None, :]) ** 2).sum(dim=-1), INF)
    far = torch.argmax(torch.where(rows >= 0, d_row, -INF), dim=1)
    d_new = ((x[us] - xq) ** 2).sum(dim=-1)
    evict_ok = d_new < torch.gather(d_row, 1, far[:, None])[:, 0]
    slot = torch.where(has_space, slot_app, far)
    write = ok & (has_space | evict_ok)
    old = torch.gather(rows, 1, slot[:, None])[:, 0]
    rows.scatter_(1, slot[:, None],
                  torch.where(write, v, old).to(torch.int32)[:, None])
    nb[tgt] = rows
    cnt[tgt] = torch.where(write & has_space, c_u + 1, c_u)


def insert(state: IncrementalState, x: Tensor, v: int, lv: int,
           caps: Tuple[int, ...], m_trunc: int, ef_build: int,
           beams: Optional[Dict[int, _Beam]] = None) -> IncrementalState:
    """Insert node v with level lv; updates the tables in place and
    returns the state with its new entry point.  ``beams`` keeps each
    level's beam search (and its CUDA graph) from one insert to the
    next; without it each insert makes its own."""
    xq = x[v]
    e = torch.tensor([state.entry], dtype=torch.int64, device=x.device)
    # phase 1: greedy descent through the levels above lv
    for lvl in range(state.entry_level, lv, -1):
        e = _greedy(state.neighbors[lvl], x, xq, e, m_trunc)
    # phase 2: per level <= lv, beam search + connect
    for lvl in range(min(lv, state.entry_level), -1, -1):
        beam = None if beams is None else beams.get(lvl)
        if beam is None:
            beam = _Beam(state.neighbors[lvl], x, ef_build, m_trunc)
            if beams is not None:
                beams[lvl] = beam
        bi, _ = beam.search(xq, e)
        cap = caps[lvl]
        cand = bi[:cap]
        if cand.shape[0] < cap:
            cand = torch.nn.functional.pad(cand, (0, cap - cand.shape[0]),
                                           value=INVALID)
        _connect(state.neighbors[lvl], state.counts[lvl], x, v, cand, cap)
        e = torch.where(bi[:1] >= 0, bi[:1], e)
    if lv > state.entry_level:
        return state._replace(entry=v, entry_level=lv)
    return state


def variant_params(variant: str, M: int, gamma: int, efc: int,
                   n_levels: int) -> Tuple[Tuple[int, ...], int]:
    """(per-level caps, beam width ef_build) of a variant."""
    if variant == "hnsw":
        return tuple((2 * M if lvl == 0 else M)
                     for lvl in range(n_levels)), efc
    if variant == "acorn-1":
        gamma = 1
        caps = tuple((2 * M if lvl == 0 else M) for lvl in range(n_levels))
    elif variant == "acorn-gamma":
        caps = tuple(M * gamma for _ in range(n_levels))
    else:
        raise ValueError(f"variant {variant!r}")
    return caps, max(efc, M) * gamma


def to_graph(state: IncrementalState, levels: np.ndarray) -> LayeredGraph:
    """The built state as a :class:`LayeredGraph` (each level keeps its
    members' rows)."""
    dev = state.neighbors[0].device
    n = len(levels)
    lv = torch.from_numpy(np.asarray(levels, dtype=np.int32))
    neighbors, pos, node_ids = [], [], []
    for lvl, nb in enumerate(state.neighbors):
        members = torch.nonzero(lv >= lvl)[:, 0].to(dev)
        neighbors.append(nb[members])
        p = torch.full((n,), INVALID, dtype=torch.int32, device=dev)
        p[members] = torch.arange(members.shape[0], dtype=torch.int32,
                                  device=dev)
        pos.append(p)
        node_ids.append(members.to(torch.int32))
    return LayeredGraph(
        neighbors=tuple(neighbors), pos=tuple(pos), node_ids=tuple(node_ids),
        entry_point=torch.tensor(state.entry, dtype=torch.int32, device=dev),
        levels=lv.to(dev))


def build_incremental(
    x: Tensor,
    generator: Optional[torch.Generator],
    M: int,
    variant: str = "acorn-gamma",
    gamma: int = 1,
    m_beta: Optional[int] = None,
    efc: int = 40,
    max_level: Optional[int] = None,
    levels: Optional[np.ndarray] = None,
) -> Tuple[LayeredGraph, float]:
    """Sequential-insert build on ``x``'s device.  Returns (graph,
    seconds of the insert loop).

    ACORN-γ: beam width max(efc, M)·γ (candidate collection cost scales
    with γ, the paper's TTI analysis §6.2), keeps M·γ candidates.
    ACORN-1: γ = 1.  HNSW: keeps M (2M at level 0) of efc.  ``m_beta``
    is accepted for the reference's signature and unused, as there.
    ``levels`` (n,) fixes the level assignment (the reference's own draw,
    for parity); otherwise ``generator`` draws it."""
    n = x.shape[0]
    if max_level is None:
        max_level = max(1, int(math.log(max(n, 2)) / math.log(M)))
    lv = assign_levels(generator, n, M, max_level=max_level,
                       levels=levels).numpy()
    n_levels = int(lv.max()) + 1
    caps, ef_build = variant_params(variant, M, gamma, efc, n_levels)
    state = new_state(n, caps, int(lv[0]), x.device)
    cuda = x.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    beams: Dict[int, _Beam] = {}
    for v in range(n):
        state = insert(state, x, v, int(lv[v]), caps, M, ef_build, beams)
    if cuda:
        torch.cuda.synchronize(x.device)
    seconds = time.perf_counter() - t0
    return to_graph(state, lv), seconds
