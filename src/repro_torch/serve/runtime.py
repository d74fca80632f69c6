"""Async serving runtime: continuous batching over SearchRequest streams.

The engine (``repro_torch.serve.engine``) is a synchronous library call;
live traffic is a *stream* of small
:class:`repro_torch.core.plan.SearchRequest`\\ s
arriving open-loop.  :class:`ServingRuntime` sits between the two — the
LLM-serving-style continuous-batching layer, built from the same pieces
the closed-loop path already uses:

  * **admission queue + coalescing** — requests group by
    :func:`repro_torch.core.plan.admission_key` (program ``shape_sig`` +
    regex-leaf set + schema + k/ef/route), so mixed predicate arities
    land in separate groups and a coalesced batch concatenates
    (:meth:`PredicateProgram.concat`) into a program of one shape.  A
    group dispatches when it can fill the largest batch bucket
    (:func:`repro_torch.core.batched.coalesce_take`) or
    when its oldest request has waited ``coalesce_deadline`` seconds,
    whichever comes first;

  * **deterministic admission order** — every request gets a monotonic
    sequence number at submit; queue order is ``(arrival, seq)``, so
    equal arrival timestamps (coarse clocks, replayed traces) tie-break
    reproducibly and a replayed trace coalesces into bit-identical
    batches (the dispatch log records the composition);

  * **SLO-aware routing** — a per-request deadline (explicit or
    ``slo_budget`` from config) picks ``ef`` from ``ef_ladder`` via a
    live EWMA latency model (updated per dispatch, keyed per
    ``(bucket, ef, route)`` variant); when even the floor of the ladder
    is predicted to blow the budget and the corpus sketches say the
    predicate is selective (below the engine's ``s_min``), the request
    is routed to the exact pre-filter path outright;

  * **backpressure** — queue depth is bounded (``max_queue`` queries);
    requests beyond it are *shed*: they immediately resolve to the same
    -1/inf sentinel the engine's all-shards-down degrade path returns
    (:func:`repro_torch.core.plan.sentinel_result`), with ``shed=True`` flags
    — overload answers in-band, never with an exception;

  * **metrics** — :meth:`ServingRuntime.stats` snapshots per-bucket
    p50/p99 latency + QPS, queue depth, shed/degraded counts, the
    coalesced-batch-size histogram, and the latency model.

Single consumer: dispatches run on one thread (the caller's, via
:meth:`step`/:meth:`pump`, or the worker started by :meth:`start`) — the
kernels' launch counters and the variant caches are updated without a
lock, and one dispatch stream is exactly the one-entry-per-(bucket, spec)
steady state the variant caches promise.  The worker launches on its
current CUDA stream, which the kernels read.

Queries stay on the engine's device: a coalesced batch is concatenated
and padded there, and a dispatch's clock stops once its ids are on the
host, so the latency model and percentiles time the work, not the launch.
"""
from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.batched import bucket_for, coalesce_take, mesh_buckets
from repro_torch.core.plan import (PredicateProgram, SearchRequest,
                                   SearchResult, admission_key,
                                   sentinel_result)

from .engine import ServingEngine


@dataclass(frozen=True)
class RuntimeConfig:
    """Knobs of the continuous-batching runtime.

    ``max_queue``          — bound on queued *queries* (not requests);
                             admissions beyond it shed;
    ``coalesce_deadline``  — seconds a request may wait for batchmates
                             before its group dispatches partial;
    ``slo_budget``         — default per-request latency target (s);
                             ``None`` = no SLO routing unless a submit
                             passes an explicit deadline;
    ``ef_ladder``          — candidate ``ef`` values for SLO routing
                             (empty = always the engine default);
    ``latency_alpha``      — EWMA smoothing for the latency model;
    ``window``             — ring-buffer size for percentile metrics;
    ``dispatch_log_max``   — retained dispatch compositions (replay /
                             determinism audits).
    """

    max_queue: int = 1024
    coalesce_deadline: float = 0.01
    slo_budget: Optional[float] = None
    ef_ladder: Tuple[int, ...] = ()
    latency_alpha: float = 0.2
    window: int = 4096
    dispatch_log_max: int = 4096


@dataclass(frozen=True)
class RuntimeStats:
    """A point-in-time snapshot of the runtime's counters + metrics."""

    submitted: int
    completed: int
    shed: int
    degraded: int
    dispatches: int
    queue_depth: int          # requests waiting
    queued_queries: int       # queries waiting (the max_queue unit)
    qps: float                # completed queries / observed span
    latency_p50: float        # seconds, over the metrics window
    latency_p99: float
    per_bucket: Dict[int, Dict[str, float]]   # bucket -> count/p50/p99/qps
    batch_hist: Dict[int, int]                # coalesced batch size -> count
    latency_model: Dict[tuple, float]         # (bucket, ef, route) -> EWMA s


class Ticket:
    """Handle for one submitted request; resolves to a SearchResult."""

    __slots__ = ("seq", "_event", "_result")

    def __init__(self, seq: int):
        self.seq = seq
        self._event = threading.Event()
        self._result: Optional[SearchResult] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> SearchResult:
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.seq} still in flight")
        return self._result

    def _resolve(self, result: SearchResult) -> None:
        self._result = result
        self._event.set()


@dataclass
class _Pending:
    seq: int
    arrival: float
    xq: Any
    program: PredicateProgram
    n: int
    ef: int
    route: Optional[str]
    ticket: Ticket

    @property
    def order(self) -> Tuple[float, int]:
        return (self.arrival, self.seq)


class ServingRuntime:
    """Continuous batching over an engine: admission, coalescing, SLO
    routing, backpressure, metrics.  See the module docstring."""

    def __init__(self, engine: ServingEngine,
                 cfg: Optional[RuntimeConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.engine = engine
        self.cfg = cfg or RuntimeConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # admission groups: key -> pending entries sorted by (arrival, seq)
        self._groups: Dict[tuple, List[_Pending]] = {}
        self._queued_queries = 0
        self._next_seq = 0
        self._buckets = mesh_buckets(engine.acorn.buckets, 1)
        # metrics state
        self._submitted = 0
        self._completed = 0
        self._shed = 0
        self._degraded = 0
        self._dispatches = 0
        self._first_submit: Optional[float] = None
        self._last_complete: Optional[float] = None
        self._latencies: deque = deque(maxlen=self.cfg.window)
        self._bucket_lat: Dict[int, deque] = {}
        self._bucket_count: Dict[int, int] = {}
        self._batch_hist: Dict[int, int] = {}
        self._ewma: Dict[tuple, float] = {}       # (bucket, ef, route)
        self._ewma_er: Dict[tuple, float] = {}    # (ef, route) aggregate
        self.dispatch_log: List[Tuple[int, ...]] = []
        # worker thread
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def submit(self, request: SearchRequest,
               deadline: Optional[float] = None) -> Ticket:
        """Admit one request; returns a :class:`Ticket`.

        ``request.predicates`` may be trees (compiled here against the
        engine schema) or a pre-compiled program.  ``deadline`` is an
        absolute clock value (same clock as the runtime's); ``None``
        derives one from ``cfg.slo_budget`` when set.  Over-queue
        admissions resolve immediately to the shed sentinel — submit
        never raises for load reasons.
        """
        cfg = self.cfg
        xq = torch.as_tensor(request.xq).to(self.engine.device,
                                            dtype=torch.float32)
        n = int(xq.shape[0])
        k = request.k if request.k is not None else self.engine.cfg.k
        preds = request.predicates
        program = (preds if isinstance(preds, PredicateProgram)
                   else self.engine.compile(preds))
        if program.n_queries != n:
            raise ValueError(f"{n} queries but {program.n_queries} "
                             "predicates")
        now = self._clock()
        if deadline is None and cfg.slo_budget is not None:
            deadline = now + cfg.slo_budget
        ef, route = self._choose_ef_route(program, request.ef,
                                          request.route, deadline, now)
        with self._cond:
            self._submitted += 1
            if self._first_submit is None:
                self._first_submit = now
            seq = self._next_seq
            self._next_seq += 1
            ticket = Ticket(seq)
            if self._queued_queries + n > cfg.max_queue:
                self._shed += n
                ticket._resolve(sentinel_result(
                    n, k, shed=True, device=self.engine.device))
                return ticket
            entry = _Pending(seq=seq, arrival=now, xq=xq, program=program,
                             n=n, ef=ef, route=route, ticket=ticket)
            key = admission_key(program, k, ef, route)
            group = self._groups.setdefault(key, [])
            # (arrival, seq) insertion order: ties on arrival break on the
            # monotonic seq, so replayed traces coalesce identically
            bisect.insort(group, entry, key=lambda e: e.order)
            self._queued_queries += n
            self._cond.notify()
        return ticket

    # ------------------------------------------------------------------
    # SLO-aware ef / route selection
    # ------------------------------------------------------------------
    def _choose_ef_route(self, program: PredicateProgram,
                         ef: Optional[int], route: Optional[str],
                         deadline: Optional[float],
                         now: float) -> Tuple[int, Optional[str]]:
        eng = self.engine
        default_ef = eng.cfg.ef or eng.acorn.ef_search
        ladder = tuple(sorted(set(self.cfg.ef_ladder))) or (default_ef,)
        if ef is not None:
            return int(ef), route        # caller pinned it
        if deadline is None:
            return max(ladder), route    # no SLO: best quality
        remaining = (deadline - now) - self.cfg.coalesce_deadline
        chosen = None
        for cand in sorted(ladder, reverse=True):
            pred = self._predict(cand, route)
            if pred is None or pred <= remaining:
                chosen = cand            # unknown latency: optimistic
                break
        if chosen is not None:
            return int(chosen), route
        # even the ladder floor is predicted to blow the budget: fall to
        # the floor, and if the sketches say the predicate is selective
        # enough for the exact path, force the pre-filter route (§5.2's
        # cheap regime) rather than a doomed graph traversal
        chosen = min(ladder)
        if route is None:
            s_est = float(np.mean(self.estimate_selectivity(program)))
            if s_est < eng.acorn.s_min:
                route = "prefilter"
        return int(chosen), route

    def estimate_selectivity(self, program: PredicateProgram) -> np.ndarray:
        """(B,) mean selectivity estimate across the engine's shard
        sketches (size-weighted) — the routing signal exposed for SLO
        decisions without touching real masks."""
        ests, weights = [], []
        for shard in self.engine.shards:
            ests.append(np.asarray(
                shard.index.sketch.estimate_batch(program), np.float64))
            weights.append(shard.index.x.shape[0])
        w = np.asarray(weights, np.float64)
        return (np.stack(ests) * w[:, None]).sum(axis=0) / w.sum()

    def _predict(self, ef: int, route: Optional[str]) -> Optional[float]:
        """Predicted batch latency (s) for (ef, route), from the EWMA
        aggregate; None until that variant has been observed."""
        return self._ewma_er.get((ef, route))

    # ------------------------------------------------------------------
    # the dispatch loop
    # ------------------------------------------------------------------
    def step(self, now: Optional[float] = None) -> int:
        """Dispatch every currently-due group; returns completed requests.

        Deterministic given queue state: due groups dispatch in order of
        their oldest entry's ``(arrival, seq)``; each dispatch drains the
        group FIFO up to the largest batch bucket.  Tests drive this
        directly with a manual clock; the worker thread calls it in a
        loop.
        """
        done = 0
        while True:
            batch = self._take_batch(self._clock() if now is None else now)
            if batch is None:
                return done
            done += self._dispatch(*batch)

    def pump(self) -> int:
        """Drain everything queued right now, coalesce deadlines
        notwithstanding — the synchronous flush used by tests and the
        closed-loop launcher.  Returns completed requests."""
        return self.step(now=float("inf"))

    def _take_batch(self, now: float):
        cfg = self.cfg
        cap = coalesce_take(10 ** 9, self._buckets)  # largest batch bucket
        with self._lock:
            best_key, best_order = None, None
            for key, group in self._groups.items():
                if not group:
                    continue
                head = group[0]
                full = sum(e.n for e in group) >= cap
                due = full or (now - head.arrival >= cfg.coalesce_deadline)
                if due and (best_order is None or head.order < best_order):
                    best_key, best_order = key, head.order
            if best_key is None:
                return None
            group = self._groups[best_key]
            taken, total = [], 0
            while group and (not taken or total + group[0].n <= cap):
                e = group.pop(0)
                taken.append(e)
                total += e.n
            self._queued_queries -= total
            if not group:
                del self._groups[best_key]
        return best_key, taken

    def _dispatch(self, key: tuple, entries: List[_Pending]) -> int:
        k, ef, route = key[-3], key[-2], key[-1]
        total = sum(e.n for e in entries)
        xq = (entries[0].xq if len(entries) == 1
              else torch.cat([e.xq for e in entries]))
        program = PredicateProgram.concat([e.program for e in entries])
        # pad the coalesced batch to its batch bucket so every dispatch is
        # a bucket-exact shape, as in the reference (pad rows replay
        # query/program row 0 and are sliced off below)
        bucket = bucket_for(total, self._buckets)
        if bucket > total:
            pad = bucket - total
            xq = torch.cat([xq, xq[:1].expand((pad,) + tuple(xq.shape[1:]))])
            program = PredicateProgram.concat(
                [program, program.take(np.zeros(pad, np.int32))])
        t0 = time.perf_counter()
        res = self.engine.search_batch(
            SearchRequest(xq=xq, predicates=program, k=k, ef=ef,
                          route=route))
        res.ids.cpu()  # the ids on the host before stopping the clock
        dt = time.perf_counter() - t0
        now = self._clock()
        alpha = self.cfg.latency_alpha

        def _fold(d: Dict[tuple, float], mk: tuple):
            prev = d.get(mk)
            d[mk] = dt if prev is None else (1 - alpha) * prev + alpha * dt

        with self._lock:
            self._dispatches += 1
            self._batch_hist[total] = self._batch_hist.get(total, 0) + 1
            _fold(self._ewma, (bucket, ef, route))
            _fold(self._ewma_er, (ef, route))
            self.dispatch_log.append(tuple(e.seq for e in entries))
            if len(self.dispatch_log) > self.cfg.dispatch_log_max:
                del self.dispatch_log[:-self.cfg.dispatch_log_max]
            blat = self._bucket_lat.setdefault(
                bucket, deque(maxlen=self.cfg.window))
            self._bucket_count[bucket] = (self._bucket_count.get(bucket, 0)
                                          + total)
            degraded = bool(np.asarray(res.degraded).any()
                            if res.degraded is not None else False)
            off = 0
            for e in entries:
                sub = (res if len(entries) == 1 and res.n_queries == e.n
                       else res.take(np.s_[off:off + e.n]))
                off += e.n
                lat = now - e.arrival
                self._latencies.append(lat)
                blat.append(lat)
                self._completed += e.n
                if degraded:
                    self._degraded += e.n
                self._last_complete = now
                e.ticket._resolve(sub)
        return len(entries)

    # ------------------------------------------------------------------
    # worker thread (open-loop serving)
    # ------------------------------------------------------------------
    def start(self) -> "ServingRuntime":
        if self._thread is not None:
            raise RuntimeError("runtime already started")
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serving-runtime")
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the worker.  ``drain=True`` serves everything queued
        first; ``drain=False`` sheds the remainder (sentinels, never
        exceptions)."""
        if self._thread is None:
            return
        if not drain:
            with self._lock:
                leftovers = [e for g in self._groups.values() for e in g]
                self._groups.clear()
                self._queued_queries = 0
                self._shed += sum(e.n for e in leftovers)
            for e in sorted(leftovers, key=lambda e: e.order):
                e.ticket._resolve(sentinel_result(
                    e.n, self.engine.cfg.k, shed=True,
                    device=self.engine.device))
        self._stop_evt.set()
        with self._cond:
            self._cond.notify_all()
        self._thread.join()
        self._thread = None

    def __enter__(self) -> "ServingRuntime":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _time_to_due(self, now: float) -> Optional[float]:
        cap = coalesce_take(10 ** 9, self._buckets)
        soonest = None
        for group in self._groups.values():
            if not group:
                continue
            if sum(e.n for e in group) >= cap:
                return 0.0
            due = group[0].arrival + self.cfg.coalesce_deadline - now
            soonest = due if soonest is None else min(soonest, due)
        return soonest

    def _run(self) -> None:
        while not self._stop_evt.is_set():
            with self._cond:
                wait = self._time_to_due(self._clock())
                if wait is None or wait > 0:
                    self._cond.wait(timeout=0.05 if wait is None
                                    else min(wait, 0.05))
            self.step()
        # drain: stop(drain=False) already shed + cleared the groups, so
        # this pump is a no-op there; stop(drain=True) serves the rest
        # even when no coalesce deadline would come due soon
        self.pump()

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------
    @staticmethod
    def _pct(values, q: float) -> float:
        return float(np.percentile(np.asarray(values), q)) if values else 0.0

    def stats(self) -> RuntimeStats:
        """Snapshot the runtime's counters + latency metrics."""
        with self._lock:
            span = None
            if (self._first_submit is not None
                    and self._last_complete is not None):
                span = self._last_complete - self._first_submit
            qps = (self._completed / span if span and span > 0 else 0.0)
            per_bucket = {}
            for bucket, lat in self._bucket_lat.items():
                vals = list(lat)
                per_bucket[bucket] = dict(
                    count=float(self._bucket_count.get(bucket, 0)),
                    p50=self._pct(vals, 50), p99=self._pct(vals, 99),
                    qps=(self._bucket_count.get(bucket, 0) / span
                         if span and span > 0 else 0.0))
            return RuntimeStats(
                submitted=self._submitted, completed=self._completed,
                shed=self._shed, degraded=self._degraded,
                dispatches=self._dispatches,
                queue_depth=sum(len(g) for g in self._groups.values()),
                queued_queries=self._queued_queries, qps=qps,
                latency_p50=self._pct(list(self._latencies), 50),
                latency_p99=self._pct(list(self._latencies), 99),
                per_bucket=per_bucket, batch_hist=dict(self._batch_hist),
                latency_model=dict(self._ewma))
