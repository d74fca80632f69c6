"""One run of one cell: set-up, the measured window, the traced segments,
the check against the reference, and the result line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in ``chipbench/configs/``, its mix
in ``chipbench/traffic/``, its limits in ``chipbench/limits/`` and each
metric's reader in ``chipbench/metrics/``.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import resource
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from chipbench import judge, tracing
from chipbench.datagen import Corpus, make_corpus, seed_stream
from chipbench.reference import knn
from chipbench.reference.predicates import mask_over
from chipbench.traffic import SAMPLE, TRACE, WARMUP, WINDOW, Request, Traffic

BENCH_DIR = Path(__file__).resolve().parent
# top-level module names the run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# characters of a device op's name kept in the breakdown
NAME_CHARS = 200


class RunError(Exception):
    """A run that cannot give a result (exit code 2)."""


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, root: Path) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]

    def read(sub: str, stem: str) -> dict:
        return json.loads((BENCH_DIR / sub / f"{stem}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name=name, chips=int(w["chips"]),
                config=read("configs", w["config"]),
                mix=read("traffic", w["traffic"]),
                limits=read("limits", name),
                end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]))


def load_reader(metric: str) -> Callable:
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"chipbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# the program's side: its input types, built from the plain descriptions
# ---------------------------------------------------------------------------


def port_predicates(tree, b: int) -> list:
    """One ``repro_torch`` predicate tree a query, from the description."""
    from repro_torch.core.predicates import And, Between, ContainsAny, Equals
    kind = tree[0]
    if kind == "equals":
        return [Equals(tree[1], int(v)) for v in tree[2]]
    if kind == "between":
        return [Between(tree[1], int(lo), int(hi))
                for lo, hi in zip(tree[2], tree[3])]
    if kind == "contains_any":
        return [ContainsAny(tree[1], tuple(int(w) for w in row if w >= 0))
                for row in tree[2]]
    if kind == "and":
        parts = [port_predicates(c, b) for c in tree[1]]
        return [And(tuple(p[i] for p in parts)) for i in range(b)]
    raise ValueError(f"unknown predicate kind {kind!r}")


def build_index(cell: Cell, corpus: Corpus, dev: torch.device):
    from repro_torch.core import AcornConfig, AttributeTable, HybridIndex
    ix = cell.config["index"]
    table = AttributeTable(int_cols=dict(corpus.int_cols),
                           bitset_cols=dict(corpus.bitset_cols), str_cols={},
                           n_keywords=dict(corpus.n_keywords))
    cfg = AcornConfig(M=ix["M"], gamma=ix["gamma"], m_beta=ix["m_beta"],
                      ef_search=ix["ef_search"], variant=ix["variant"],
                      metric=ix["metric"], compress=ix["compress"])
    # one index a configuration, as its corpus (datagen.py)
    return HybridIndex.build(corpus.x, table, cfg, device=dev,
                             seed=cell.config["dataset"]["data_seed"])


@dataclass
class Served:
    """What the program returned for one request."""

    ids: torch.Tensor
    dists: torch.Tensor
    routes: np.ndarray
    dist_comps: np.ndarray
    seconds: float


def serve(index, traffic: Traffic, req: Request, search=None) -> Served:
    """One request through the program: compile the predicates, then
    search.  Its latency is read on the card's clock (CUDA events from
    before the compile to after the search's last operation, the stream
    idle before it), on a CPU by the host clock."""
    from repro_torch.core import SearchRequest
    preds = port_predicates(req.tree, traffic.batch)
    search = search or index.search
    dev = req.xq.device
    sync(dev)
    if dev.type == "cuda":
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
    t0 = time.perf_counter()
    program = index.compile(preds)
    res = search(SearchRequest(xq=req.xq, predicates=program, k=traffic.k,
                               ef=traffic.ef, route=traffic.route))
    if dev.type == "cuda":
        ev1.record()
        sync(dev)
        seconds = ev0.elapsed_time(ev1) * 1e-3
    else:
        seconds = time.perf_counter() - t0
    return Served(ids=res.ids, dists=res.dists,
                  routes=np.asarray(res.routes),
                  dist_comps=np.asarray(res.stats["dist_comps"]),
                  seconds=seconds)


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------


def reference_answer(corpus: Corpus, req: Request, k: int,
                     control: bool = False) -> knn.Answer:
    b = req.xq.shape[0]
    dev = corpus.x.device

    def mask_rows(s, e):
        def column(name):
            if name in corpus.int_cols:
                return corpus.int_cols[name][s:e]
            return corpus.bitset_cols[name][s:e]
        return mask_over(req.tree, column, b, e - s, dev)

    fn = knn.tf32_knn if control else knn.exact_knn
    return fn(req.xq, corpus.x, mask_rows, k)


def check_sample(completed: int, mix: dict, seed: int) -> List[int]:
    """The window's requests the check compares: ``check_requests`` drawn
    from the seed among the first half as many again (so a seed checks
    the same requests in every run that completes them)."""
    want = int(mix["check_requests"])
    pool = min(want + want // 2, completed)
    want = min(want, pool)
    rng = np.random.default_rng(seed_stream(seed, SAMPLE))
    return sorted(rng.choice(pool, size=want, replace=False).tolist())


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------


def _stat_cpu() -> List[int]:
    """The machine's CPU times (/proc/stat's "cpu" line), or []."""
    try:
        with open("/proc/stat") as f:
            return [int(v) for v in f.readline().split()[1:]]
    except (OSError, ValueError):
        return []


def host_counters(dev: torch.device) -> dict:
    """Counters read around the window: the process's CPU time and
    involuntary switches, the machine's CPU times, the collector's runs
    and the allocator's device allocations."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"cpu_s": time.process_time(), "nivcsw": ru.ru_nivcsw,
           "stat": _stat_cpu(),
           "gc": sum(s["collections"] for s in gc.get_stats())}
    if dev.type == "cuda":
        ms = torch.cuda.memory_stats(dev)
        out["mallocs"] = ms.get("segment.all.allocated", 0)
    return out


def host_share(a: dict, b: dict, seconds: float) -> dict:
    """What the host did between two ``host_counters`` readings: the
    process's CPU seconds over the window's, its involuntary switches,
    the machine's stolen share of CPU time, collector runs and device
    allocations."""
    cpu = (b["cpu_s"] - a["cpu_s"]) / max(seconds, 1e-9)
    out = {"cpu_share": round(cpu, 4), "nivcsw": b["nivcsw"] - a["nivcsw"],
           "gc_runs": b["gc"] - a["gc"]}
    if a["stat"] and b["stat"] and len(a["stat"]) > 7:
        d = [y - x for x, y in zip(a["stat"], b["stat"])]
        out["steal_share"] = round(d[7] / max(sum(d), 1), 4)
    if "mallocs" in a:
        out["mallocs"] = b["mallocs"] - a["mallocs"]
    return out


@dataclass
class Context:
    """What the metric readers read."""

    cell: Cell
    corpus_n: int
    corpus_d: int
    k: int
    setup_s: float = 0.0
    build_s: float = 0.0
    peak_bytes: int = 0
    latencies_s: List[float] = field(default_factory=list)
    window_s: float = 0.0
    queries: int = 0
    routes: np.ndarray = None
    dist_comps: np.ndarray = None
    recall: Optional[float] = None
    plain: Optional[tracing.Segment] = None
    stacked: Optional[tracing.Segment] = None
    # per traced request of the plain segment: (routes, dist_comps)
    plain_served: List[Served] = field(default_factory=list)
    # per traced request of the stacked segment: (routes, passing counts)
    stacked_served: List[tuple] = field(default_factory=list)
    # what the host did during the window, for standard error
    host: dict = field(default_factory=dict)


@dataclass
class Outcome:
    result: dict
    check_rows: list
    ctx: Context
    tally: judge.Tally

    def window_line(self) -> str:
        """What the window did, for standard error."""
        c = self.ctx
        lat = np.asarray(c.latencies_s or [0.0]) * 1e3
        graph = c.routes == "graph" if c.routes is not None else None
        dc = (float(np.mean(c.dist_comps[graph]))
              if graph is not None and graph.any() else 0.0)
        return (f"window: {len(c.latencies_s)} requests in {c.window_s:.3f} s;"
                f" latency ms min {lat.min():.3f} median {np.median(lat):.3f}"
                f" max {lat.max():.3f}; graph-routed dist_comps mean {dc:.1f};"
                f" set-up {c.setup_s:.3f} s (build {c.build_s:.3f} s);"
                f" checked {self.tally.requests} requests,"
                f" {self.tally.queries} queries; host "
                + " ".join(f"{k} {v}" for k, v in c.host.items()))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             dev: torch.device, t_start: float,
             search_wrapper: Optional[Callable] = None) -> Outcome:
    """One run.  ``search_wrapper(index) -> search``, where given, stands
    in for ``index.search`` (the tests break the timed path with it)."""
    cuda = dev.type == "cuda"
    if cuda:
        from repro_torch.kernels import loader
        loader.library()
        torch.empty(1, device=dev)  # the allocator exists once it has allocated
        torch.cuda.reset_peak_memory_stats(dev)
    corpus = make_corpus(cell.config["dataset"], dev)
    sync(dev)
    t0 = time.perf_counter()
    index = build_index(cell, corpus, dev)
    sync(dev)
    ctx = Context(cell=cell, corpus_n=corpus.n, corpus_d=corpus.d,
                  k=int(cell.mix["k"]))
    ctx.build_s = time.perf_counter() - t0
    traffic = Traffic(cell.mix, corpus, seed)
    search = search_wrapper(index) if search_wrapper else None
    for i in range(int(cell.mix["warmup_requests"])):
        serve(index, traffic, traffic.request(WARMUP, i), search)
    ctx.setup_s = time.perf_counter() - t_start

    # ---- the window: closed loop, requests back to back ----
    served: List[Optional[Served]] = []
    failed = 0
    h0 = host_counters(dev)
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        req = traffic.request(WINDOW, len(served))
        try:
            served.append(serve(index, traffic, req, search))
        except Exception:      # a request that fails counts, the run goes on
            print(traceback.format_exc(), file=sys.stderr)
            served.append(None)
            failed += 1
    ctx.window_s = time.perf_counter() - w0
    ctx.host = host_share(h0, host_counters(dev), ctx.window_s)
    done = [s for s in served if s is not None]
    ctx.latencies_s = [s.seconds for s in done]
    ctx.queries = traffic.batch * len(done)
    if done:
        ctx.routes = np.concatenate([s.routes for s in done])
        ctx.dist_comps = np.concatenate([s.dist_comps for s in done])

    if trace:
        n_tr = int(cell.mix["trace_requests"])
        plain_reqs = [traffic.request(TRACE, i) for i in range(n_tr)]
        stack_reqs = [traffic.request(TRACE, n_tr + i) for i in range(n_tr)]
        before = tracing.launch_counters()

        def plain():
            for r in plain_reqs:
                ctx.plain_served.append(serve(index, traffic, r, search))

        ctx.plain = tracing.run_segment(plain, stacks=False, cuda=cuda)
        after = tracing.launch_counters()
        ctx.plain.launches = {k: after[k] - before.get(k, 0) for k in after}
        stack_routes = []

        def stacked():
            for r in stack_reqs:
                stack_routes.append(serve(index, traffic, r, search).routes)

        ctx.stacked = tracing.run_segment(stacked, stacks=True, cuda=cuda)

    ctx.peak_bytes = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0

    # ---- the check, once the program's state is freed ----
    keep = {i: served[i] for i in check_sample(len(served), cell.mix, seed)}
    del index, search, served, done
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    tally = judge.Tally()
    for i, s in keep.items():
        req = traffic.request(WINDOW, i)
        if s is None:
            continue
        exact = reference_answer(corpus, req, ctx.k)
        judge.judge_request(tally, req.xq, req.tree, corpus, s.ids, s.dists,
                            s.routes, exact, ctx.k)
    ctx.recall = tally.recall
    if trace:
        for r, routes in zip(stack_reqs, stack_routes):
            ctx.stacked_served.append(
                (routes, reference_answer(corpus, r, ctx.k).passing.cpu()
                 .numpy()))
    correct, rows = judge.verdict(tally, cell.limits, failed)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": ctx.peak_bytes}
    result = {"correct": bool(correct),
              "attempted": traffic.batch * (len(ctx.latencies_s) + failed),
              "failed": traffic.batch * failed, "metrics": metrics,
              "device": device}
    if trace:
        device["busy_s"] = ctx.plain.busy_s
        device["window_s"] = ctx.plain.seconds
        names = ctx.plain.launches
        ops = []
        for name, sec in ctx.plain.device_ops():
            tags = [f"{k}.launches={v}" for k, v in names.items()
                    if v and k.removesuffix("_cuda") in name]
            short = name if len(name) <= NAME_CHARS else name[:NAME_CHARS] + "..."
            ops.append([short + (f" ({', '.join(tags)})" if tags else ""),
                        sec])
        result["breakdown"] = {"device_ops": ops,
                               "idle_gaps": [list(g) for g in
                                             ctx.stacked.idle_gaps()]}
    result["check"] = {name: {"value": v, "limit": lim}
                       for name, v, lim in rows}
    return Outcome(result=result, check_rows=rows, ctx=ctx, tally=tally)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out.strip().splitlines()[0]
