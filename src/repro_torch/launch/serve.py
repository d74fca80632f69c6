"""Serving launcher CLI: build a sharded ACORN deployment over a synthetic
corpus and drive it either closed-loop (the legacy batch sweep) or
open-loop through the continuous-batching :class:`ServingRuntime` with a
seeded Poisson arrival process.

  # closed-loop (one big serve() call)
  PYTHONPATH=src python -m repro_torch.launch.serve --n 8000 --shards 4 \
      --queries 128 [--workload contains|between|equals] [--fail-shard 1]

  # open-loop: Poisson arrivals at --rate requests/s through the runtime
  PYTHONPATH=src python -m repro_torch.launch.serve --mode open --rate 200 \
      --queries 256 --slo-budget 0.2 --ef-ladder 32,64,96

Everything runs on ``--device`` (default ``cuda``; it raises without a
card, so pass ``--device cpu`` for the plain PyTorch path).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

import torch

from repro_torch.core import AcornConfig, SearchRequest, recall_at_k
from repro_torch.data import make_hcps_dataset, make_lcps_dataset, make_workload
from repro_torch.serve import (EngineConfig, RuntimeConfig, ServingEngine,
                               ServingRuntime)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_engine(args, ds):
    t0 = time.perf_counter()
    engine = ServingEngine(
        ds.x, ds.table,
        AcornConfig(M=args.M, gamma=args.gamma, m_beta=2 * args.M,
                    ef_search=96),
        EngineConfig(batch_size=args.batch, k=10, n_shards=args.shards,
                     duplicate_dispatch=args.fail_shard is not None),
        device=args.device)
    _sync(engine.device)
    print(f"built {args.shards} shards over n={args.n} in "
          f"{time.perf_counter() - t0:.1f}s")
    if args.fail_shard is not None:
        engine.fail_shard(args.fail_shard)
        print(f"shard {args.fail_shard} marked failed "
              f"(duplicate dispatch active)")
    return engine


def run_closed(args, engine, ds, wl):
    t0 = time.perf_counter()
    res = engine.serve(wl.xq, wl.predicates)
    _sync(engine.device)
    dt = time.perf_counter() - t0
    print(f"served {args.queries} hybrid queries in {dt:.2f}s "
          f"({args.queries / dt:.1f} QPS) | recall@10 = "
          f"{recall_at_k(res.ids, wl.gt(ds)):.3f}")
    print("stats:", engine.stats)


def run_open(args, engine, ds, wl):
    """Seeded Poisson open loop: requests of --request-size queries arrive
    at --rate req/s and flow through the continuous-batching runtime."""
    cfg = RuntimeConfig(
        max_queue=args.max_queue,
        coalesce_deadline=args.coalesce_deadline,
        slo_budget=args.slo_budget,
        ef_ladder=tuple(int(e) for e in args.ef_ladder.split(","))
        if args.ef_ladder else ())
    rng = np.random.default_rng(args.seed)
    size = args.request_size
    starts = list(range(0, args.queries, size))
    gaps = rng.exponential(1.0 / args.rate, size=len(starts))
    # compile once: per-request programs row-slice the shared plan
    program = engine.compile(list(wl.predicates))

    arrivals = np.cumsum(gaps)
    tickets = []
    t0 = time.perf_counter()
    with ServingRuntime(engine, cfg) as rt:
        for s, ta in zip(starts, arrivals):
            # absolute schedule (avoids coordinated omission): requests
            # behind schedule submit immediately instead of re-sleeping
            dt = t0 + float(ta) - time.perf_counter()
            if dt > 0:
                time.sleep(dt)
            e = min(s + size, args.queries)
            tickets.append(rt.submit(SearchRequest(
                xq=wl.xq[s:e], predicates=program.take(np.arange(s, e)),
                k=10)))
        results = [t.result(timeout=600) for t in tickets]
    dt = time.perf_counter() - t0
    st = rt.stats()

    served = ~np.concatenate([np.asarray(r.shed) for r in results])
    ids = torch.cat([r.ids for r in results]).cpu()
    sel = torch.as_tensor(np.nonzero(served)[0])
    rec = (recall_at_k(ids[sel], wl.gt(ds).cpu()[sel])
           if served.any() else float("nan"))
    print(f"open loop: {args.queries} queries at {args.rate} req/s in "
          f"{dt:.2f}s | sustained {st.qps:.1f} QPS | recall@10 (served) "
          f"= {rec:.3f}")
    print(f"latency p50/p99 = {st.latency_p50 * 1e3:.1f}/"
          f"{st.latency_p99 * 1e3:.1f} ms | shed {st.shed}/"
          f"{args.queries} | dispatches {st.dispatches} | "
          f"batch sizes {dict(sorted(st.batch_hist.items()))}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--queries", type=int, default=128)
    ap.add_argument("--workload", default="contains",
                    choices=["contains", "between", "equals"])
    ap.add_argument("--gamma", type=int, default=12)
    ap.add_argument("--M", type=int, default=16)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--fail-shard", type=int, default=None)
    ap.add_argument("--mode", default="closed", choices=["closed", "open"])
    # open-loop knobs
    ap.add_argument("--rate", type=float, default=100.0,
                    help="Poisson arrival rate, requests/s")
    ap.add_argument("--request-size", type=int, default=4,
                    help="queries per request")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-queue", type=int, default=1024)
    ap.add_argument("--coalesce-deadline", type=float, default=0.01)
    ap.add_argument("--slo-budget", type=float, default=None)
    ap.add_argument("--ef-ladder", default="",
                    help="comma-separated ef ladder for SLO routing")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the corpus, shards and queries")
    args = ap.parse_args(argv)

    if args.workload == "equals":
        ds = make_lcps_dataset(n=args.n, d=args.d, seed=0,
                               device=args.device)
    else:
        ds = make_hcps_dataset(n=args.n, d=args.d, seed=0,
                               device=args.device)
    wl = make_workload(ds, kind=args.workload, n_queries=args.queries,
                       k=10, seed=1)
    engine = build_engine(args, ds)
    if args.mode == "closed":
        run_closed(args, engine, ds, wl)
    else:
        run_open(args, engine, ds, wl)


if __name__ == "__main__":
    main()
