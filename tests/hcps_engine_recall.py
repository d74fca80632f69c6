"""Graph-route recall of the HCPS serving engine: the reference beside the
port, each building its own shards.

The reference's ``repro.serve.ServingEngine`` and the port's
``repro_torch.serve.ServingEngine`` are built independently over the same
``make_hcps_dataset`` corpus (each package draws its own graph levels),
with the serving launcher's configuration: 4 shards, ACORN-γ M = 16,
γ = 12, M_β = 32, ef_search = 96, batch 32, k = 10.  Both serve the
workloads of ``chip_smoke.py``'s engine phase (``--closed``
``contains`` queries, correlation none, seed 1; 64 each of ``between``,
``contains+between``, ``regex`` and ``contains`` pos / neg, seed 2) and
are scored against one exact ground truth (the reference's masked
brute force over the whole corpus).  Printed for each side and kind:

  * recall@10 of each route as the engine routes it (ef = 64, the
    engine's default);
  * recall@10 with every query forced onto the graph route, at each
    ``--efs`` value;
  * the share of the level-0 neighbor lists' edges that leave their
    row's generator cluster, and the rows a cluster holds in one shard;
  * for each kind, the mean count of distinct generator clusters among a
    query's exact top-10 (data alone: the same for both sides).

Everything runs on the CPU.  The corpus is the reference's generator at
``--n`` rows (``n // 256`` clusters of ~256 rows, as at any n):

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/hcps_engine_recall.py \\
        [--n 65536] [--d 512] [--closed 1024] [--efs 64,256]

The last line of the output is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

import repro.core as J
import repro.data as JD
import repro.serve as JS
import repro_torch.core as T
import repro_torch.data as TD
import repro_torch.serve as TS

M, GAMMA, M_BETA, EF_SEARCH = 16, 12, 32, 96
SHARDS, BATCH, K = 4, 32, 10
KINDS = (("contains", "none", 1, "closed"), ("between", "none", 2, "kind"),
         ("contains+between", "none", 2, "kind"), ("regex", "none", 2, "kind"),
         ("contains", "pos", 2, "kind"), ("contains", "neg", 2, "kind"))


def recall(ids, gt) -> float:
    return round(float(J.recall_at_k(np.asarray(ids), gt)), 4)


def route_recall(res, gt) -> dict:
    routes = np.asarray(res.routes)
    ids = np.asarray(res.ids)
    return {str(r): dict(queries=int((routes == r).sum()),
                         recall=recall(ids[routes == r], gt[routes == r]))
            for r in np.unique(routes)}


def gt_clusters(gt, cluster_of) -> float:
    """Mean count of distinct generator clusters among each query's
    valid exact top-k ids."""
    return round(float(np.mean([len(np.unique(cluster_of[g[g >= 0]]))
                                for g in gt])), 3)


def cross_cluster(engine, cluster_of) -> dict:
    """Share of level-0 edges whose two rows lie in different generator
    clusters, and the mean rows a cluster holds in one shard."""
    cross = total = 0
    per_shard = []
    for sh in engine.shards:
        g = sh.index.graph
        nbr = np.asarray(g.neighbors[0])
        rows = np.asarray(g.node_ids[0])
        valid = nbr >= 0
        c_row = cluster_of[sh.base + rows][:, None]
        c_nbr = cluster_of[sh.base + np.where(valid, nbr, 0)]
        cross += int(((c_row != c_nbr) & valid).sum())
        total += int(valid.sum())
        n_s = int(np.asarray(sh.index.x).shape[0])
        per_shard.append(n_s / len(np.unique(cluster_of[sh.base:sh.base
                                                         + n_s])))
    return dict(cross_share=round(cross / total, 4),
                edges_per_row=round(total / sum(
                    int(np.asarray(s.index.x).shape[0])
                    for s in engine.shards), 2),
                rows_per_cluster_in_a_shard=round(float(np.mean(per_shard)),
                                                  1))


def side(name, engine, wls, gts, efs, req_cls, cluster_of) -> dict:
    out = dict(graph=cross_cluster(engine, cluster_of), kinds={})
    for key, wl in wls.items():
        gt = gts[key]
        t0 = time.perf_counter()
        served = engine.serve(wl.xq, wl.predicates)
        forced = {}
        for ef in efs:
            r = engine.serve(req_cls(xq=wl.xq, predicates=wl.predicates, k=K,
                                     ef=ef, route="graph"))
            forced[str(ef)] = recall(r.ids, gt)
        out["kinds"][key] = dict(served=route_recall(served, gt),
                                 graph_forced=forced,
                                 seconds=round(time.perf_counter() - t0, 1))
        print(name, key, json.dumps(out["kinds"][key]), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 16)
    ap.add_argument("--d", type=int, default=512)
    ap.add_argument("--closed", type=int, default=1024)
    ap.add_argument("--kind-queries", type=int, default=64)
    ap.add_argument("--efs", default="64,256")
    args = ap.parse_args(argv)
    efs = [int(e) for e in args.efs.split(",")]
    torch.set_num_threads(4)

    jds = JD.make_hcps_dataset(n=args.n, d=args.d, seed=0)
    tds = TD.make_hcps_dataset(n=args.n, d=args.d, seed=0, device="cpu")
    assert np.array_equal(np.asarray(jds.x), tds.x.numpy())
    cluster_of = np.asarray(jds.cluster_of)
    jwls, twls, gts, sel, spread = {}, {}, {}, {}, {}
    for kind, cor, seed, which in KINDS:
        nq = args.closed if which == "closed" else args.kind_queries
        key = kind if cor == "none" else f"{kind}/{cor}"
        jwls[key] = JD.make_workload(jds, kind=kind, correlation=cor,
                                     n_queries=nq, k=K, seed=seed)
        twls[key] = TD.make_workload(tds, kind=kind, correlation=cor,
                                     n_queries=nq, k=K, seed=seed)
        assert np.array_equal(np.asarray(jwls[key].xq), twls[key].xq.numpy())
        gts[key] = np.asarray(jwls[key].gt(jds))
        sel[key] = round(float(jwls[key].avg_selectivity(jds)), 4)
        spread[key] = gt_clusters(gts[key], cluster_of)
    print("selectivity", json.dumps(sel), "gt_clusters", json.dumps(spread),
          flush=True)

    t0 = time.perf_counter()
    jeng = JS.ServingEngine(
        jds.x, jds.table,
        J.AcornConfig(M=M, gamma=GAMMA, m_beta=M_BETA, ef_search=EF_SEARCH),
        JS.EngineConfig(batch_size=BATCH, k=K, n_shards=SHARDS,
                        host_fallback=True))
    j_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    teng = TS.ServingEngine(
        tds.x, tds.table,
        T.AcornConfig(M=M, gamma=GAMMA, m_beta=M_BETA, ef_search=EF_SEARCH),
        TS.EngineConfig(batch_size=BATCH, k=K, n_shards=SHARDS),
        device="cpu")
    t_build = time.perf_counter() - t0
    print(f"built: reference {j_build:.1f} s, port {t_build:.1f} s",
          flush=True)

    out = dict(n=args.n, d=args.d, clusters=int(cluster_of.max()) + 1,
               shards=SHARDS, selectivity=sel, gt_clusters=spread,
               reference=side("reference", jeng, jwls, gts, efs,
                              J.SearchRequest, cluster_of),
               port=side("port", teng, twls, gts, efs, T.SearchRequest,
                         cluster_of))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
