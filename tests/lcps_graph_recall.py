"""Recall of the bulk-built baseline graphs on LCPS data: the reference
beside the port, on one level draw.

Two of ``chip_smoke.py``'s Figure 7 methods, at the baselines phase's
parameters (M = 32), over ``make_lcps_dataset(n, d=128, card=12,
seed=0)`` and its 64 ``equals`` queries (seed 1):

  * ``--method acorn-1``: ``build_acorn_1`` over all n rows, searched by
    ``hybrid_search`` (variant acorn-1, m = m_β = 32, max_expansions
    4·ef) under each query's predicate, scored against the exact masked
    top-10;
  * ``--method hnsw``: ``build_hnsw`` (efc 64) over the rows of label 0,
    the oracle's partition, searched unfiltered by ``ann_search``
    (m = 32), scored against the exact top-10 within the partition.

The reference builds its graph; the port builds its own with the
reference's levels.  Printed per side and ef: recall@10 and mean
dist_comps; then the share of the port's level-0 rows reachable from
the entry point along level-0 edges.  Everything runs on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/lcps_graph_recall.py \\
        --method acorn-1 [--n 100000] [--efs 64,256]

The last line of the output is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import json

import jax
import numpy as np
import torch


def reachable_share(neighbors0: np.ndarray, entry: int) -> float:
    """Share of level-0 rows a breadth-first walk from ``entry`` reaches
    (level 0 holds every row, so row = global id)."""
    seen = np.zeros(len(neighbors0), bool)
    seen[entry] = True
    frontier = np.array([entry])
    while len(frontier):
        nxt = neighbors0[frontier].ravel()
        nxt = np.unique(nxt[nxt >= 0])
        nxt = nxt[~seen[nxt]]
        seen[nxt] = True
        frontier = nxt
    return float(seen.mean())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--method", choices=("acorn-1", "hnsw"),
                    default="acorn-1")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--efs", default="64,256")
    args = ap.parse_args(argv)

    import repro.core as J
    import repro_torch.core as T
    from repro.data import make_lcps_dataset, make_workload

    ds = make_lcps_dataset(n=args.n, d=128, card=12, seed=0)
    wl = make_workload(ds, kind="equals", n_queries=args.queries, seed=1,
                       card=12)
    x, xq = np.asarray(ds.x), np.asarray(wl.xq)
    key = jax.random.PRNGKey(0)
    if args.method == "acorn-1":
        masks = np.asarray(wl.masks(ds))
        gt = np.asarray(wl.gt(ds))
        jg = J.build_acorn_1(x, key, M=32)
        tg = T.build_acorn_1(torch.from_numpy(x.copy()), None, M=32,
                             levels=np.asarray(jg.levels))
    else:
        labels = np.asarray(ds.table.int_cols["label"])
        x = x[labels == 0]
        masks = None
        gt = np.asarray(J.ground_truth(xq, x, None, 10))
        jg = J.build_hnsw(x, key, M=32)
        tg = T.build_hnsw(torch.from_numpy(x.copy()), None, M=32,
                          levels=np.asarray(jg.levels))
    xt, qt = torch.from_numpy(x.copy()), torch.from_numpy(xq.copy())
    out = {"method": args.method, "n": args.n, "rows": len(x),
           "queries": args.queries}
    for ef in (int(e) for e in args.efs.split(",")):
        if args.method == "acorn-1":
            kw = dict(k=10, ef=ef, variant="acorn-1", m=32, m_beta=32,
                      max_expansions=4 * ef)
            j_ids, _, j_st = J.hybrid_search(jg, x, xq, masks, **kw)
            t_ids, _, t_st = T.hybrid_search(
                tg, xt, qt, torch.from_numpy(masks.copy()), **kw)
        else:
            j_ids, _, j_st = J.ann_search(jg, x, xq, k=10, ef=ef, m=32)
            t_ids, _, t_st = T.ann_search(tg, xt, qt, k=10, ef=ef, m=32)
        out[f"reference_ef{ef}"] = dict(
            recall=float(J.recall_at_k(j_ids, gt)),
            dist_comps=float(np.mean(np.asarray(j_st.dist_comps))))
        out[f"port_ef{ef}"] = dict(
            recall=T.recall_at_k(t_ids, torch.from_numpy(gt.copy())),
            dist_comps=float(t_st.dist_comps.float().mean()))
        for side in ("reference", "port"):
            print(side, f"ef={ef}", out[f"{side}_ef{ef}"], flush=True)
    out["port_level0_reachable"] = reachable_share(
        tg.neighbors[0].numpy(), int(tg.entry_point))
    print("port level-0 rows reachable from the entry:",
          out["port_level0_reachable"], flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
