#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py            # SIFT1M-shaped LCPS index, n = 1,000,000

Phases, each printed on its own line:

  device   the card's name and power limit (nvidia-smi); build the CUDA
           kernels from ``src/repro_torch/csrc`` and print the build time.
  build    ``HybridIndex.build`` on the card: LCPS data of the paper's
           §7.1 SIFT1M shape (n = 1M, d = 128, 12 uniform labels,
           equality predicates), ACORN-γ with M = 32, γ = 12, M_β = 64.
  kernels  each kernel against its plain PyTorch version on the card, at
           the search path's shapes (B = 256) on rows of the built graph:
           gather_distance within rtol 1e-5 / atol 1e-4 (fp32 sums run in
           another order), neighbor_expand bit-identical; then timed with
           CUDA events.
  serve    at least four 256-query requests through ``HybridIndex.search``
           with §5.2 routing (a forced request is added if a route got no
           query); launch counters are zeroed just before and read just
           after; QPS, route counts and recall@10 per route against the
           exact ground truth computed on the card.
  parity   16 graph-route queries through ``hybrid_search`` on the card
           (kernels) and on a CPU copy of the index (plain versions): ids
           identical except at near ties (distances within 1e-5 relative).

The second-to-last lines are the ``{"kernels": [...]}`` record and the
card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM data-sheet peaks (dense): HBM bandwidth and fp32 (non-tensor) rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

N, D, CARD = 1_000_000, 128, 12
M, GAMMA, M_BETA, K, EF = 32, 12, 64, 10, 64
BUCKETS = (1, 16, 64, 256)
B = 256
REQUESTS = 4   # requests of B queries on the main path
ITERS = 50     # timed launches per kernel (the plain version: ITERS // 5)
FLUSH_BYTES = 256 << 20   # overwritten before each timed call: > 50 MB L2


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, flush, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn`` with a cold L2: before each
    call a buffer larger than the L2 is overwritten, as on the search path
    every hop gathers other rows.  The overwrite also lets the host enqueue
    the call before the device reaches it, so the events time the device."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for t0, t1 in ev:
        flush.zero_()
        t0.record()
        fn()
        t1.record()
    torch.cuda.synchronize()
    return sum(t0.elapsed_time(t1) for t0, t1 in ev) / iters


def bound(bytes_moved: float, flops: float) -> tuple:
    tb = bytes_moved / PEAK_BYTES_PER_S * 1e3
    to = flops / PEAK_FP32_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def gather_distance_bound(ids, q, x) -> tuple:
    """Each input read once: ids, the queries, every distinct row the
    valid ids name; each output written once.  3 flops per element."""
    valid = ids[ids >= 0]
    rows = int(valid.unique().numel())
    d = x.shape[1]
    byts = ids.numel() * 4 + q.numel() * 4 + rows * d * 4 + ids.numel() * 4
    return bound(byts, int(valid.numel()) * d * 3)


def neighbor_expand_bound(row, tbl, pos, pm, vis, strategy, m, m_beta):
    """Bytes this data needs before each lane's scan stops at its m-th
    packed candidate, each input byte once: the 1-hop row entries the
    stream reached (head ids, and under 'compress' the tail ids), one pos
    lookup per expanded row the stream entered, the table entries of the
    present rows it reached, one pass-mask byte per distinct valid id
    reached, one visited byte per distinct one of those that passes the
    mask, and the output.  No arithmetic: the operation count is 0."""
    import torch
    from repro_torch.kernels.neighbor_expand.ref import (
        _dedup_argsort, _passes, expansion_candidates)
    b, cap = row.shape
    dev = row.device
    cand = expansion_candidates(row, tbl, pos, strategy, m_beta)
    c = cand.shape[1]
    ok = _passes(cand, pm, vis)
    if strategy != "filter":
        ok = ok & _dedup_argsort(cand)
    full = torch.cumsum(ok.to(torch.int64), dim=1) >= m
    stop = torch.where(full.any(dim=1), full.int().argmax(dim=1) + 1,
                       torch.full((b,), c, device=dev))
    s = torch.arange(c, device=dev)
    reached = s[None] < stop[:, None]                         # (b, c)
    # per stream position: a 1-hop row entry, or entry of expanded row tt
    t_off = {"filter": 0, "compress": m_beta, "two_hop": 0}[strategy]
    if strategy == "filter":
        is_row, tt = torch.ones_like(s, dtype=torch.bool), torch.zeros_like(s)
    elif strategy == "compress":
        u = (s - m_beta).clamp(min=0)
        is_row = (s < m_beta) | (u % (cap + 1) == 0)
        tt = u // (cap + 1)
    else:
        is_row = s < cap
        tt = (s - cap).clamp(min=0) % cap
    # the expanded rows' ids, with a -1 column so an empty tail indexes too
    tail = torch.nn.functional.pad(row[:, t_off:], (0, 1), value=-1)
    tail_id = torch.gather(tail, 1, tt.expand(b, c))
    entered = reached & ~is_row[None] & (tail_id >= 0) & (tbl.shape[0] > 0)
    present = entered & (pos[tail_id.clamp(0, pos.shape[0] - 1).long()] >= 0)
    rows_entered = torch.zeros(tail.shape, dtype=torch.int32, device=dev)
    rows_entered.scatter_reduce_(1, tt.expand(b, c), entered.int(), "amax")
    ids_read = _dedup_argsort(torch.where(reached, cand, -1))  # distinct, >= 0
    passing = _passes(cand, pm, None)
    byts = 4 * (int((reached & is_row[None]).sum()) + int(rows_entered.sum())
                + int(present.sum()) + b * m)
    if pm is not None:
        byts += int(ids_read.sum())
    if vis is not None:
        byts += int((ids_read & passing).sum())
    return bound(byts, 0)


def profile_request(index, request, route: str) -> None:
    """Trace one request; print its wall time, the device's busy time and
    idle share, and the device time of the heaviest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        index.search(request)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_us[ev.key] = dev_us.get(ev.key, 0) + us
    busy_ms = sum(dev_us.values()) / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
    log("profile", route=route, wall_ms=f"{wall_ms:.1f}",
        device_busy_ms=f"{busy_ms:.2f}",
        idle_share=f"{1 - busy_ms / wall_ms:.3f}" if busy_ms else
        "not_measured",
        top_ms=[(k[:48], round(v / 1e3, 3)) for k, v in top])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one request per route with "
                         "torch.profiler and print where the device time "
                         "goes")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import (AcornConfig, HybridIndex, SearchRequest,
                                  compile_predicates, hybrid_search,
                                  masked_topk, neighbor_rows, recall_at_k)
    from repro_torch.data import make_lcps_dataset, make_workload
    from repro_torch.kernels import loader
    from repro_torch.kernels.gather_distance import (gather_distance_cuda,
                                                     gather_distance_ref)
    from repro_torch.kernels.neighbor_expand import (neighbor_expand_cuda,
                                                     neighbor_expand_ref)

    dev = torch.device("cuda")
    smi = nvidia_smi()
    t_all = time.perf_counter()

    # ---- device: card + kernel build ----
    log("device", name=torch.cuda.get_device_name(0), nvidia_smi=repr(smi),
        torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    loader.library()
    log("device", kernel_build_s=f"{time.perf_counter() - t0:.3f}",
        nvcc_s=f"{loader.BUILD_INFO.get('seconds', float('nan')):.3f}")
    for line in loader.BUILD_INFO.get("log", "").splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("[ptxas] " + line.strip(), file=sys.stderr)

    # ---- build ----
    t0 = time.perf_counter()
    ds = make_lcps_dataset(n=N, d=D, card=CARD, seed=0, device=dev)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    cfg = AcornConfig(M=M, gamma=GAMMA, m_beta=M_BETA, ef_search=EF,
                      buckets=BUCKETS)
    torch.cuda.reset_peak_memory_stats()
    index = HybridIndex.build(ds.x, ds.table, cfg, seed=0, device=dev)
    g = index.graph
    log("build", n=N, d=D, labels=CARD, M=M, gamma=GAMMA, m_beta=M_BETA,
        data_s=f"{data_s:.3f}", build_s=f"{index.build_seconds:.3f}",
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        index_bytes=index.index_bytes, total_bytes=index.total_bytes,
        levels=[tuple(t.shape) for t in g.neighbors])

    # ---- kernels vs plain versions, at the search path's shapes ----
    reqs = REQUESTS
    wl = make_workload(ds, kind="equals", n_queries=reqs * B, seed=1,
                       card=CARD)
    masks_all = wl.masks(ds)
    rng = np.random.default_rng(2)
    nodes = torch.as_tensor(rng.integers(0, N, size=B), device=dev)
    q = wl.xq[:B].contiguous()
    pm = masks_all[:B].contiguous()
    gen = torch.Generator(device=dev).manual_seed(2)
    vis = torch.rand((B, N), generator=gen, device=dev) < 0.02
    records = []

    ids = neighbor_rows(g, 0, nodes)[:, :M].contiguous()
    ids[torch.as_tensor(rng.random(ids.shape) < 0.1, device=dev)] = -1
    # q 4 B past a 16 B boundary: the kernel's scalar (non-float4) loads
    q_odd = torch.empty(B * D + 1, device=dev)[1:].view(B, D).copy_(q)
    gd_err = 0.0
    for metric in ("l2", "ip"):
        for loads, qq in (("float4", q), ("scalar", q_odd)):
            got = gather_distance_cuda(ids, qq, index.x, metric)
            want = gather_distance_ref(ids, qq, index.x, metric)
            torch.cuda.synchronize()
            inf_ok = bool(((got == float("inf")) ==
                           (want == float("inf"))).all())
            fin = torch.isfinite(want)
            err = float((got[fin] - want[fin]).abs().max())
            close = bool(torch.allclose(got[fin], want[fin], rtol=1e-5,
                                        atol=1e-4))
            log("kernels", kernel="gather_distance", metric=metric,
                loads=loads, max_abs_err=err, inf_match=inf_ok, close=close)
            if not (inf_ok and close):
                raise AssertionError(f"gather_distance {metric} ({loads} "
                                     "loads) disagrees with its plain "
                                     "version")
            gd_err = max(gd_err, err)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    gd_ms = time_ms(lambda: gather_distance_cuda(ids, q, index.x, "l2"),
                    ITERS, flush)
    gd_plain = time_ms(lambda: gather_distance_ref(ids, q, index.x, "l2"),
                       ITERS, flush)
    gd_bound, gd_by = gather_distance_bound(ids, q, index.x)
    records.append(dict(
        name="gather_distance", route="cuda",
        source="src/repro_torch/csrc/gather_distance.cu",
        replaces="src/repro/kernels/gather_distance/kernel.py:61",
        max_abs_err=gd_err, ms=gd_ms, plain_ms=gd_plain,
        bound_ms=gd_bound, bound_by=gd_by, library_ms=None,
        shape=f"ids({B},{M}) q({B},{D}) x({N},{D}) l2"))

    row0 = neighbor_rows(g, 0, nodes).contiguous()
    row1 = neighbor_rows(g, 1, g.node_ids[1][
        torch.as_tensor(rng.integers(0, g.node_ids[1].shape[0], size=B),
                        device=dev)]).contiguous()
    empty = torch.zeros((0, row0.shape[1]), dtype=torch.int32, device=dev)
    cases = [("filter", row1, g.neighbors[1], g.pos[1], M_BETA),
             ("compress", row0, g.neighbors[0], g.pos[0], M_BETA),
             ("two_hop", row0, g.neighbors[0], g.pos[0], 0),
             ("compress", row0, g.neighbors[0], g.pos[0], 0),
             ("compress", row0, g.neighbors[0], g.pos[0], row0.shape[1]),
             ("compress", row0, empty, g.pos[0], M_BETA),
             ("two_hop", row0, empty, g.pos[0], 0)]
    for strategy, row, tbl, pos, mb in cases:
        for p_, v_ in ((None, None), (pm, None), (None, vis), (pm, vis)):
            got = neighbor_expand_cuda(row, tbl, pos, p_, v_,
                                       strategy=strategy, m=M, m_beta=mb)
            want = neighbor_expand_ref(row, tbl, pos, p_, v_,
                                       strategy=strategy, m=M, m_beta=mb)
            torch.cuda.synchronize()
            same = bool(torch.equal(got, want))
            if not same:
                bad = int((got != want).any(dim=1).sum())
                raise AssertionError(
                    f"neighbor_expand {strategy} m_beta={mb} n_l="
                    f"{tbl.shape[0]} mask={p_ is not None} "
                    f"visited={v_ is not None}: {bad} lanes differ")
    log("kernels", kernel="neighbor_expand", cases=len(cases) * 4,
        bit_identical=True)
    ne_args = (row0, g.neighbors[0], g.pos[0], pm, vis)
    ne_kw = dict(strategy="compress", m=M, m_beta=M_BETA)
    ne_ms = time_ms(lambda: neighbor_expand_cuda(*ne_args, **ne_kw),
                    ITERS, flush)
    ne_plain = time_ms(lambda: neighbor_expand_ref(*ne_args, **ne_kw),
                       ITERS // 5, flush)
    ne_bound, ne_by = neighbor_expand_bound(*ne_args, **ne_kw)
    records.append(dict(
        name="neighbor_expand", route="cuda",
        source="src/repro_torch/csrc/neighbor_expand.cu",
        replaces="src/repro/kernels/neighbor_expand/kernel.py:157",
        max_abs_err=0.0, ms=ne_ms, plain_ms=ne_plain, bound_ms=ne_bound,
        bound_by=ne_by, library_ms=None,
        shape=f"row({B},{row0.shape[1]}) compress m={M} m_beta={M_BETA} "
              "pass_mask+visited"))
    del vis, flush

    # ---- serve: the main path, counters zeroed just before ----
    requests = [SearchRequest(xq=wl.xq[i * B:(i + 1) * B],
                              predicates=wl.predicates[i * B:(i + 1) * B],
                              k=K)
                for i in range(reqs)]
    index.search(requests[0])  # warm-up: allocator + kernel first touch
    torch.cuda.synchronize()
    gather_distance_cuda.launches = 0
    neighbor_expand_cuda.launches = 0
    results, seconds = [], []
    for r in requests:
        t0 = time.perf_counter()
        res = index.search(r)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        results.append(res)
    routes = np.concatenate([r.routes for r in results])
    for route in ("graph", "prefilter"):
        if not (routes == route).any():
            r = SearchRequest(xq=wl.xq[:B], predicates=wl.predicates[:B],
                              k=K, route=route)
            t0 = time.perf_counter()
            res = index.search(r)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            results.append(res)
            requests.append(r)
    launches = {"gather_distance": gather_distance_cuda.launches,
                "neighbor_expand": neighbor_expand_cuda.launches}
    routes = np.concatenate([r.routes for r in results])
    n_q = len(routes)
    ids_all = torch.cat([r.ids for r in results])
    xq_all = torch.cat([r.xq for r in requests])
    masks = torch.cat([compile_predicates(r.predicates, index.table)
                       .evaluate(index.table) for r in requests])
    gt, _ = masked_topk(xq_all, index.x, masks, K)
    rec = {}
    for route in ("graph", "prefilter"):
        sel = torch.as_tensor(np.nonzero(routes == route)[0], device=dev)
        rec[route] = recall_at_k(ids_all[sel], gt[sel]) if len(sel) else None
    log("serve", requests=len(requests), queries=n_q,
        qps=f"{n_q / sum(seconds):.1f}",
        request_ms=[round(s * 1e3, 1) for s in seconds],
        graph=int((routes == "graph").sum()),
        prefilter=int((routes == "prefilter").sum()),
        recall_graph=rec["graph"], recall_prefilter=rec["prefilter"],
        launches=launches)
    if rec["prefilter"] is None or rec["prefilter"] < 0.999:
        raise AssertionError(f"pre-filter recall {rec['prefilter']} < 0.999")
    if rec["graph"] is None or rec["graph"] < 0.5:
        raise AssertionError(f"graph-route recall {rec['graph']} < 0.5")
    for name, cnt in launches.items():
        if cnt <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    for rcd in records:
        rcd["launches"] = launches[rcd["name"]]
        rcd["kernel_ms"] = rcd["ms"]

    if args.profile:
        for route in ("graph", "prefilter"):
            profile_request(index, SearchRequest(
                xq=requests[0].xq, predicates=requests[0].predicates, k=K,
                route=route), route)

    # ---- parity: card (kernels) vs a CPU copy (plain versions) ----
    gsel = np.nonzero(routes == "graph")[0][:16]
    qs, ms = xq_all[gsel], masks[gsel]
    kw = dict(k=K, ef=EF, variant="acorn-gamma", m=M, m_beta=M_BETA,
              compressed_level0=True)
    ids_c, d_c, _ = hybrid_search(g, index.x, qs, ms, **kw)
    x_cpu = index.x.cpu()
    ids_h, d_h, _ = hybrid_search(g.to("cpu"), x_cpu, qs.cpu(), ms.cpu(),
                                  **kw)
    ids_c, d_c = ids_c.cpu(), d_c.cpu()
    diff = ids_c != ids_h
    ties = 0
    for qi_, j in diff.nonzero().tolist():
        a, b_ = int(ids_c[qi_, j]), int(ids_h[qi_, j])
        if a < 0 or b_ < 0:
            raise AssertionError(f"card vs CPU: query {qi_} slot {j} "
                                 f"{a} vs {b_}")
        qv = qs[qi_].cpu().double()
        da = float(((x_cpu[a].double() - qv) ** 2).sum())
        db = float(((x_cpu[b_].double() - qv) ** 2).sum())
        if abs(da - db) > 1e-5 * max(abs(da), abs(db)):
            raise AssertionError(
                f"card vs CPU: query {qi_} slot {j} ids {a} vs {b_}, "
                f"distances {da} vs {db} are not a near tie")
        ties += 1
    same = ~diff & torch.isfinite(d_h)
    close = bool(torch.allclose(d_c[same], d_h[same], rtol=1e-5, atol=1e-4))
    log("parity", queries=len(gsel), differing_slots=ties,
        near_ties=ties, dists_close=close)
    if not close:
        raise AssertionError("card vs CPU distances disagree")

    log("total", seconds=f"{time.perf_counter() - t_all:.1f}")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
