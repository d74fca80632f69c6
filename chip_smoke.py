#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py   # SIFT1M-shaped LCPS index (n = 1,000,000)
                            # with Figure 7's baselines and Table 4's
                            # incremental builds beside it,
                            # two-tower retrieval_cand (n = 1,048,576),
                            # embedding_bag, PNA molecule inference, the
                            # sharded HCPS serving engine (n = 2^20) and
                            # the distributed paths on a one-rank NCCL
                            # mesh (acorn serve_1m and serve_25m, the
                            # SPMD engine)
    python3 chip_smoke.py --baseline DIR   # also time the gather_distance.cu,
                            # neighbor_expand.cu, filtered_topk.cu and
                            # pna_aggregate.cu in DIR (an earlier version)
                            # in turns with the port's
    python3 chip_smoke.py --profile        # also trace requests (device time
                            # and launches of each of the port's kernels)

Phases, each printed on its own line:

  device   the card's name and power limit (nvidia-smi); build the CUDA
           kernels from ``src/repro_torch/csrc`` (one nvcc per source, all
           started together) and print the build time; join a one-rank
           ``nccl`` process group (``HashStore``, rank 0 of 1, a 60 s
           collective timeout) and check that an all-gather of a CUDA
           tensor returns it (``mesh_group``).
  build    ``HybridIndex.build`` on the card: LCPS data of the paper's
           §7.1 SIFT1M shape (n = 1M, d = 128, 12 uniform labels,
           equality predicates), ACORN-γ with M = 32, γ = 12, M_β = 64.
  kernels  each kernel against its plain PyTorch version on the card, at
           the search path's shapes (B = 256) on rows of the built graph:
           gather_distance within rtol 1e-5 / atol 1e-4 (fp32 sums run in
           another order) and +inf where the plain version has it, also at
           ``GD_EDGE_CASES``; neighbor_expand bit-identical, also at
           ``NE_EDGE_CASES``; the launch floor (a 1-element ``zero_()``
           timed as the kernels are); both timed, with the lanes' stop
           positions for neighbor_expand; filtered_topk
           (B = 256, k = 10, l2, the index's vectors and LCPS masks) with
           ids identical except at near ties and dists within rtol 1e-5 /
           atol max(1e-4, 1e-6 (|q|^2 + |x|^2)), and the same at
           ``TOPK_EDGE_CASES`` (padding, partial tiles, k = n, ties, k at
           its cap of 256, up to 16,602 tile lists, every tile holding the
           same scores, all rows passing at n = 2^20, fewer passing rows
           than k); then timed with CUDA events (with ``--baseline``, in
           turns with the earlier ``filtered_topk.cu``).
  serve    at least four 256-query requests through ``HybridIndex.search``
           with §5.2 routing (a forced request is added if a route got no
           query); launch counters are zeroed just before and read just
           after; QPS, route counts and recall@10 per route against the
           exact ground truth computed on the card.
  parity   16 graph-route queries through ``hybrid_search`` on the card
           (kernels) and on a CPU copy of the index (plain versions),
           compared as filtered_topk is against its plain version.
  hops     one forced graph-route request with recording wrappers around
           ``repro_torch.core.search``'s neighbor_expand and
           gather_distance (removed after it): both kernels checked and
           timed again on the arguments of level-0 hops ``HOPS``
           (``other_shapes`` of their records).
  baselines  Figure 7 (§7.2) on the build phase's data and the serve
           phase's first 256 queries with their exact top-10: ACORN-1
           (M = 32), HNSW (M = 32, efc 64) and the oracle partition index
           (12 HNSW graphs, one per label, ~83k rows each) built on the
           card (seconds, peak memory, index bytes); ACORN-γ and ACORN-1
           through ``hybrid_search`` (max_expansions 4·ef), HNSW
           post-filtering at the workload's mean selectivity and the
           oracle (one batch per label) at each ef of ``BASE_EF_SWEEP``,
           pre-filtering once: recall@10, QPS and mean dist_comps, launch
           counters zeroed just before each call and read just after
           (gather_distance for every graph method, neighbor_expand for
           ACORN-γ and ACORN-1 only); every id passes its predicate,
           pre-filter recall >= 0.999; a method below
           ``BASE_RECALL_FLOOR`` at the last ef returns a CPU copy's ids on
           every query there (its recall is then the plain versions'
           own); QPS at recall 0.9 per method (not gated); 16 queries of each method at ef 64 against a CPU copy
           (near ties only); ``build_hnsw`` over the first 2^14 rows on
           the card and on the CPU (differences only at explained near
           ties: exact-KNN ties, float64 prune margins, identical
           reverse slack).
  incremental  Table 4: ``build_incremental`` for hnsw (efc 40), acorn-1
           and acorn-gamma (M = 32, γ = 12, ef_build 480) over the first
           ``N_INC`` rows (a cut: sequential inserts are host-driven):
           time to index, index bytes, recall@10 of 64 unfiltered queries
           against their exact top-10 over those rows, whether TTI(ACORN-1)
           < TTI(HNSW) < TTI(ACORN-γ) (not gated); then each variant over
           256 rows on the card and on a CPU copy: neighbour lists,
           counts and entry point identical (a diverging insert must be
           explained by a near tie).
  retrieve the two-tower arch's ``retrieval_cand`` step at its FULL width
           (4,194,304 users, 2,097,152 items, E = 256, towers
           1024-512-256): item embeddings of 1,048,576 candidates, a
           ``category`` column (12 uniform labels, one rare label on 37
           items); filtered_topk held against its plain version at the
           path's shape (B = 1, k = 100, ip) and timed (with
           ``--baseline``, in turns with the earlier kernel: ``baseline_ms``,
           ``ms_runs``, ``speedup``); then 64 batch-1 requests (Equals
           predicate -> mask -> step) with the launch counters zeroed just
           before and read just after; p50 / p99 request time (and the p50
           of its parts, each ended by a synchronise: the mask, split into
           ``compile_predicates``, ``pack_columns`` + ``regex_aux`` and
           ``evaluate_program``, and the step), peak device memory; one
           batch-512 ``serve_p99``.  With ``--profile``, one request
           traced: filtered_topk's device launches and time per launch.
  parity   8 of those requests on a CPU copy of the model, candidates and
           table: ids identical except at near ties, scores within 1e-5;
           then the same 8 through the mesh-explicit
           ``filtered_retrieval_step`` on ``make_host_mesh()`` (matmul +
           top-k, gathered over the one-rank mesh): ids equal
           ``retrieval_cand``'s except at near ties (its masked candidates,
           kept with a -inf score, compared as -1 padding), step time.
  bag      the ``embedding_bag`` op (forward and gradient) over the same
           model's ``user_emb`` table (4,194,304 x 256, 4.29 GB): the
           kernel against its plain version at ``BAG_EDGE_CASES`` and at
           the recsys shapes, ids (512, 4) (``serve_p99`` batch x
           ``n_user_feats``) and (65,536, 4) (``train_batch``), ~25 % -1
           padding, sum and mean, within rtol / atol 1e-5; timed; then the
           op at those shapes with the launch counters zeroed just before
           and read just after, and its gradient at (65,536, 4) against a
           CPU copy.
  pna      PNA (``get_arch("pna")``, ``molecule`` shape: 4 layers,
           d_in 16, d_hidden 75, 2 classes) with random weights from a
           seed: ``pna_aggregate`` against its plain version at
           ``PNA_EDGE_CASES`` and at the path shape adj (128, 30, 30),
           feats (128, 30, 75) and a bulk shape of 16,384 graphs (max / min
           exact, mean rtol 1e-5 / atol 1e-6, std atol 2e-3); timed beside
           the launch floor (with ``--baseline``, in turns with the earlier
           ``pna_aggregate.cu``); then
           64 requests of 128 molecule-like graphs through
           ``forward_dense``, counters zeroed just before and read just
           after (``pna_aggregate`` must launch 4 x 64 times); p50 / p99
           request time and graphs/s; 8 requests against a CPU copy
           (logits within atol 2e-3).  With ``--profile``, one request
           traced: pna_aggregate's device launches and time.
  engine   the sharded serving engine of ``python -m
           repro_torch.launch.serve`` at LAION-1M scale: HCPS data
           (``make_hcps_dataset(n=2^20, d=512, seed=0)``: 4,096 clusters,
           30 keywords, captions, 120 dates), ``EngineConfig(batch_size=32,
           k=10, n_shards=4)``, ``AcornConfig(M=16, gamma=12, m_beta=32,
           ef_search=96)``; data and build seconds, peak memory, index
           bytes.  gather_distance (d = 512, l2 and ip, 10 % -1 ids) and
           neighbor_expand (compress and two_hop, m = 16, m_beta = 32) held
           against their plain versions on shard 0's graph and timed
           (``other_shapes`` entries with ``phase: engine``).  1,024
           ``contains`` queries through ``engine.serve`` in batches of 32
           after one warm-up batch, counters zeroed just before and read
           just after (``engine_launches`` of both records): QPS, batch
           times, route split, recall@10 per route against ``masked_topk``
           over the whole corpus, every returned id checked against its
           predicate; 64 queries of each of ``ENGINE_KINDS`` (the regex
           pass over 2^20 captions logged on its own line); the first 64
           queries of the closed loop and of each kind forced onto the
           graph route at ef 64 and 256, with the generator clusters their
           exact top-10 span (``graph_forced``); an open loop of
           256 requests of 4 queries through ``ServingRuntime`` at seeded
           Poisson arrivals, 50 % of the closed loop's QPS (sustained QPS,
           p50 / p99, shed, dispatches, batch sizes; every served query's
           ids held to the closed loop's, near ties counted); an overload
           of 64 requests at once against ``max_queue=64`` (sheds sentinels,
           raises nothing); a failover drill (a mirrored failed shard
           returns the healthy ids; a hard loss is flagged degraded and
           returns no id of that shard; ``rebuild_shard`` returns the
           healthy ids); 16 graph-route queries against a CPU copy of the
           four shards (``convert.engine_from_arrays``), ids identical
           except at near ties.  With ``--profile``, one 32-query batch
           traced.
  mesh     the distributed paths on the one-rank NCCL group, at full
           width.  ``mesh_engine``: the launcher's engine with one shard
           and ``ExecutionSpec(corpus_parallel=1)`` over the engine
           phase's corpus, so it takes the SPMD path on a 1 x 1 mesh
           (checked); gather_distance and neighbor_expand held to their
           plain versions on the (2^20, 512) shard that path searches, as
           the engine phase holds them on its own shard; the first 256
           closed-loop queries through ``search_batch`` (launch counters
           zeroed just before, read just after: both graph kernels must
           launch), again (no new variant), and through
           ``search_batch_host``: bit-identical; 16 graph-route queries
           through the SPMD program against a CPU copy's host loop (plain
           versions), ids identical except at near ties;
           ``fail_shard(0)`` gives the all-down sentinel and
           ``rebuild_shard(0)`` the same ids; build s, peak memory, QPS of
           both paths.  ``acorn_serve``: the ``acorn`` arch's serve step
           (``get_arch("acorn")``, ``make_host_mesh()``) at ``serve_1m``
           (B = 512, n = 2^20, d = 512, k = 10; fp32 corpus, bool masks
           at 0.5 drawn from a seed on the card), ``optimized=False`` and
           ``True`` (block 8,192, the reference's, and 65,536), then at
           ``serve_25m`` (n = 3 x 2^23: 51.5 GB of corpus and 12.9 GB of
           masks), ``optimized=True`` only — ``False``'s score matrix alone
           would take 51.5 GB more; every id passes its mask, the variants
           agree but for near ties, 16 (8) queries equal an exact float64
           recompute; ms per call (cold L2), QPS, peak memory and the
           bound (bytes of corpus + masks at 3.35 TB/s against fp32 FLOPs
           at 67 TFLOP/s).
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
TOPK_K = 10               # filtered_topk's second shape, on the LCPS index
# filtered_topk's edge cases, the same as CARD_CASES in
# tests/test_torch_filtered_topk.py (case i is drawn with seed i); the
# kernel's tiles hold 2048 rows, one CTA each, and the last CTA of a query
# selects from the keys the tiles published (in shared memory up to 2048
# keys, from the lists in global memory past that)
TOPK_EDGE_CASES = [
    dict(b=5, n=777, d=24, k=9, p=0.2, empty_rows=True),
    dict(b=3, n=20_000, d=13, k=100, p=0.3, empty_rows=True),  # scalar loads
    dict(b=2, n=40_000, d=64, k=256, p=0.05),     # several tiles, k at cap
    dict(b=4, n=9_000, d=16, k=33, dup=True),
    dict(b=1, n=70_000, d=8, k=1, p=1.1),
    dict(b=2, n=100, d=8, k=100, p=0.3),          # k = n, one tile
    dict(b=1, n=64, d=3, k=64, p=1.1, dup=True),  # k = n
    # 512, 2442 and 16,602 tile lists; integer data, so both versions score
    # exactly and ties are exact
    dict(b=2, n=1 << 20, d=4, k=256, ints=True),
    dict(b=3, n=5_000_000, d=4, k=128, ints=True),
    dict(b=1, n=34_000_000, d=4, k=256, ints=True),
    # every tile holds the same scores: every key ties with the threshold
    # and the id order decides; the last CTA's candidates overflow its
    # shared buffer
    dict(b=2, n=64 * 2048, d=4, k=256, p=1.1, ints=True, period=2048),
    dict(b=1, n=1 << 20, d=8, k=256, p=1.1, ints=True),  # all pass
    dict(b=2, n=5 * 2048 + 300, d=16, k=100, tail=300),  # last tile only
    dict(b=2, n=1 << 20, d=32, k=100, few=37),    # fewer than k, spread
    dict(b=2, n=4 * 2048 + 1, d=16, k=50, p=0.3, last_row=True),
]

# two-tower retrieval_cand (repro_torch/configs/two_tower_retrieval.py FULL)
N_CAND, CAND_CHUNK = 1_048_576, 65_536
CATEGORIES, RARE_VALUE, RARE_ITEMS = 12, 12, 37
RETRIEVE_REQUESTS, RARE_AT, WARMUP_REQUESTS = 64, 5, 2
SERVE_BATCH, RETRIEVE_PARITY = 512, 8
# relative width of a near tie in score (as in tests/torch_parity.py)
NEAR_TIE_REL = 1e-5

# embedding_bag over the two-tower FULL user table: (bags, ids per bag) of
# serve_p99 (batch 512) and train_batch (65,536), n_user_feats = 4 each
BAG_SHAPES = ((512, 4), (65_536, 4))
BAG_PAD = 0.25            # share of -1 ids
BAG_TOL = dict(rtol=1e-5, atol=1e-5)
# the same as CARD_CASES in tests/test_torch_embedding_bag.py (case i is
# drawn with seed i)
BAG_EDGE_CASES = [
    dict(b=16, l=8, v=1000, d=32), dict(b=3, l=4, v=10, d=8, kind="padding"),
    dict(b=6, l=5, v=9, d=8, kind="clip"),
    dict(b=4, l=6, v=20, d=8, kind="dup"), dict(b=7, l=5, v=30, d=13),
    dict(b=1000, l=4, v=5000, d=256), dict(b=33, l=9, v=70, d=260),
    dict(b=9, l=3, v=40, d=600), dict(b=5, l=0, v=10, d=8)]

# PNA dense-batched inference (repro_torch/configs/pna.py, molecule shape)
PNA_REQUESTS, PNA_WARMUP, PNA_PARITY = 64, 2, 8
PNA_BULK_GRAPHS = 16_384  # the bulk shape: a molecule library scored offline
PNA_LOGITS_ATOL = 2e-3    # as tests/test_torch_pna.py
PNA_WEIGHTS = (0, 0, 0, 0.5, 1, 2, -1)   # a weighted case's adjacency values
# the same as CARD_CASES in tests/test_torch_pna_aggregate.py (case i is
# drawn with seed i): N = 33 and 128 cross a 32-source tile; weighted
# adjacencies (values in {0, 0.5, 1, 2, -1}, one case over several source
# tiles); N = 31, where every graph's adjacency and features start at
# another alignment; 5,000 graphs of N = 3, more than the persistent grid
# holds at once; F = 1 and F = 300 (split into feature blocks); N = 600,
# past a whole graph in shared memory
PNA_EDGE_CASES = [
    dict(b=1, n=8, f=4), dict(b=2, n=30, f=75),
    dict(b=2, n=9, f=5, kind="zero"), dict(b=2, n=10, f=6, kind="full"),
    dict(b=3, n=30, f=16, kind="molecule"),
    dict(b=2, n=12, f=7, kind="constant"), dict(b=3, n=1, f=5),
    dict(b=3, n=33, f=75), dict(b=2, n=128, f=75, kind="molecule"),
    dict(b=2, n=128, f=40), dict(b=3, n=30, f=75, kind="weighted"),
    dict(b=2, n=100, f=24, kind="weighted"), dict(b=4, n=31, f=75),
    dict(b=5000, n=3, f=4), dict(b=4, n=30, f=1), dict(b=3, n=30, f=300),
    dict(b=2, n=600, f=75)]

# HCPS serving at LAION-1M scale (python -m repro_torch.launch.serve's
# engine): the reference's serve_1m shape (src/repro/configs/acorn.py), 2^20
# rows at d = 512 (LAION's CLIP width), 4 corpus shards of 262,144 rows
ENGINE_N, ENGINE_D, ENGINE_SHARDS = 1 << 20, 512, 4
ENGINE_M, ENGINE_GAMMA, ENGINE_M_BETA, ENGINE_EF_SEARCH = 16, 12, 32, 96
ENGINE_BATCH, ENGINE_K = 32, 10
ENGINE_CLOSED = 1024       # `contains` queries, correlation none, seed 1
ENGINE_KIND_QUERIES = 64   # each of ENGINE_KINDS, seed 2
ENGINE_KINDS = (("between", "none"), ("contains+between", "none"),
                ("regex", "none"), ("contains", "pos"), ("contains", "neg"))
OPEN_REQUESTS, OPEN_SIZE = 256, 4   # open loop: requests of 4 queries
OPEN_LOAD = 0.5                     # of the closed loop's QPS
OVERLOAD_REQUESTS, OVERLOAD_QUEUE = 64, 64
ENGINE_PARITY = 16                  # graph-route queries on a CPU copy
# the first queries of the closed loop and of each kind, forced onto the
# graph route at each ef: does graph recall rise with the search's budget?
ENGINE_SWEEP_QUERIES, ENGINE_EF_SWEEP = 64, (64, 256)

# Figure 7 (§7.2) on the build phase's data and queries: ACORN-1, HNSW
# post-filtering and the oracle partition index (one HNSW per label) beside
# ACORN-γ and pre-filtering, the reference's fig7_recall_qps methods
BASE_M = 32                        # ACORN-1 (m = m_β = 32), HNSW, oracle
BASE_EFC = max(2 * BASE_M, 40)     # HNSW's efc: the reference's default
BASE_EF_SWEEP = (32, 64, 128, 256)
BASE_PARITY = 16                   # queries per method on a CPU copy, ef 64
BASE_HNSW_ROWS = 1 << 14           # build_hnsw on the card and on the CPU
RECALL_TARGET = 0.9
# the serve phase's floor against a broken kernel; a method below it at the
# last ef must match a CPU copy on every query (the reference's bulk
# ACORN-1 stays near 0.2-0.3 here in both packages)
BASE_RECALL_FLOOR = 0.5
# Table 4: time to index of the incremental builder (sequential inserts,
# host-driven); N_INC is cut to fit the run's time
N_INC = 2048
INC_VARIANTS = ("hnsw", "acorn-1", "acorn-gamma")
INC_EFC = 40                       # ef_build: 40; ACORN-γ 40·γ = 480
INC_QUERIES = 64
INC_PREFIX = 256                   # rows built on the card and on the CPU

# neighbor_expand's edge cases, the same as CARD_CASES in
# tests/test_torch_neighbor_expand.py (case i is drawn with seed i by
# expand_edge_inputs), each run with the pass mask and the visited set given
# or None: ids that share hash slots, one id throughout a stream, lanes that
# stop before m (all visited, nothing passes), m wider than a round (the
# shared-memory opt-in), filter at the upper levels' cap = 384, two_hop at
# acorn-1's cap = 64, an empty level, m_beta 0 and cap, and the path's shape
# with duplicate-heavy 2-hop rows whose lanes stop past 1,024 positions
NE_EDGE_CASES = [
    dict(kind="collide", strategy="compress", cap=128, m=32, m_beta=64,
         n=1 << 17),
    dict(kind="repeat", strategy="compress", cap=128, m=32, m_beta=64),
    dict(kind="repeat", strategy="two_hop", cap=64, m=32),
    dict(kind="all_visited", strategy="compress", cap=128, m=32, m_beta=64),
    dict(strategy="compress", cap=128, m=2000, m_beta=64, n=200_000,
         p_pass=1.0, p_vis=0.05),
    dict(strategy="filter", cap=384, m=32, p_pass=0.1),
    dict(strategy="two_hop", cap=64, m=32, p_pass=1 / 12),
    dict(strategy="compress", cap=128, m=32, m_beta=64, n_l=0),
    dict(strategy="two_hop", cap=64, m=32, n_l=0),
    dict(strategy="compress", cap=128, m=32, m_beta=0),
    dict(strategy="compress", cap=128, m=32, m_beta=128),
    dict(kind="path", strategy="compress", cap=128, m=32, m_beta=64,
         p_pass=0.03),
]
# gather_distance's edge cases, the same as CARD_CASES in
# tests/test_torch_gather_distance.py (case i is drawn with seed i by
# gather_edge_inputs): d = 13 (scalar loads), all ids -1, ids >= n
# (clipped), M not a multiple of a warp's 4 rows, B = 1, more row groups
# than warps
GD_EDGE_CASES = [
    dict(b=5, m=12, n=40, d=16), dict(b=5, m=12, n=40, d=13),
    dict(b=4, m=9, n=50, d=16, kind="invalid"),
    dict(b=3, m=13, n=30, d=24, kind="clip"),
    dict(b=1, m=32, n=100, d=128), dict(b=3, m=70, n=500, d=64)]
# level-0 hops of one graph-route request whose arguments are captured
HOPS = (1, 8, 32, 64)


def fib_slot(ids, bits: int):
    """The hash slot of each id in neighbor_expand.cu's dedup set of
    2^bits slots (Fibonacci hashing), mirrored here to draw colliding ids."""
    return ((ids.astype(np.uint64) * 0x9E3779B1) & 0xFFFFFFFF) >> (32 - bits)


def expand_edge_inputs(strategy, cap, m, m_beta=0, kind="random", b=4,
                       n=4000, n_l=None, p_pass=0.5, p_vis=0.1, seed=0):
    """(row, tbl, pos, pm, vis) numpy arrays of a neighbor_expand edge
    case, as tests/test_torch_neighbor_expand.py draws them (``strategy``,
    ``m`` and ``m_beta`` are the call's)."""
    rng = np.random.default_rng(seed)
    n_l = n if n_l is None else n_l
    level = rng.permutation(n)[:n_l]
    pos = np.full(n, -1, np.int32)
    pos[level] = np.arange(n_l, dtype=np.int32)
    pool = np.arange(n)
    if kind == "collide":   # two adjacent slots of the m = 32 set (4,096
        slot = fib_slot(pool, 12)             # slots), and ids = 7 mod 4096
        pool = np.concatenate([pool[(slot == 5) | (slot == 6)],
                               pool[pool % 4096 == 7]])
    elif kind == "path":    # 2-hop rows overlap: 1,500 ids fill the stream
        pool = rng.choice(n, 1500, replace=False)
    row, tbl = (np.where(rng.random(s) < 0.03, -1, rng.choice(pool, size=s))
                .astype(np.int32) for s in ((b, cap), (n_l, cap)))
    if kind == "repeat":    # one id throughout each lane's stream
        x = rng.choice(level, size=b)
        row[:] = x[:, None]
        tbl[pos[x]] = x[:, None]
    pm = rng.random((b, n)) < p_pass
    vis = rng.random((b, n)) < p_vis
    if kind in ("repeat", "all_visited"):
        vis[0] = True           # lane 0: every id visited
        pm[1] = False           # lane 1: nothing passes
    return row, tbl, pos, pm, vis


def gather_edge_inputs(b, m, n, d, kind="random", seed=0):
    """(ids, q, x) numpy arrays of a gather_distance edge case, as
    tests/test_torch_gather_distance.py draws them."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, n, size=(b, m)).astype(np.int32)
    if kind == "invalid":
        ids[:] = -1
    elif kind == "clip":
        ids[:, ::2] = rng.integers(n, n + 5, size=ids[:, ::2].shape)
    q = rng.normal(size=(b, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return ids, q, x


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
    """(bound ms, "bytes", stop): ``stop`` (B,) is each lane's stop
    position, one past its m-th packed candidate (the stream's length where
    fewer pack).  Bytes this data needs before each lane's scan stops there,
    each input byte once: the 1-hop row entries the
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
    return (*bound(byts, 0), stop)


def baseline_kernels(src_dir: str) -> tuple:
    """An earlier ``gather_distance.cu``, ``neighbor_expand.cu``,
    ``filtered_topk.cu`` and ``pna_aggregate.cu`` from ``src_dir`` (the
    same C entry points, names and arguments; ``filtered_topk`` with or
    without the per-query ``state`` buffer of the one-launch design), built
    with the loader's flags into a library of their own and loaded beside
    the port's; returns (gather_distance, neighbor_expand, filtered_topk,
    pna_aggregate) callables that take the launchers' arguments.  For
    timing a redesign against the kernels it replaced in one run."""
    import ctypes
    import torch
    from repro_torch.kernels import loader
    out = loader.BUILD_DIR / "baseline"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = loader._nvcc()
    names = ("gather_distance", "neighbor_expand", "filtered_topk",
             "pna_aggregate")
    objs = [str(out / f"{nm}.o") for nm in names]
    loader._run_all([[nvcc, *loader.NVCC_FLAGS, "-c",
                      os.path.join(src_dir, f"{nm}.cu"), "-o", o]
                     for nm, o in zip(names, objs)])
    lib_path = str(out / "librepro_baseline.so")
    loader._run_all([[nvcc, "-shared", *objs, "-o", lib_path]])
    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_gather_distance.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.repro_gather_distance.restype = i
    lib.repro_neighbor_expand.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                          i, i, p]
    lib.repro_neighbor_expand.restype = i
    with open(os.path.join(src_dir, "filtered_topk.cu")) as f:
        with_state = "void* state" in f.read()
    lib.repro_filtered_topk.argtypes = ([p] * (7 if with_state else 6)
                                        + [i] * 5 + [p])
    lib.repro_filtered_topk.restype = i
    lib.repro_filtered_topk_workspace.argtypes = [i, i, i]
    lib.repro_filtered_topk_workspace.restype = ctypes.c_longlong
    lib.repro_pna_aggregate.argtypes = [p, p, p, i, i, i, p]
    lib.repro_pna_aggregate.restype = i
    strategies = {"filter": 0, "compress": 1, "two_hop": 2}

    def gather(ids, q, x, metric):
        out = torch.empty(ids.shape, dtype=torch.float32, device=ids.device)
        loader.check(lib.repro_gather_distance(
            ids.data_ptr(), q.data_ptr(), x.data_ptr(), out.data_ptr(),
            ids.shape[0], ids.shape[1], x.shape[0], x.shape[1],
            int(metric == "ip"), torch.cuda.current_stream().cuda_stream),
            "baseline gather_distance")
        return out

    def expand(row, tbl, pos, pm, vis, *, strategy, m, m_beta):
        out = torch.empty((row.shape[0], m), dtype=torch.int32,
                          device=row.device)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        loader.check(lib.repro_neighbor_expand(
            row.data_ptr(), tbl.data_ptr(), pos.data_ptr(), ptr(pm),
            ptr(vis), out.data_ptr(), row.shape[0], row.shape[1],
            pos.shape[0], tbl.shape[0], m, m_beta, strategies[strategy],
            torch.cuda.current_stream().cuda_stream),
            "baseline neighbor_expand")
        return out

    state = torch.zeros(0, dtype=torch.int64)

    def topk(q, x, mask, k, metric):
        nonlocal state
        b, n = mask.shape
        ids = torch.empty((b, k), dtype=torch.int32, device=q.device)
        dists = torch.empty((b, k), dtype=torch.float32, device=q.device)
        ws = torch.empty(lib.repro_filtered_topk_workspace(b, n, k),
                         dtype=torch.int64, device=q.device)
        if with_state and state.numel() < 2 * b:
            state = torch.zeros(2 * b, dtype=torch.int64, device=q.device)
        ptrs = [q.data_ptr(), x.data_ptr(), mask.data_ptr(), ids.data_ptr(),
                dists.data_ptr()] + ([state.data_ptr()] if with_state
                                     else []) + [ws.data_ptr()]
        loader.check(lib.repro_filtered_topk(
            *ptrs, b, n, x.shape[1], k, int(metric == "ip"),
            torch.cuda.current_stream().cuda_stream),
            "baseline filtered_topk")
        return ids, dists

    def pna(adj, feats):
        b, n, f = feats.shape
        out = torch.empty((b, n, 4 * f), dtype=torch.float32,
                          device=adj.device)
        loader.check(lib.repro_pna_aggregate(
            adj.data_ptr(), feats.data_ptr(), out.data_ptr(), b, n, f,
            torch.cuda.current_stream().cuda_stream),
            "baseline pna_aggregate")
        return out

    return gather, expand, topk, pna


def time_in_turns(new, old, flush) -> dict:
    """``new`` timed with ``time_ms``; with an ``old`` version, in turns
    old, new, new, old, so drift over the run hits both alike."""
    if old is None:
        return dict(ms=time_ms(new, ITERS, flush))
    o1, n1, n2, o2 = (time_ms(f, ITERS, flush) for f in (old, new, new, old))
    return dict(ms=(n1 + n2) / 2, baseline_ms=(o1 + o2) / 2,
                ms_runs=[n1, n2], baseline_runs=[o1, o2],
                speedup=(o1 + o2) / (n1 + n2))


def assert_gather_close(got, want, what: str) -> float:
    """+inf exactly where the plain version has it, finite values within
    rtol 1e-5 / atol 1e-4 (fp32 sums in another order); the max |err|."""
    import torch
    inf = want == float("inf")
    fin = torch.isfinite(want)
    if not (torch.equal(got == float("inf"), inf) and torch.allclose(
            got[fin], want[fin], rtol=1e-5, atol=1e-4)):
        raise AssertionError(f"{what}: disagrees with the plain version")
    return float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) \
        else 0.0


def measure_gather(ids, q, x, metric, flush, base, what: str) -> dict:
    """gather_distance against its plain version (and the baseline kernel,
    if given), then the kernel (in turns with the baseline) and the plain
    version timed with a cold L2, and the bound of these inputs."""
    from repro_torch.kernels.gather_distance import (gather_distance_cuda,
                                                     gather_distance_ref)
    want = gather_distance_ref(ids, q, x, metric)
    err = assert_gather_close(gather_distance_cuda(ids, q, x, metric), want,
                              what)
    if base is not None:
        assert_gather_close(base[0](ids, q, x, metric), want,
                            what + " (baseline)")
    bound_ms, by = gather_distance_bound(ids, q, x)
    rec = dict(
        shape=f"ids({ids.shape[0]},{ids.shape[1]}) q({q.shape[0]},"
              f"{q.shape[1]}) x({x.shape[0]},{x.shape[1]}) {metric} "
              f"invalid={float((ids < 0).float().mean()):.3f}",
        max_abs_err=err,
        **time_in_turns(lambda: gather_distance_cuda(ids, q, x, metric),
                        None if base is None else
                        lambda: base[0](ids, q, x, metric), flush),
        plain_ms=time_ms(lambda: gather_distance_ref(ids, q, x, metric),
                         ITERS // 5, flush),
        bound_ms=bound_ms, bound_by=by, library_ms=None)
    log("kernels", kernel="gather_distance", what=repr(what), **{
        k: repr(v) if isinstance(v, str) else v for k, v in rec.items()})
    return rec


def measure_expand(args, kw, flush, base, what: str) -> dict:
    """neighbor_expand bit for bit against its plain version (and the
    baseline kernel, if given), then timed as ``measure_gather`` does,
    with its bound and the lanes' stop positions: the mean and largest,
    the mean rounds of a design that walks chunks of 256 positions and
    the least mean rounds of the present one (at most 512 positions a round;
    it narrows a round to 256 where the yield so far says that is
    enough)."""
    import torch
    from repro_torch.kernels.neighbor_expand import (neighbor_expand_cuda,
                                                     neighbor_expand_ref)
    want = neighbor_expand_ref(*args, **kw)
    outs = [("kernel", neighbor_expand_cuda(*args, **kw))]
    if base is not None:
        outs.append(("baseline", base[1](*args, **kw)))
    torch.cuda.synchronize()
    for who, got in outs:
        if not torch.equal(got, want):
            bad = int((got != want).any(dim=1).sum())
            raise AssertionError(f"neighbor_expand {what} ({who}): {bad} "
                                 "lanes differ from the plain version")
    bound_ms, by, stop = neighbor_expand_bound(*args, **kw)
    row, pm, vis = args[0], args[3], args[4]
    rec = dict(
        shape=f"row({row.shape[0]},{row.shape[1]}) {kw['strategy']} "
              f"m={kw['m']} m_beta={kw['m_beta']} pass_mask="
              f"{float(pm.float().mean()):.4f} visited="
              f"{float(vis.float().mean()):.5f}",
        max_abs_err=0.0,
        **time_in_turns(lambda: neighbor_expand_cuda(*args, **kw),
                        None if base is None else
                        lambda: base[1](*args, **kw), flush),
        plain_ms=time_ms(lambda: neighbor_expand_ref(*args, **kw),
                         ITERS // 5, flush),
        bound_ms=bound_ms, bound_by=by, library_ms=None,
        stop_mean=float(stop.float().mean()), stop_max=int(stop.max()),
        rounds_256_mean=float(((stop + 255) // 256).float().mean()),
        rounds_512_least_mean=float(((stop + 511) // 512).float().mean()))
    log("kernels", kernel="neighbor_expand", what=repr(what), **{
        k: repr(v) if isinstance(v, str) else v for k, v in rec.items()})
    return rec


def capture_hops(index, request) -> tuple:
    """Serve ``request`` (a forced graph-route request) with recording
    wrappers around ``repro_torch.core.search``'s ``neighbor_expand`` and
    ``gather_distance``, removed in a ``finally``.  Returns the arguments
    of the level-0 hops in HOPS (the calls that pass a visited set, copied
    before the search marks the hop's ids, and the ``gather_distance``
    call that follows each) and the request's level-0 hop count."""
    import torch
    from repro_torch.core import search
    expand, gather = search.neighbor_expand, search.gather_distance
    hops, state = [], {"hop": 0, "want": False}

    def rec_expand(row, tbl, pos, pm=None, vis=None, **kw):
        if vis is not None:          # only the level-0 beam passes visited
            state["hop"] += 1
            if state["hop"] in HOPS:
                hops.append([(row.clone(), tbl, pos, pm, vis.clone()),
                             dict(kw)])
                state["want"] = True
        return expand(row, tbl, pos, pm, vis, **kw)

    def rec_gather(ids, q, x, metric="l2"):
        if state["want"]:
            hops[-1].append((ids.clone(), q, x, metric))
            state["want"] = False
        return gather(ids, q, x, metric=metric)

    search.neighbor_expand, search.gather_distance = rec_expand, rec_gather
    try:
        index.search(request)
        torch.cuda.synchronize()
    finally:
        search.neighbor_expand, search.gather_distance = expand, gather
    return hops, state["hop"]


def check_expand(calls, what: str) -> int:
    """neighbor_expand bit for bit against its plain version on the card
    for each (row, tbl, pos, pm, vis, kw) of ``calls``, with and without
    the pass mask and the visited set; returns the number of calls
    checked."""
    import torch
    from repro_torch.kernels.neighbor_expand import (neighbor_expand_cuda,
                                                     neighbor_expand_ref)
    checked = 0
    for row, tbl, pos, pm, vis, kw in calls:
        for p_, v_ in ((None, None), (pm, None), (None, vis), (pm, vis)):
            got = neighbor_expand_cuda(row, tbl, pos, p_, v_, **kw)
            want = neighbor_expand_ref(row, tbl, pos, p_, v_, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"neighbor_expand {what} {kw} n_l={tbl.shape[0]} "
                    f"mask={p_ is not None} visited={v_ is not None}: "
                    f"{int((got != want).any(dim=1).sum())} lanes differ")
            checked += 1
    return checked


def expand_edge_calls(dev):
    """NE_EDGE_CASES as (row, tbl, pos, pm, vis, kw) on ``dev``."""
    import torch
    for ci, case in enumerate(NE_EDGE_CASES):
        yield (*(torch.from_numpy(a).to(dev)
                 for a in expand_edge_inputs(**case, seed=ci)),
               dict(strategy=case["strategy"], m=case["m"],
                    m_beta=case.get("m_beta", 0)))


def check_gather_edges(dev) -> float:
    """gather_distance against its plain version on the card at
    GD_EDGE_CASES, both metrics; returns the max |err|."""
    import torch
    from repro_torch.kernels.gather_distance import (gather_distance_cuda,
                                                     gather_distance_ref)
    err = 0.0
    for ci, case in enumerate(GD_EDGE_CASES):
        ids, q, x = (torch.from_numpy(a).to(dev)
                     for a in gather_edge_inputs(**case, seed=ci))
        for metric in ("l2", "ip"):
            got = gather_distance_cuda(ids, q, x, metric)
            torch.cuda.synchronize()
            err = max(err, assert_gather_close(
                got, gather_distance_ref(ids, q, x, metric),
                f"gather_distance edge case {case} {metric}"))
    return err


def filtered_topk_bound(q, x, mask, k: int, metric: str) -> dict:
    """What this call's data needs, each byte once: the mask (one byte per
    query and row), the rows that pass some query's mask (d floats each;
    a row no query passes need not be read), the queries and the (ids,
    dists) output; 2 d flops per passing (query, row) pair, plus 2 d per
    row read for |x|^2 under l2.  The dense figures (every row read and
    every pair scored) are returned beside it."""
    b, n = mask.shape
    d = x.shape[1]
    rows = int(mask.any(dim=0).sum())
    pairs = int(mask.sum())
    io = b * n + b * d * 4 + b * k * 8
    norms = 2 * d if metric == "l2" else 0
    need, by = bound(io + rows * d * 4, 2 * d * pairs + norms * rows)
    dense, dense_by = bound(io + n * d * 4, 2 * d * b * n + norms * n)
    return dict(bound_ms=need, bound_by=by, dense_bound_ms=dense,
                dense_bound_by=dense_by, rows_needed=rows)


def assert_topk_match(ids, dists, want_ids, want_dists, q, x, metric: str,
                      what: str, dist_atol: float = 1e-4) -> tuple:
    """Ids identical except at near ties (the two rows' scores, recomputed
    in float64, within NEAR_TIE_REL of the larger of the scores and, for
    l2, of |q|^2 + |x|^2, the scale of the expanded form's rounding);
    dists within rtol 1e-5 / ``dist_atol`` where the ids agree; padding
    (-1 ids, infinite dists and their signs) identical.  For l2 the
    absolute tolerance of a slot is at least 1e-6 (|q|^2 + |x|^2), as in
    tests/torch_parity.py: both versions compute the expanded form (the
    kernel |q|^2 - (2 q.x - |x|^2), the plain version |q|^2 + |x|^2 -
    2 q.x), so each rounds at the scale of |q|^2 + |x|^2, not of the
    distance.  Returns (max |err| of the finite dists, near ties)."""
    import torch
    ids, dists = ids.cpu(), dists.cpu()
    want_ids, want_dists = want_ids.cpu(), want_dists.cpu()
    inf = torch.isinf(want_dists)
    if not (torch.equal(ids < 0, want_ids < 0)
            and torch.equal(torch.isinf(dists), inf)
            and torch.equal(torch.sign(dists[inf]),
                            torch.sign(want_dists[inf]))):
        raise AssertionError(f"{what}: padding differs from the plain "
                             "version")
    diff = (ids != want_ids).nonzero().tolist()
    if len(diff) > 1000:
        raise AssertionError(f"{what}: {len(diff)} ids differ")
    for qi, j in diff:
        a, b = int(ids[qi, j]), int(want_ids[qi, j])
        qv = q[qi].double().cpu()
        xa, xb = x[a].double().cpu(), x[b].double().cpu()
        if metric == "l2":
            da, db = float(((xa - qv) ** 2).sum()), float(((xb - qv) ** 2)
                                                          .sum())
            scale = float(qv @ qv) + max(float(xa @ xa), float(xb @ xb))
        else:
            da, db = float(xa @ qv), float(xb @ qv)
            scale = 0.0
        if abs(da - db) > NEAR_TIE_REL * max(abs(da), abs(db), scale):
            raise AssertionError(f"{what}: query {qi} slot {j} ids {a} vs "
                                 f"{b}, scores {da} vs {db} are not a near "
                                 "tie")
    same = (ids == want_ids) & ~inf
    atol = torch.full(dists.shape, dist_atol, dtype=torch.float64)
    if metric == "l2":
        rows = x[ids.clamp(min=0).long().to(x.device)].double()
        scale = (q.double() ** 2).sum(dim=1)[:, None] + (rows ** 2).sum(-1)
        atol = torch.maximum(atol, 1e-6 * scale.cpu())
    gap = (dists.double() - want_dists.double()).abs()
    err = float(gap[same].max()) if bool(same.any()) else 0.0
    if not bool((gap <= atol + 1e-5 * want_dists.double().abs())[same]
                .all()):
        raise AssertionError(f"{what}: dists disagree (max |err| {err})")
    return err, len(diff)


def topk_inputs(b, n, d, p=0.5, seed=0, dup=False, empty_rows=False,
                ints=False, period=None, tail=None, few=None,
                last_row=False):
    """(q, x, mask) numpy arrays of an edge case, as
    tests/test_torch_filtered_topk.py draws them."""
    rng = np.random.default_rng(seed)
    if ints:
        q = rng.integers(-64, 65, size=(b, d)).astype(np.float32)
        x = rng.integers(-64, 65, size=(n, d)).astype(np.float32)
    else:
        q = rng.normal(size=(b, d)).astype(np.float32)
        x = rng.normal(size=(n, d)).astype(np.float32)
    if dup:   # blocks of identical rows: the tie order decides
        x = x[np.arange(n) // 7]
    mask = rng.random((b, n)) < p
    if empty_rows:
        mask[0, :] = False                      # nothing passes
        if b > 1:
            mask[1, :] = False
            mask[1, n - n // 8:] = True         # only the last rows pass
    if period:   # x repeats every `period` rows: every tile scores the same
        x = x[np.arange(n) % period]
    if tail:     # nothing passes before the last `tail` rows
        mask[:, :n - tail] = False
    if few:      # exactly `few` rows pass per query, anywhere
        mask[:] = False
        for row in mask:
            row[rng.choice(n, few, replace=False)] = True
    if last_row:
        mask[:, -1] = True
    return q, x, mask


def check_filtered_topk_edges(dev) -> int:
    """The kernel against its plain version on the card at
    TOPK_EDGE_CASES, both metrics; returns the near ties."""
    import torch
    from repro_torch.kernels.filtered_topk import (filtered_topk_cuda,
                                                   filtered_topk_ref)
    from repro_torch.kernels.filtered_topk.kernel import KMAX
    ties = 0
    for ci, case in enumerate(TOPK_EDGE_CASES):
        kw = dict(case)
        k = kw.pop("k")
        q, x, mask = (torch.from_numpy(a).to(dev)
                      for a in topk_inputs(**kw, seed=ci))
        for metric in ("l2", "ip"):
            got = filtered_topk_cuda(q, x, mask, k, metric)
            want = filtered_topk_ref(q, x, mask, k, metric)
            torch.cuda.synchronize()
            ties += assert_topk_match(*got, *want, q, x, metric,
                                      f"filtered_topk {case} {metric}")[1]
    q, x, mask = (torch.from_numpy(a).to(dev) for a in topk_inputs(1, 300, 4))
    try:
        filtered_topk_cuda(q, x, mask, KMAX + 1, "ip")
    except ValueError:
        pass
    else:
        raise AssertionError(f"filtered_topk_cuda took k = {KMAX + 1} > "
                             "its cap")
    log("kernels", kernel="filtered_topk", edge_cases=len(TOPK_EDGE_CASES) * 2,
        near_ties=ties, k_above_cap_raises=True)
    return ties


def measure_filtered_topk(q, x, mask, k: int, metric: str, flush, base,
                          what: str) -> dict:
    """Kernel (and the baseline kernel, if given) vs plain version on the
    card, then the kernel (in turns with the baseline), the plain version
    and the library yardstick timed with a cold L2."""
    import torch
    from repro_torch.kernels.filtered_topk import (filtered_topk_cuda,
                                                   filtered_topk_ref)
    got = filtered_topk_cuda(q, x, mask, k, metric)
    want = filtered_topk_ref(q, x, mask, k, metric)
    torch.cuda.synchronize()
    err, ties = assert_topk_match(*got, *want, q, x, metric, what)
    if base is not None:
        assert_topk_match(*base[2](q, x, mask, k, metric), *want, q, x,
                          metric, what + " (baseline)")
    neg = float("-inf")
    if metric == "ip":
        library = lambda: torch.topk(torch.where(mask, q @ x.T, neg), k)  # noqa: E731
        calls = "torch.topk(torch.where(mask, q @ x.T, -inf), k): 3 calls"
    else:
        library = lambda: torch.topk(  # noqa: E731
            torch.where(mask, -torch.cdist(q, x), neg), k)
        calls = ("torch.topk(torch.where(mask, -torch.cdist(q, x), -inf), "
                 "k): 4 calls")
    rec = dict(
        shape=f"q({q.shape[0]},{q.shape[1]}) x({x.shape[0]},{x.shape[1]}) "
              f"k={k} {metric} mask_density={float(mask.float().mean()):.4f}",
        max_abs_err=err, near_ties=ties,
        **time_in_turns(lambda: filtered_topk_cuda(q, x, mask, k, metric),
                        None if base is None else
                        lambda: base[2](q, x, mask, k, metric), flush),
        plain_ms=time_ms(lambda: filtered_topk_ref(q, x, mask, k, metric),
                         ITERS // 5, flush),
        library_ms=time_ms(library, ITERS // 5, flush), library_calls=calls,
        **filtered_topk_bound(q, x, mask, k, metric))
    log("kernels", kernel="filtered_topk", **{
        key: repr(v) if isinstance(v, str) else v for key, v in rec.items()})
    return rec


# the port's kernels by name, as the profiler reports their device time
PORT_KERNELS = ("neighbor_expand", "gather_distance", "filtered_topk",
                "pna_aggregate", "embedding_bag")


def profile_call(fn, **labels) -> tuple:
    """Trace one call of ``fn`` (a request); print its wall time, the
    device's busy time and idle share, the device time and the number of
    device kernel launches of each of the port's kernels, and the heaviest
    kernels; return the last two as dicts by kernel name (ms, launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us, dev_n, host_us = {}, {}, {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_us[ev.key] = dev_us.get(ev.key, 0) + us
            dev_n[ev.key] = dev_n.get(ev.key, 0) + ev.count
        elif ev.self_cpu_time_total > 0:
            host_us[ev.key] = ev.self_cpu_time_total
    busy_ms = sum(dev_us.values()) / 1e3
    port_ms = {name: round(sum(v for k, v in dev_us.items() if name in k)
                           / 1e3, 4) for name in PORT_KERNELS}
    port_n = {name: sum(v for k, v in dev_n.items() if name in k)
              for name in PORT_KERNELS}
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    top_host = sorted(host_us.items(), key=lambda kv: -kv[1])[:8]
    log("profile", **labels, wall_ms=f"{wall_ms:.3f}",
        device_busy_ms=f"{busy_ms:.3f}",
        idle_share=f"{1 - busy_ms / wall_ms:.3f}" if busy_ms else
        "not_measured",
        port_kernel_ms={k: v for k, v in port_ms.items() if v},
        port_kernel_launches={k: v for k, v in port_n.items() if v},
        port_kernel_ms_per_launch={
            k: round(v / port_n[k], 5) for k, v in port_ms.items()
            if v and port_n[k]},
        top_ms=[(k[:48], round(v / 1e3, 4)) for k, v in top],
        top_host_ms=[(k[:40], round(v / 1e3, 4)) for k, v in top_host])
    return port_ms, port_n


def retrieve_phases(dev, flush, profile: bool, base) -> tuple:
    """The two-tower ``retrieval_cand`` path at FULL width, its kernel
    check (timed in turns with the baseline kernel, if given), the counted
    requests, ``serve_p99`` and the CPU parity; returns filtered_topk's
    record and the model."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.two_tower_retrieval import TOPK
    from repro_torch.convert import table_from_arrays
    from repro_torch.core import (Equals, compile_predicates,
                                  evaluate_program, pack_columns, regex_aux)
    from repro_torch.kernels.filtered_topk import filtered_topk_cuda
    from repro_torch.models.recsys import TwoTower, set_two_tower_params

    arch = get_arch("two-tower-retrieval")
    cfg = arch.config()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = arch.init(cfg, torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cand = torch.cat([model.item_embed(torch.arange(
        s, min(s + CAND_CHUNK, N_CAND), dtype=torch.int32, device=dev))
        for s in range(0, N_CAND, CAND_CHUNK)])
    torch.cuda.synchronize()
    cand_s = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    category = rng.integers(0, CATEGORIES, size=N_CAND).astype(np.int32)
    rare = rng.choice(N_CAND, RARE_ITEMS, replace=False)
    category[rare] = RARE_VALUE
    table = table_from_arrays({"category": category}, device=dev)
    values = rng.integers(0, CATEGORIES, size=RETRIEVE_REQUESTS)
    values[RARE_AT] = RARE_VALUE
    n_feats = cfg.n_user_feats
    batches = [{
        "user_id": torch.as_tensor(rng.integers(0, cfg.n_users, size=1),
                                   dtype=torch.int32, device=dev),
        "user_feats": torch.as_tensor(
            rng.integers(0, cfg.n_users, size=(1, n_feats)),
            dtype=torch.int32, device=dev),
        "item_id": torch.as_tensor(rng.integers(0, cfg.n_items, size=1),
                                   dtype=torch.int32, device=dev),
        "logq": torch.zeros(1, device=dev)} for _ in values]
    preds = [Equals("category", int(v)) for v in values]
    step = arch.step_fn(cfg, "retrieval_cand")
    log("retrieve", users=cfg.n_users, items=cfg.n_items,
        embed_dim=cfg.embed_dim, towers=cfg.tower_dims, candidates=N_CAND,
        k=TOPK, init_s=f"{init_s:.3f}", cand_embed_s=f"{cand_s:.3f}",
        memory_allocated=torch.cuda.memory_allocated() - mem0)

    def mask_of(pred, tbl):
        prog = compile_predicates([pred], tbl)
        cols = pack_columns(tbl, prog.schema)
        return evaluate_program(prog, cols.ints, cols.bitsets,
                                regex_aux(tbl, prog.regex_leaves))

    def request(i):
        return step(model, batches[i], cand, mask_of(preds[i], table))

    def timed_request(i):
        """The request, as ``request``, synchronised after each part of the
        mask (``compile_predicates``; ``pack_columns`` and ``regex_aux``;
        ``evaluate_program``) and after the step: (result, seconds of the
        whole, of the mask, of the step, of the three mask parts)."""
        t0 = time.perf_counter()
        prog = compile_predicates([preds[i]], table)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cols = pack_columns(table, prog.schema)
        aux = regex_aux(table, prog.regex_leaves)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        mask = evaluate_program(prog, cols.ints, cols.bitsets, aux)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        res = step(model, batches[i], cand, mask)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        return res, (t4 - t0, t3 - t0, t4 - t3, t1 - t0, t2 - t1, t3 - t2)

    # the kernel against its plain version at the path's shape
    u = model.user_embed(batches[0]).contiguous()
    rec = measure_filtered_topk(u, cand, mask_of(preds[0], table), TOPK,
                                "ip", flush, base,
                                "filtered_topk retrieval_cand")

    # the main path: counters zeroed just before the requests, read after
    for i in range(WARMUP_REQUESTS):
        request(i)
    torch.cuda.synchronize()
    counters = all_launchers()
    for fn in counters:
        fn.launches = 0
    results, seconds = [], []
    for i in range(RETRIEVE_REQUESTS):
        res, secs = timed_request(i)
        seconds.append(secs)
        results.append(res)
    launches = filtered_topk_cuda.launches
    others = sum(fn.launches for fn in counters) - launches
    ms, mask_ms, step_ms, compile_ms, pack_ms, eval_ms = (
        np.array(v) * 1e3 for v in zip(*seconds))
    log("retrieve", requests=RETRIEVE_REQUESTS,
        p50_ms=f"{np.percentile(ms, 50):.4f}",
        p99_ms=f"{np.percentile(ms, 99):.4f}",
        requests_per_s=f"{RETRIEVE_REQUESTS / ms.sum() * 1e3:.2f}",
        mask_p50_ms=f"{np.percentile(mask_ms, 50):.4f}",
        step_p50_ms=f"{np.percentile(step_ms, 50):.4f}",
        compile_p50_ms=f"{np.percentile(compile_ms, 50):.4f}",
        pack_p50_ms=f"{np.percentile(pack_ms, 50):.4f}",
        evaluate_p50_ms=f"{np.percentile(eval_ms, 50):.4f}",
        request_ms=[round(float(v), 3) for v in ms],
        peak_memory_over_start=torch.cuda.max_memory_allocated() - mem0,
        filtered_topk_launches=launches, other_kernel_launches=others)
    if launches < RETRIEVE_REQUESTS:
        raise AssertionError(f"filtered_topk launched {launches} times in "
                             f"{RETRIEVE_REQUESTS} requests")
    cat_t = torch.as_tensor(category, device=dev)
    for v, (ids, scores) in zip(values, results):
        if ids.shape != (1, TOPK) or not bool(
                (cat_t[ids[ids >= 0].long()] == int(v)).all()):
            raise AssertionError("a retrieved item fails its predicate")
    ids, scores = results[RARE_AT]
    if not (set(ids[0, :RARE_ITEMS].tolist()) == set(rare.tolist())
            and bool((ids[0, RARE_ITEMS:] == -1).all())
            and bool((scores[0, RARE_ITEMS:] == float("-inf")).all())
            and bool(torch.isfinite(scores[0, :RARE_ITEMS]).all())):
        raise AssertionError("rare request: not its 37 items followed by "
                             "-1 / -inf padding")
    if profile:
        profile_call(lambda: request(0), path="retrieval_cand")

    serve = arch.step_fn(cfg, "serve_p99")
    sb = {"user_id": torch.as_tensor(
              rng.integers(0, cfg.n_users, size=SERVE_BATCH),
              dtype=torch.int32, device=dev),
          "user_feats": torch.as_tensor(
              rng.integers(0, cfg.n_users, size=(SERVE_BATCH, n_feats)),
              dtype=torch.int32, device=dev),
          "item_id": torch.as_tensor(
              rng.integers(0, cfg.n_items, size=SERVE_BATCH),
              dtype=torch.int32, device=dev),
          "logq": torch.zeros(SERVE_BATCH, device=dev)}
    serve(model, sb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = serve(model, sb)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    if out.shape != (SERVE_BATCH,) or not bool(torch.isfinite(out).all()):
        raise AssertionError("serve_p99 scores not finite of shape (512,)")
    log("retrieve", serve_p99_batch=SERVE_BATCH, serve_ms=f"{serve_ms:.4f}")

    # parity: the same requests on a CPU copy (plain versions)
    t0 = time.perf_counter()
    cpu_model = set_two_tower_params(
        TwoTower(cfg), model.user_emb.cpu(),
        model.item_emb.cpu(),
        [[(lin.weight.cpu(), lin.bias.cpu()) for lin in tower]
         for tower in (model.user_tower, model.item_tower)])
    cand_cpu = cand.cpu()
    table_cpu = table_from_arrays({"category": category}, device="cpu")
    sel = [RARE_AT] + [i for i in range(RETRIEVE_PARITY) if i != RARE_AT]
    ties, err = 0, 0.0
    for i in sel[:RETRIEVE_PARITY]:
        b_cpu = {k: v.cpu() for k, v in batches[i].items()}
        ids_h, s_h = step(cpu_model, b_cpu, cand_cpu,
                          mask_of(preds[i], table_cpu))
        u_h = cpu_model.user_embed(b_cpu)
        e, t = assert_topk_match(*results[i], ids_h, s_h, u_h, cand_cpu,
                                 "ip", f"retrieval request {i} card vs CPU",
                                 dist_atol=1e-5)
        ties, err = ties + t, max(err, e)
    log("parity", path="retrieval_cand", requests=RETRIEVE_PARITY,
        near_ties=ties, max_abs_err=err,
        seconds=f"{time.perf_counter() - t0:.1f}")

    # the mesh-explicit step (filtered_retrieval_step: matmul + top-k,
    # gathered over the mesh) on a one-rank mesh against retrieval_cand's
    # ids; it keeps a masked candidate's id beside a -inf score, where
    # filtered_topk pads with -1
    from repro_torch.launch.mesh import make_host_mesh
    mesh_step = arch.step_fn(cfg, "retrieval_cand", mesh=make_host_mesh())
    ties, err, mesh_ms = 0, 0.0, []
    for i in sel[:RETRIEVE_PARITY]:
        mask = mask_of(preds[i], table)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ids_m, s_m = mesh_step(model, batches[i], cand, mask, 0)
        torch.cuda.synchronize()
        mesh_ms.append((time.perf_counter() - t1) * 1e3)
        ids_m = torch.where(torch.isfinite(s_m), ids_m,
                            torch.full_like(ids_m, -1))
        e, t = assert_topk_match(ids_m, s_m, *results[i],
                                 model.user_embed(batches[i]), cand, "ip",
                                 f"retrieval request {i} mesh step vs "
                                 "retrieval_cand", dist_atol=1e-5)
        ties, err = ties + t, max(err, e)
    log("mesh", path="filtered_retrieval_step", mesh="1x1",
        requests=RETRIEVE_PARITY, candidates=N_CAND, k=TOPK,
        step_p50_ms=f"{np.percentile(mesh_ms, 50):.4f}",
        near_ties_vs_retrieval_cand=ties, max_abs_err=err)
    rec.update(launches=launches, name="filtered_topk", route="cuda",
               source="src/repro_torch/csrc/filtered_topk.cu",
               replaces="src/repro/kernels/filtered_topk/kernel.py:71")
    return rec, model


def molecule_graphs(b, n, d_in, seed, min_nodes=None, undirected_edges=32):
    """(adj (b, n, n), feats (b, n, d_in)) float32 numpy: molecule-like
    graphs padded to n nodes, as tests/torch_parity.py draws them.  Each
    has between ``min_nodes`` (n // 3) and n real nodes joined by a random
    spanning tree plus random ring closures up to ``undirected_edges``
    edges, symmetric, no self-loops; real nodes get normal features,
    padding nodes zeros and no edges."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((b, n, n), np.float32)
    feats = np.zeros((b, n, d_in), np.float32)
    lo = max(1, n // 3 if min_nodes is None else min_nodes)
    for g in range(b):
        k = int(rng.integers(lo, n + 1))
        for v in range(1, k):
            u = int(rng.integers(0, v))
            adj[g, u, v] = adj[g, v, u] = 1.0
        iu, ju = np.triu_indices(k, 1)
        free = np.nonzero(adj[g, iu, ju] == 0)[0]
        extra = min(len(free), max(0, undirected_edges - (k - 1)))
        pick = rng.choice(free, size=extra, replace=False)
        adj[g, iu[pick], ju[pick]] = adj[g, ju[pick], iu[pick]] = 1.0
        feats[g, :k] = rng.normal(size=(k, d_in))
    return adj, feats


def pna_inputs(b, n, f, kind="random", seed=0):
    """(adj, feats) numpy of a pna_aggregate edge case, as
    tests/test_torch_pna_aggregate.py draws them."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, n, f)).astype(np.float32)
    if kind == "random":
        adj = (rng.random((b, n, n)) < 0.3).astype(np.float32)
    elif kind == "zero":                 # every node isolated
        adj = np.zeros((b, n, n), np.float32)
    elif kind == "full":                 # complete, with self-loops
        adj = np.ones((b, n, n), np.float32)
    elif kind == "constant":             # std cancellation: equal values
        adj = (rng.random((b, n, n)) < 0.5).astype(np.float32)
        feats = np.full((b, n, f), 1.7, np.float32)
    elif kind == "molecule":             # padded with isolated nodes
        adj, feats = molecule_graphs(b, n, f, seed, min_nodes=n // 2)
    elif kind == "weighted":             # any finite edge weight
        adj = rng.choice(np.array(PNA_WEIGHTS, np.float32), size=(b, n, n))
    else:
        raise ValueError(kind)
    return adj, feats


def assert_pna_blocks(got, want, f: int, what: str) -> float:
    """``[mean | max | min | std]`` against the plain version: max and min
    identical, mean within rtol 1e-5 / atol 1e-6 (sums in another order),
    std within atol 2e-3 (the reference's tolerance for the block: its
    ssq / cnt - mean^2 cancels, up to ~sqrt(eps) |h| for a node of degree
    1).  Returns the largest |err|."""
    import torch
    got, want = got.cpu(), want.cpu()
    mean, mx, mn, sd = (slice(k * f, (k + 1) * f) for k in range(4))
    if not (got.shape == want.shape
            and torch.equal(got[..., mx], want[..., mx])
            and torch.equal(got[..., mn], want[..., mn])
            and torch.allclose(got[..., mean], want[..., mean], rtol=1e-5,
                               atol=1e-6)
            and bool(((got[..., sd] - want[..., sd]).abs() <= 2e-3).all())):
        raise AssertionError(f"{what}: disagrees with the plain version")
    return float((got - want).abs().max())


def pna_aggregate_bound(adj, feats) -> tuple:
    """Bytes: adj and feats read once, the (B, N, 4F) output written once.
    Operations: 7 per (edge, feature) of this adjacency (h^2, two fused
    multiply-adds, max, min)."""
    b, n, f = feats.shape
    byts = 4 * (adj.numel() + feats.numel() + b * n * 4 * f)
    return bound(byts, 7 * int((adj > 0).sum()) * f)


def measure_pna_aggregate(adj, feats, flush, base, floor_ms: float,
                          what: str) -> dict:
    """Kernel (and the baseline kernel, if given) vs plain version on the
    card, then the kernel (in turns with the baseline) and the plain
    version timed with a cold L2, the launch floor beside them.  No
    PyTorch call computes the function: no library figure."""
    import torch
    from repro_torch.kernels.pna_aggregate import (pna_aggregate_cuda,
                                                   pna_aggregate_ref)
    got = pna_aggregate_cuda(adj, feats)
    want = pna_aggregate_ref(adj, feats)
    torch.cuda.synchronize()
    err = assert_pna_blocks(got, want, feats.shape[2], what)
    same = {}
    if base is not None:
        old = base[3](adj, feats)
        assert_pna_blocks(old, want, feats.shape[2], what + " (baseline)")
        same = dict(bit_identical_to_baseline=bool(torch.equal(got, old)))
        del old
    del got, want
    b, n, f = feats.shape
    bound_ms, bound_by = pna_aggregate_bound(adj, feats)
    rec = dict(
        shape=f"adj({b},{n},{n}) feats({b},{n},{f}) "
              f"edges={int((adj > 0).sum())}",
        max_abs_err=err, **same,
        **time_in_turns(lambda: pna_aggregate_cuda(adj, feats),
                        None if base is None else
                        lambda: base[3](adj, feats), flush),
        launch_floor_ms=floor_ms,
        plain_ms=time_ms(lambda: pna_aggregate_ref(adj, feats), ITERS // 5,
                         flush),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        library_calls="none (no PyTorch call computes it)")
    log("kernels", kernel="pna_aggregate", **{
        key: repr(v) if isinstance(v, str) else v for key, v in rec.items()})
    return rec


def pna_phases(dev, flush, profile: bool, base, floor_ms: float) -> dict:
    """PNA's dense-batched inference at the ``molecule`` shape: the
    kernel's checks and times (in turns with the baseline kernel, if
    given), the counted requests and the CPU parity; returns
    pna_aggregate's record."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.pna import PNA_SHAPES
    from repro_torch.kernels.pna_aggregate import (pna_aggregate_cuda,
                                                   pna_aggregate_ref)
    from repro_torch.models.gnn import PNA, forward_dense, set_pna_params

    worst = 0.0
    for ci, case in enumerate(PNA_EDGE_CASES):
        adj, feats = (torch.from_numpy(a).to(dev)
                      for a in pna_inputs(**case, seed=ci))
        got = pna_aggregate_cuda(adj, feats)
        want = pna_aggregate_ref(adj, feats)
        torch.cuda.synchronize()
        worst = max(worst, assert_pna_blocks(got, want, case["f"],
                                             f"pna_aggregate {case}"))
    try:
        pna_aggregate_cuda(adj, feats.clone().requires_grad_())
    except NotImplementedError:
        pass
    else:
        raise AssertionError("pna_aggregate_cuda ran under autograd without "
                             "a backward")
    log("kernels", kernel="pna_aggregate", edge_cases=len(PNA_EDGE_CASES),
        max_abs_err=worst, autograd_raises=True)

    arch = get_arch("pna")
    cfg = arch.config(shape="molecule")
    spec = PNA_SHAPES["molecule"]
    b, n = spec["batch"], spec["n_nodes"]
    t0 = time.perf_counter()
    model = arch.init(cfg, torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    adj_np, feats_np = molecule_graphs(PNA_REQUESTS * b, n, cfg.d_in, seed=4)
    data_s = time.perf_counter() - t0
    adj = torch.from_numpy(adj_np).to(dev).view(PNA_REQUESTS, b, n, n)
    feats = torch.from_numpy(feats_np).to(dev).view(PNA_REQUESTS, b, n,
                                                    cfg.d_in)
    log("pna", layers=cfg.n_layers, d_in=cfg.d_in, d_hidden=cfg.d_hidden,
        classes=cfg.n_classes, batch=b, n_nodes=n, requests=PNA_REQUESTS,
        directed_edges_per_graph=float(adj_np.sum() / len(adj_np)),
        real_nodes_per_graph=float((np.abs(feats_np).sum(-1) > 0).sum()
                                   / len(adj_np)),
        init_s=f"{init_s:.3f}", graphs_s=f"{data_s:.3f}")

    # the kernel at the path's shape (layer 0's messages of request 0) and
    # at the bulk shape (the requests' graphs, twice over)
    def messages(f):
        return torch.relu(f @ model.enc) @ model.layers[0].w_msg

    rec = measure_pna_aggregate(adj[0], messages(feats[0]), flush, base,
                                floor_ms, "pna_aggregate path shape")
    reps = PNA_BULK_GRAPHS // (PNA_REQUESTS * b)
    bulk = measure_pna_aggregate(
        adj.reshape(-1, n, n).repeat(reps, 1, 1),
        messages(feats.reshape(-1, n, cfg.d_in)).repeat(reps, 1, 1), flush,
        base, floor_ms, "pna_aggregate bulk shape")

    # the main path: counters zeroed just before the requests, read after
    def request(r):
        return forward_dense(cfg, model, feats[r], adj[r])

    for r in range(PNA_WARMUP):
        request(r)
    torch.cuda.synchronize()
    counters = all_launchers()
    for fn in counters:
        fn.launches = 0
    logits, seconds = [], []
    for r in range(PNA_REQUESTS):
        t0 = time.perf_counter()
        out = request(r)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        logits.append(out)
    launches = pna_aggregate_cuda.launches
    others = sum(fn.launches for fn in counters) - launches
    ms = np.array(seconds) * 1e3
    log("pna", requests=PNA_REQUESTS, graphs_per_request=b,
        p50_ms=f"{np.percentile(ms, 50):.4f}",
        p99_ms=f"{np.percentile(ms, 99):.4f}",
        graphs_per_s=f"{PNA_REQUESTS * b / ms.sum() * 1e3:.1f}",
        request_ms=[round(float(v), 3) for v in ms],
        pna_aggregate_launches=launches, other_kernel_launches=others)
    if launches != cfg.n_layers * PNA_REQUESTS:
        raise AssertionError(f"pna_aggregate launched {launches} times in "
                             f"{PNA_REQUESTS} requests of {cfg.n_layers} "
                             "layers")
    for out in logits:
        if out.shape != (b, cfg.n_classes) or not bool(
                torch.isfinite(out).all()):
            raise AssertionError("PNA logits not finite of shape "
                                 f"({b}, {cfg.n_classes})")
    if profile:
        dev_ms, dev_n = profile_call(lambda: request(0), path="pna_molecule")
        log("pna", traced_requests=1,
            pna_aggregate_device_launches=dev_n["pna_aggregate"],
            pna_aggregate_device_ms=dev_ms["pna_aggregate"])

    # parity: the same requests on a CPU copy (plain versions)
    cpu = set_pna_params(PNA(cfg), model.enc.cpu(), model.dec.cpu(),
                         [(lp.w_msg.cpu(), lp.w_upd.cpu())
                          for lp in model.layers])
    err = 0.0
    for r in range(PNA_PARITY):
        want = forward_dense(cfg, cpu, feats[r].cpu(), adj[r].cpu())
        e = float((logits[r].cpu() - want).abs().max())
        if not e <= PNA_LOGITS_ATOL:
            raise AssertionError(f"PNA request {r}: card vs CPU logits "
                                 f"differ by {e}")
        err = max(err, e)
    log("parity", path="pna_molecule", requests=PNA_PARITY,
        max_abs_err=err, atol=PNA_LOGITS_ATOL)
    rec.update(launches=launches, name="pna_aggregate", route="cuda",
               source="src/repro_torch/csrc/pna_aggregate.cu",
               replaces="src/repro/kernels/pna_aggregate/kernel.py:46",
               kernel_ms=rec["ms"], other_shapes=[bulk])
    return rec


def bag_inputs(b, l, v, d, kind="random", seed=0):
    """(ids, table, upstream grad) numpy of an embedding_bag edge case, as
    tests/test_torch_embedding_bag.py draws them."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, v, size=(b, l))
    if kind == "padding":                 # every bag empty
        ids = np.full((b, l), -1)
    elif kind == "clip":                  # ids >= V read row V-1, counted
        ids = rng.integers(-1, v + 5, size=(b, l))
        ids[0, :] = v + 2
    elif kind == "dup":                   # repeated ids inside a bag
        ids = rng.integers(0, 3, size=(b, l))
    elif kind != "random":
        raise ValueError(kind)
    table = rng.normal(size=(v, d)).astype(np.float32)
    g = rng.normal(size=(b, d)).astype(np.float32)
    return ids.astype(np.int32), table, g


def assert_bag_close(got, want, what: str) -> float:
    """Within rtol / atol 1e-5 (the rows of a bag, or the gradient's
    scatter-adds, in another order); returns the largest |err|."""
    import torch
    got, want = got.detach().cpu(), want.detach().cpu()
    if got.shape != want.shape or not torch.allclose(got, want, **BAG_TOL):
        raise AssertionError(f"{what}: disagrees with the plain version")
    return float((got - want).abs().max()) if got.numel() else 0.0


def embedding_bag_bound(ids, table, mode: str) -> tuple:
    """Bytes: each distinct row the valid ids name (clipped) read once, the
    ids, and the (B, D) output written once.  Operations: one add per
    valid id and column, plus a division per output under mean."""
    v, d = table.shape
    valid = ids[ids >= 0]
    rows = int(valid.clamp(max=v - 1).unique().numel())
    byts = rows * d * 4 + ids.numel() * 4 + ids.shape[0] * d * 4
    ops = int(valid.numel()) * d + (ids.shape[0] * d if mode == "mean" else 0)
    return bound(byts, ops)


def measure_embedding_bag(ids, table, mode: str, flush) -> dict:
    """Kernel vs plain version on the card, then the kernel, the plain
    version and (for sum) the library yardstick timed with a cold L2."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag import (embedding_bag_cuda,
                                                   embedding_bag_ref)
    b, l = ids.shape
    v, d = table.shape
    want = embedding_bag_ref(ids, table, mode)
    err = assert_bag_close(embedding_bag_cuda(ids, table, mode), want,
                           f"embedding_bag ({b}, {l}) {mode}")
    bound_ms, bound_by = embedding_bag_bound(ids, table, mode)
    rec = dict(
        shape=f"ids({b},{l}) table({v},{d}) {mode} "
              f"valid={float((ids >= 0).float().mean()):.4f}",
        max_abs_err=err,
        ms=time_ms(lambda: embedding_bag_cuda(ids, table, mode), ITERS,
                   flush),
        plain_ms=time_ms(lambda: embedding_bag_ref(ids, table, mode),
                         ITERS // 5, flush),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        library_calls="none for mean: F.embedding_bag's padding_idx drops "
                      "every id of a real row, not the -1 slots")
    if mode == "sum":
        safe, w = ids.clamp(0, v - 1).long(), (ids >= 0).float()

        def library():
            return F.embedding_bag(safe, table, mode="sum",
                                   per_sample_weights=w)
        rec.update(
            library_ms=time_ms(library, ITERS // 5, flush),
            library_max_abs_err=assert_bag_close(library(), want,
                                                 "F.embedding_bag"),
            library_calls="F.embedding_bag(ids.clamp(0, V-1), table, "
                          "mode='sum', per_sample_weights=(ids >= 0)"
                          ".float()): 1 call")
    log("kernels", kernel="embedding_bag", **{
        key: repr(v) if isinstance(v, str) else v for key, v in rec.items()})
    return rec


def bag_phases(dev, flush, table) -> dict:
    """The embedding_bag op over ``table`` (the two-tower FULL user
    table): the kernel's checks and times, the counted forward and
    gradient at the recsys shapes, and the CPU parity of the largest
    shape; returns embedding_bag's record."""
    import torch
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_cuda,
                                                   embedding_bag_ref)
    from repro_torch.kernels.embedding_bag.ref import MODES

    worst = 0.0
    for ci, case in enumerate(BAG_EDGE_CASES):
        ids, tab, _ = (torch.from_numpy(a).to(dev)
                       for a in bag_inputs(**case, seed=ci))
        for mode in MODES:
            worst = max(worst, assert_bag_close(
                embedding_bag_cuda(ids, tab, mode),
                embedding_bag_ref(ids, tab, mode),
                f"embedding_bag {case} {mode}"))
    for bad in ((ids.long(), tab), (ids, tab.double())):
        try:
            embedding_bag_cuda(*bad)
        except TypeError:
            pass
        else:
            raise AssertionError("embedding_bag_cuda took "
                                 f"{bad[0].dtype} ids, {bad[1].dtype} table")
    log("kernels", kernel="embedding_bag",
        edge_cases=len(BAG_EDGE_CASES) * len(MODES), max_abs_err=worst,
        other_dtypes_raise=True)

    v, d = table.shape
    rng = np.random.default_rng(5)
    inputs = []
    for b, l in BAG_SHAPES:
        ids = rng.integers(0, v, size=(b, l))
        ids[rng.random((b, l)) < BAG_PAD] = -1
        inputs.append(torch.as_tensor(ids.astype(np.int32), device=dev))
    recs = [measure_embedding_bag(ids, table, mode, flush)
            for ids in inputs for mode in MODES]

    # the main path: the op, forward and gradient, counters zeroed just
    # before and read just after; the largest shape against a CPU copy
    leaf = table.detach().requires_grad_()      # the same storage
    gen = torch.Generator(device=dev).manual_seed(6)
    grads_in = [torch.randn((ids.shape[0], d), generator=gen, device=dev)
                for ids in inputs]
    table_cpu = table.cpu()
    # warm-up: the first backward allocates the 4.29 GB gradient
    t0 = time.perf_counter()
    torch.autograd.grad(embedding_bag(inputs[0], leaf), leaf, grads_in[0])
    torch.cuda.synchronize()
    warmup_ms = (time.perf_counter() - t0) * 1e3
    counters = all_launchers()
    for fn in counters:
        fn.launches = 0
    timings, kept = [], []
    for ids, g in zip(inputs, grads_in):
        for mode in MODES:
            t0 = time.perf_counter()
            out = embedding_bag(ids, leaf, mode)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            (grad,) = torch.autograd.grad(out, leaf, g)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            timings.append((tuple(ids.shape), mode, round((t1 - t0) * 1e3, 4),
                            round((t2 - t1) * 1e3, 4)))
            if ids is inputs[-1]:
                kept.append((ids, g, mode, out, grad))
    launches = embedding_bag_cuda.launches
    others = sum(fn.launches for fn in counters) - launches
    log("bag", table=(v, d), shapes=BAG_SHAPES, padding=BAG_PAD,
        warmup_fwd_bwd_ms=round(warmup_ms, 3), op_fwd_bwd_ms=timings,
        embedding_bag_launches=launches,
        other_kernel_launches=others)
    if launches != len(BAG_SHAPES) * len(MODES):
        raise AssertionError(f"embedding_bag launched {launches} times in "
                             f"{len(BAG_SHAPES) * len(MODES)} op calls")
    parity_err = 0.0
    for ids, g, mode, out, grad in kept:
        tc = table_cpu.detach().requires_grad_()
        out_h = embedding_bag(ids.cpu(), tc, mode)
        (grad_h,) = torch.autograd.grad(out_h, tc, g.cpu())
        rows = ids[ids >= 0].clamp(max=v - 1).unique().long()
        what = f"embedding_bag {tuple(ids.shape)} {mode} card vs CPU"
        parity_err = max(parity_err, assert_bag_close(out, out_h, what),
                         assert_bag_close(grad[rows], grad_h[rows.cpu()],
                                          what + " gradient"))
        if bool(grad.index_fill_(0, rows, 0.0).any()):
            raise AssertionError(f"{what}: gradient outside the bags' rows")
    del kept
    log("parity", path="embedding_bag", shape=tuple(inputs[-1].shape),
        modes=MODES, max_abs_err=parity_err)
    rec = recs[0]
    rec.update(launches=launches, name="embedding_bag", route="cuda",
               source="src/repro_torch/csrc/embedding_bag.cu",
               replaces="src/repro/kernels/embedding_bag/kernel.py:56",
               kernel_ms=rec["ms"], other_shapes=recs[1:])
    return rec


def sync(dev) -> None:
    """Wait for ``dev`` (a no-op on the CPU)."""
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def engine_workloads(ds, n_closed: int = ENGINE_CLOSED,
                     n_kind: int = ENGINE_KIND_QUERIES) -> tuple:
    """The engine phase's workloads over the HCPS dataset ``ds``, as
    ``repro_torch.data.make_workload`` draws them: the closed loop's
    ``contains`` queries (correlation none, seed 1) and one workload of
    each of ENGINE_KINDS (seed 2); returns (closed, {name: workload})."""
    from repro_torch.data import make_workload
    closed = make_workload(ds, kind="contains", n_queries=n_closed,
                           k=ENGINE_K, seed=1)
    kinds = {}
    for kind, cor in ENGINE_KINDS:
        wl = make_workload(ds, kind=kind, correlation=cor, n_queries=n_kind,
                           k=ENGINE_K, seed=2)
        kinds[wl.name] = wl
    return closed, kinds


def open_loop_arrivals(n_requests: int, rate: float, seed: int = 0):
    """Seeded Poisson arrival times (seconds from the start) of
    ``n_requests`` requests at ``rate`` requests/s, drawn as
    ``repro_torch.launch.serve`` draws them."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n_requests))


def corpus_masks(engine, program):
    """(B, n) pass-masks over the engine's whole corpus: each shard's
    masks side by side (the shards hold contiguous rows in order), so
    regex leaves reuse each shard's cached bitmaps."""
    import torch
    return torch.cat([program.evaluate(s.index.table)
                      for s in engine.shards], dim=1)


def check_served(res, masks, what: str) -> dict:
    """Every returned id passes its query's predicate and has a finite
    distance; returns the route split."""
    import torch
    ids = res.ids
    valid = ids >= 0
    passes = torch.gather(masks, 1, ids.clamp(min=0).long())
    if not bool((passes | ~valid).all()):
        raise AssertionError(f"{what}: a returned id fails its predicate")
    if not torch.equal(torch.isfinite(res.dists), valid):
        raise AssertionError(f"{what}: -1 ids and infinite dists disagree")
    return {str(r): int((res.routes == r).sum())
            for r in sorted(set(res.routes))}


def route_recall(res, gt) -> dict:
    """recall@k of ``res`` against ``gt`` on each route that served a
    query (``mixed``: the shards' sketches chose both)."""
    import torch
    from repro_torch.core import recall_at_k
    out = {}
    for route in ("graph", "prefilter", "mixed"):
        sel = np.nonzero(res.routes == route)[0]
        if len(sel):
            t = torch.as_tensor(sel, device=res.ids.device)
            out[route] = round(recall_at_k(res.ids[t], gt[t]), 4)
    return out


def graph_sweep(engine, xq, program, gt, cluster_of) -> dict:
    """recall@k of the first ENGINE_SWEEP_QUERIES queries, each forced onto
    the graph route, at every ef of ENGINE_EF_SWEEP, and the mean count of
    generator clusters among their exact top-k (``gt_clusters``)."""
    from repro_torch.core import SearchRequest, recall_at_k
    q = min(ENGINE_SWEEP_QUERIES, xq.shape[0])
    out = {}
    for ef in ENGINE_EF_SWEEP:
        r = engine.serve(SearchRequest(xq=xq[:q],
                                       predicates=program.take(slice(0, q)),
                                       k=ENGINE_K, ef=ef, route="graph"))
        out[f"ef{ef}"] = round(recall_at_k(r.ids, gt[:q]), 4)
    out["gt_clusters"] = round(float(np.mean(
        [len(np.unique(cluster_of[g[g >= 0]]))
         for g in gt[:q].cpu().numpy()])), 3)
    return out


def engine_build(dev, n: int = ENGINE_N, d: int = ENGINE_D) -> tuple:
    """The HCPS corpus and the launcher's engine over it on ``dev``:
    ``make_hcps_dataset(n, d, seed=0)`` (its default 4,096 clusters at
    n = 2^20, 3 keywords a cluster, 30 keywords, 120 dates),
    ``EngineConfig(batch_size=32, k=10, n_shards=4)`` and
    ``AcornConfig(M=16, gamma=12, m_beta=32, ef_search=96)``; logs the
    data and build seconds, peak memory and index bytes."""
    import torch
    from repro_torch.core import AcornConfig
    from repro_torch.data import make_hcps_dataset
    from repro_torch.serve import EngineConfig, ServingEngine
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ds = make_hcps_dataset(n=n, d=d, seed=0, device=dev)
    sync(dev)
    data_s = time.perf_counter() - t0
    acorn = AcornConfig(M=ENGINE_M, gamma=ENGINE_GAMMA, m_beta=ENGINE_M_BETA,
                        ef_search=ENGINE_EF_SEARCH)
    cfg = EngineConfig(batch_size=ENGINE_BATCH, k=ENGINE_K,
                       n_shards=ENGINE_SHARDS)
    t0 = time.perf_counter()
    engine = ServingEngine(ds.x, ds.table, acorn, cfg, seed=0, device=dev)
    sync(dev)
    build_s = time.perf_counter() - t0
    g = engine.shards[0].index.graph
    log("engine", n=n, d=d, shards=ENGINE_SHARDS,
        clusters=len(ds.cluster_keywords), M=ENGINE_M, gamma=ENGINE_GAMMA,
        m_beta=ENGINE_M_BETA, batch=ENGINE_BATCH, ef=cfg.ef,
        data_s=f"{data_s:.3f}", build_s=f"{build_s:.3f}",
        shard_build_s=[round(s.index.build_seconds, 3)
                       for s in engine.shards],
        max_memory_allocated=(torch.cuda.max_memory_allocated() - mem0
                              if cuda else "not_measured"),
        index_bytes=sum(s.index.index_bytes for s in engine.shards),
        vector_bytes=ds.x.numel() * ds.x.element_size(),
        shard0_levels=[tuple(t.shape) for t in g.neighbors])
    return ds, engine


def engine_kernels(engine, closed, flush, base, by_name, phase="engine",
                   graph_x=None) -> None:
    """gather_distance (d = 512, l2 and ip, 10 % -1 ids) and
    neighbor_expand (compress and two_hop, m = 16, m_beta = 32, with and
    without the pass mask and visited set) against their plain versions
    on shard 0's graph (or the (graph, x) pair ``graph_x``: the tensors a
    path searches) and the first ENGINE_BATCH closed-loop queries; both
    timed as the other phases time them and added to their records'
    ``other_shapes`` under ``phase``."""
    import torch
    from repro_torch.core import neighbor_rows
    from repro_torch.kernels.gather_distance import (gather_distance_cuda,
                                                     gather_distance_ref)
    shard = engine.shards[0].index
    g, x = graph_x if graph_x is not None else (shard.graph, shard.x)
    dev, n = x.device, x.shape[0]
    rng = np.random.default_rng(4)
    nodes = torch.as_tensor(rng.integers(0, n, size=ENGINE_BATCH),
                            device=dev)
    q = closed.xq[:ENGINE_BATCH].contiguous()
    pm = engine.compile(closed.predicates[:ENGINE_BATCH]).evaluate(
        shard.table).contiguous()
    if pm.shape[1] != n:
        raise AssertionError(f"pass masks of {pm.shape[1]} rows for {n}")
    gen = torch.Generator(device=dev).manual_seed(4)
    vis = torch.rand((ENGINE_BATCH, n), generator=gen, device=dev) < 0.02
    ids = neighbor_rows(g, 0, nodes)[:, :ENGINE_M].contiguous()
    ids[torch.as_tensor(rng.random(ids.shape) < 0.1, device=dev)] = -1
    err = 0.0
    for metric in ("l2", "ip"):
        got = gather_distance_cuda(ids, q, x, metric)
        torch.cuda.synchronize()
        err = max(err, assert_gather_close(
            got, gather_distance_ref(ids, q, x, metric),
            f"gather_distance {phase} {metric}"))
    gd = measure_gather(ids, q, x, "l2", flush, base,
                        f"{phase} shard 0, n={n}, d={x.shape[1]}")
    gd["max_abs_err"] = max(err, gd["max_abs_err"])
    row0 = neighbor_rows(g, 0, nodes).contiguous()
    calls = [(row0, g.neighbors[0], g.pos[0], pm, vis,
              dict(strategy=strategy, m=ENGINE_M, m_beta=mb))
             for strategy, mb in (("compress", ENGINE_M_BETA),
                                  ("two_hop", 0))]
    log("kernels", kernel="neighbor_expand", path=phase,
        cases=check_expand(calls, f"{phase} rows"), bit_identical=True)
    ne = measure_expand((row0, g.neighbors[0], g.pos[0], pm, vis),
                        dict(strategy="compress", m=ENGINE_M,
                             m_beta=ENGINE_M_BETA), flush, base,
                        f"{phase} shard 0, n={n}, M={ENGINE_M}")
    for name, rec in (("gather_distance", gd), ("neighbor_expand", ne)):
        by_name[name].setdefault("other_shapes", []).append(
            dict(phase=phase, **rec))


def cpu_copy_parity(engine, closed, program, rows, path: str) -> None:
    """The closed-loop queries ``rows`` through ``engine.search_batch`` on
    the card and through the host loop of a CPU copy of its shards
    (``convert.engine_from_arrays``, plain versions): routes equal, ids
    equal but for near ties, distances within the stated tolerance."""
    import torch
    from repro_torch.convert import engine_from_arrays
    from repro_torch.core import SearchRequest
    from repro_torch.serve import EngineConfig

    def arrays(sh):
        t, gr = sh.index.table, sh.index.graph
        return dict(
            graph=dict(neighbors=[a.cpu().numpy() for a in gr.neighbors],
                       pos=[a.cpu().numpy() for a in gr.pos],
                       node_ids=[a.cpu().numpy() for a in gr.node_ids],
                       entry_point=gr.entry_point.cpu().numpy(),
                       levels=gr.levels.cpu().numpy()),
            x=sh.index.x.cpu().numpy(),
            table=dict(int_cols={c: v.cpu().numpy()
                                 for c, v in t.int_cols.items()},
                       bitset_cols={c: v.cpu().numpy().view(np.uint32)
                                    for c, v in t.bitset_cols.items()},
                       str_cols=dict(t.str_cols),
                       n_keywords=dict(t.n_keywords)))

    t0 = time.perf_counter()
    cfg = engine.cfg
    cpu_engine = engine_from_arrays(
        [arrays(sh) for sh in engine.shards], engine.acorn,
        EngineConfig(batch_size=cfg.batch_size, k=cfg.k,
                     n_shards=len(engine.shards), host_fallback=True),
        seed=0, device="cpu")
    ti = torch.as_tensor(rows, device=closed.xq.device)
    req = dict(predicates=program.take(rows), k=cfg.k)
    on_card = engine.search_batch(SearchRequest(xq=closed.xq[ti], **req))
    on_cpu = cpu_engine.search_batch(SearchRequest(xq=closed.xq[ti].cpu(),
                                                   **req))
    if not np.array_equal(on_card.routes, on_cpu.routes):
        raise AssertionError(f"{path} card vs CPU engine: routes differ")
    err, ties = assert_topk_match(
        on_card.ids, on_card.dists, on_cpu.ids, on_cpu.dists,
        closed.xq[ti].cpu(), cpu_engine._x, "l2", f"{path} card vs CPU")
    log("parity", path=path, queries=len(rows), near_ties=ties,
        max_abs_err=err, seconds=f"{time.perf_counter() - t0:.1f}")


def engine_serving(dev, ds, engine, closed, kinds, profile: bool) -> dict:
    """The engine's main path and its drills on ``dev``: the counted closed
    loop through ``engine.serve`` (after one warm-up batch), every workload
    kind, the open loop and the overload through ``ServingRuntime``, the
    failover drill, the CPU-copy parity and, with ``profile``, one traced
    batch.  Any failed check raises.  Returns the closed loop's launches
    of each of the port's kernels by name."""
    import torch
    from repro_torch.core import SearchRequest, SearchResult, masked_topk
    from repro_torch.serve import RuntimeConfig, ServingRuntime
    k, bsz = ENGINE_K, ENGINE_BATCH
    program = engine.compile(closed.predicates)
    n_closed = closed.xq.shape[0]

    def chunk(s, e):
        return closed.xq[s:e], program.take(slice(s, e))

    def request(i):
        """Request i of OPEN_SIZE closed-loop queries (wrapping around)."""
        i %= n_closed // OPEN_SIZE
        xq, prog = chunk(i * OPEN_SIZE, (i + 1) * OPEN_SIZE)
        return SearchRequest(xq=xq, predicates=prog, k=k)

    # ---- closed loop: counters zeroed just before, read just after ----
    engine.serve(*chunk(0, bsz))
    sync(dev)
    counters = all_launchers()
    for fn in counters:
        fn.launches = 0
    results, secs = [], []
    for s in range(0, n_closed, bsz):
        t0 = time.perf_counter()
        results.append(engine.serve(*chunk(s, s + bsz)))
        sync(dev)
        secs.append(time.perf_counter() - t0)
    launches = {fn.__name__[:-len("_cuda")]: fn.launches for fn in counters}
    res = SearchResult.concatenate(results)
    masks = corpus_masks(engine, program)
    gt, _ = masked_topk(closed.xq, ds.x, masks, k)
    qps = n_closed / sum(secs)
    ms = np.array(secs) * 1e3
    recall = route_recall(res, gt)
    log("engine", loop="closed", queries=n_closed, qps=f"{qps:.2f}",
        batch_p50_ms=f"{np.percentile(ms, 50):.3f}",
        batch_p99_ms=f"{np.percentile(ms, 99):.3f}",
        batch_ms=[round(float(v), 2) for v in ms],
        routes=check_served(res, masks, "closed loop"),
        recall_at_10=recall,
        selectivity=f"{float(masks.float().mean()):.4f}",
        launches={k_: v for k_, v in launches.items() if v})
    log("engine", loop="closed", graph_forced=graph_sweep(
        engine, closed.xq, program, gt, ds.cluster_of))
    if recall.get("prefilter", 1.0) < 0.999:
        raise AssertionError("closed loop: exact-route recall < 0.999")

    # ---- every workload kind ----
    for name, wl in kinds.items():
        prog = engine.compile(wl.predicates)
        if prog.regex_leaves:   # the host regex pass, on its own line
            t0 = time.perf_counter()
            for sh in engine.shards:
                for col, pat in prog.regex_leaves:
                    sh.index.table.regex_mask(col, pat)
            log("engine", kind=name, regex_patterns=len(prog.regex_leaves),
                rows=ds.n, regex_host_s=f"{time.perf_counter() - t0:.3f}")
        t0 = time.perf_counter()
        r = engine.serve(wl.xq, prog)
        sync(dev)
        dt = time.perf_counter() - t0
        m = corpus_masks(engine, prog)
        g_, _ = masked_topk(wl.xq, ds.x, m, k)
        log("engine", kind=name, queries=wl.xq.shape[0],
            seconds=f"{dt:.3f}", routes=check_served(r, m, name),
            recall_at_10=route_recall(r, g_),
            selectivity=f"{float(m.float().mean()):.4f}",
            graph_forced=graph_sweep(engine, wl.xq, prog, g_, ds.cluster_of))

    # ---- open loop: seeded Poisson arrivals through the runtime ----
    rate = OPEN_LOAD * qps / OPEN_SIZE
    n_req = min(OPEN_REQUESTS, n_closed // OPEN_SIZE)
    arrivals = open_loop_arrivals(n_req, rate, seed=0)
    tickets = []
    t0 = time.perf_counter()
    with ServingRuntime(engine, RuntimeConfig(
            max_queue=1024, coalesce_deadline=0.01)) as rt:
        for i, ta in enumerate(arrivals):
            wait = t0 + float(ta) - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            tickets.append(rt.submit(request(i)))
        outs = [t.result(timeout=600) for t in tickets]
    wall = time.perf_counter() - t0
    st = rt.stats()
    opened = SearchResult.concatenate(outs)
    served = torch.as_tensor(np.nonzero(~opened.shed)[0], device=dev)
    err, ties = assert_topk_match(
        opened.ids[served], opened.dists[served], res.ids[served],
        res.dists[served], closed.xq[served], ds.x, "l2",
        "open loop vs a direct engine.serve of the same queries")
    log("engine", loop="open", requests=n_req, request_size=OPEN_SIZE,
        rate_rps=f"{rate:.3f}", seconds=f"{wall:.3f}",
        sustained_qps=f"{st.qps:.2f}",
        latency_p50_ms=f"{st.latency_p50 * 1e3:.3f}",
        latency_p99_ms=f"{st.latency_p99 * 1e3:.3f}", shed=st.shed,
        dispatches=st.dispatches,
        batch_hist=dict(sorted(st.batch_hist.items())),
        served_equal_direct=True, near_ties=ties, max_abs_err=err)

    # ---- overload: more than max_queue at once sheds, never raises ----
    rt = ServingRuntime(engine, RuntimeConfig(
        max_queue=OVERLOAD_QUEUE, coalesce_deadline=0.01)).start()
    try:
        tickets = [rt.submit(request(i)) for i in range(OVERLOAD_REQUESTS)]
    finally:
        rt.stop(drain=True)
    outs = [t.result(timeout=600) for t in tickets]
    shed = [o for o in outs if o.shed.all()]
    if not shed or len(shed) == len(outs):
        raise AssertionError(f"overload: {len(shed)} of {len(outs)} "
                             "requests shed")
    for o in shed:
        if not (bool((o.ids == -1).all()) and bool(torch.isinf(o.dists)
                                                    .all())):
            raise AssertionError("overload: a shed result is not the "
                                 "-1 / inf sentinel")
    if any(bool(o.shed.any()) and not bool(o.shed.all()) for o in outs):
        raise AssertionError("overload: a request was shed in part")
    log("engine", loop="overload", requests=OVERLOAD_REQUESTS,
        max_queue=OVERLOAD_QUEUE, shed_requests=len(shed),
        shed_queries=rt.stats().shed, raised=False)

    # ---- failover drill ----
    drill = min(2 * bsz, n_closed)
    healthy = res.ids[:drill]
    engine.cfg.duplicate_dispatch = True
    engine.fail_shard(1)
    before = engine.stats["duplicated_dispatches"]
    mirrored = engine.serve(*chunk(0, drill))
    if not torch.equal(mirrored.ids, healthy):
        raise AssertionError("failover: mirrored ids differ from healthy")
    engine.cfg.duplicate_dispatch = False
    lost = engine.serve(*chunk(0, drill))
    lo, hi = engine.shards[1].base, engine.shards[2].base
    if not lost.degraded.all() or bool(((lost.ids >= lo)
                                        & (lost.ids < hi)).any()):
        raise AssertionError("hard loss: not degraded, or an id of shard 1")
    t0 = time.perf_counter()
    engine.rebuild_shard(1)
    sync(dev)
    rebuild_s = time.perf_counter() - t0
    rebuilt = engine.serve(*chunk(0, drill))
    same = torch.equal(rebuilt.ids, healthy)
    log("engine", drill="failover", queries=drill,
        mirrored_equal=True,
        duplicated_dispatches=engine.stats["duplicated_dispatches"] - before,
        hard_loss_degraded=True, rebuild_s=f"{rebuild_s:.3f}",
        rebuilt_equal=same,
        rebuilt_rows_differing=int((rebuilt.ids != healthy).any(dim=1)
                                   .sum()))
    if not same:
        raise AssertionError("rebuild_shard(1): ids differ from healthy")

    # ---- parity: the card's engine vs a CPU copy of its four shards ----
    cpu_copy_parity(engine, closed, program,
                    np.nonzero(res.routes == "graph")[0][:ENGINE_PARITY],
                    "engine")

    if profile:
        profile_call(lambda: engine.search_batch(SearchRequest(
            xq=closed.xq[:bsz], predicates=program.take(slice(0, bsz)),
            k=k)), path="engine", batch=bsz)
    return launches


# ---------------------------------------------------------------------------
# baselines and incremental phases: Figure 7 and Table 4 (§7.2)
# ---------------------------------------------------------------------------


def assert_ids_pass(ids, masks, what: str) -> None:
    """Every returned id (>= 0) passes its query's predicate."""
    import torch
    passes = torch.gather(masks, 1, ids.clamp(min=0).long())
    if not bool((passes | (ids < 0)).all()):
        raise AssertionError(f"{what}: a returned id fails its predicate")


def sq_dists64(x, rows, ids):
    """float64 squared L2 from x[rows[i]] to x[ids[i, j]] (numpy, ids
    >= 0), computed on the host."""
    xr = x[np.asarray(rows)].astype(np.float64)
    xi = x[np.asarray(ids)].astype(np.float64)
    return ((xi - xr[:, None, :]) ** 2).sum(-1)


def assert_knn_near_ties(knn_a, knn_b, xm, what: str) -> int:
    """Exact-KNN lists (local ids, numpy) may differ only where the two
    ids' float64 distances to the row are a near tie; returns the count
    of differing rows."""
    rows = np.nonzero((knn_a != knn_b).any(axis=1))[0]
    for r in rows:
        sel = np.nonzero(knn_a[r] != knn_b[r])[0]
        a, b = knn_a[r, sel], knn_b[r, sel]
        if (a < 0).any() or (b < 0).any():
            raise AssertionError(f"{what}: row {r} pads differently")
        da = sq_dists64(xm, [r], [a])[0]
        db = sq_dists64(xm, [r], [b])[0]
        if (np.abs(da - db) > NEAR_TIE_REL * np.maximum(da, db)).any():
            raise AssertionError(f"{what}: row {r} differs off a near tie")
    return len(rows)


def rng_prune_margin(xm, cand, rows, m_out: int) -> np.ndarray:
    """Per row of ``rows``, the smallest relative gap between the two sides of any
    comparison ``rng_prune`` makes (dist(v, c_j) against dist(c_j, c_k)
    for the kept c_k), replayed in float64 on the host; a row whose
    pruned list differs between two arithmetics must have a gap within
    NEAR_TIE_REL."""
    out = np.full(len(rows), np.inf)
    for i, r in enumerate(rows):
        c = cand[r][cand[r] >= 0]
        d_vc = sq_dists64(xm, [r], [c])[0]
        xc = xm[c].astype(np.float64)
        d_cc = ((xc[:, None, :] - xc[None, :, :]) ** 2).sum(-1)
        kept = []
        for j in range(len(c)):
            if len(kept) >= m_out:
                break
            dk = d_cc[j, kept].min() if kept else np.inf
            if np.isfinite(dk):
                out[i] = min(out[i], abs(d_vc[j] - dk) / max(d_vc[j], dk))
            if d_vc[j] < dk:
                kept.append(j)
    return out


def hnsw_build_parity(x_card, m: int, efc: int, seed: int = 0) -> dict:
    """``build_hnsw`` over ``x_card``'s rows on its device and on a CPU
    copy, with one level draw: neighbour lists, ``pos``, ``node_ids`` and
    entry point identical except where a near tie explains a row: each
    level's exact-KNN lists may differ only at near ties, ``rng_prune`` on
    the CPU's KNN lists may differ only in rows whose float64 prune has a
    near tie, and the reverse-slack pass on the CPU's pruned lists must be
    identical.  Returns the counts of differing rows."""
    import torch
    from repro_torch.core import (assign_levels, build_hnsw, knn_among,
                                  rng_prune, with_reverse_slack)
    n = x_card.shape[0]
    lv = assign_levels(torch.Generator().manual_seed(seed), n, m).numpy()
    x_cpu = x_card.cpu()
    ga = build_hnsw(x_card, None, m, efc=efc, levels=lv)
    gb = build_hnsw(x_cpu, None, m, efc=efc, levels=lv)
    if int(ga.entry_point) != int(gb.entry_point):
        raise AssertionError("build_hnsw card vs CPU: entry points differ")
    out = dict(differing_rows=0, knn_rows=0, prune_rows=0)
    xn = x_cpu.numpy()
    r_slack = max(2, m // 2)
    for lvl in range(gb.num_levels):
        for f in ("pos", "node_ids"):
            if not torch.equal(getattr(ga, f)[lvl].cpu(),
                               getattr(gb, f)[lvl]):
                raise AssertionError(f"build_hnsw card vs CPU: {f} differ")
        a, b = ga.neighbors[lvl].cpu().numpy(), gb.neighbors[lvl].numpy()
        if np.array_equal(a, b):
            continue
        out["differing_rows"] += int((a != b).any(axis=1).sum())
        members = gb.node_ids[lvl].long()
        xm = xn[members.numpy()]
        k_cand = min(efc, max(len(members) - 1, 1))
        m_out = max((2 * m if lvl == 0 else m) - r_slack, 1)
        knn_b = knn_among(x_cpu[members], k_cand)
        knn_a = knn_among(x_card[members.to(x_card.device)], k_cand).cpu()
        what = f"build_hnsw card vs CPU, level {lvl}"
        out["knn_rows"] += assert_knn_near_ties(knn_a.numpy(), knn_b.numpy(),
                                                xm, what + " KNN")
        pb = rng_prune(x_cpu[members], knn_b, m_out)
        pa = rng_prune(x_card[members.to(x_card.device)],
                       knn_b.to(x_card.device), m_out).cpu()
        rows = np.nonzero((pa != pb).any(dim=1).numpy())[0]
        if len(rows):
            gap = rng_prune_margin(xm, knn_b.numpy(), rows, m_out)
            if (gap > NEAR_TIE_REL).any():
                raise AssertionError(f"{what}: rng_prune differs off a "
                                     "near tie")
        out["prune_rows"] += len(rows)
        if not torch.equal(with_reverse_slack(pb.to(x_card.device), r_slack)
                           .cpu(), with_reverse_slack(pb, r_slack)):
            raise AssertionError(f"{what}: reverse slack differs")
    return out


def oracle_to(oracle, device):
    """A copy of an ``OraclePartitionIndex`` on ``device``."""
    from repro_torch.core import OraclePartitionIndex
    return OraclePartitionIndex(
        partitions={pid: (g.to(device), xp.to(device), gids.to(device))
                    for pid, (g, xp, gids) in oracle.partitions.items()},
        m=oracle.m)


def baselines_build(dev, x, labels, card: int = CARD, m: int = BASE_M,
                    efc: int = BASE_EFC) -> dict:
    """ACORN-1, HNSW (the post-filter's graph) and the oracle partition
    index (one HNSW per label) over ``x`` on ``dev``, each with M = ``m``
    and a generator seeded 0; logs seconds, peak device memory over the
    build's start and index bytes (edges; the oracle's copies of its
    partitions' vectors apart)."""
    import torch
    from repro_torch.core import (OraclePartitionIndex, build_acorn_1,
                                  build_hnsw, memory_bytes)
    cuda = dev.type == "cuda"
    built = {}

    def timed(name, fn):
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            mem0 = torch.cuda.memory_allocated()
        sync(dev)
        t0 = time.perf_counter()
        obj = fn(torch.Generator().manual_seed(0))
        sync(dev)
        secs = time.perf_counter() - t0
        if name == "oracle":
            nbytes = sum(memory_bytes(g) for g, _, _ in
                         obj.partitions.values())
            extra = dict(partitions=len(obj.partitions),
                         rows=[int(xp.shape[0]) for _, xp, _ in
                               obj.partitions.values()],
                         vector_copy_bytes=sum(
                             xp.numel() * xp.element_size()
                             for _, xp, _ in obj.partitions.values()))
        else:
            nbytes = memory_bytes(obj)
            extra = dict(levels=[tuple(t.shape) for t in obj.neighbors])
        log("baselines", build=name, M=m, seconds=f"{secs:.3f}",
            max_memory_allocated=(torch.cuda.max_memory_allocated() - mem0
                                  if cuda else "not_measured"),
            index_bytes=nbytes, **extra)
        built[name] = obj

    timed("acorn-1", lambda gen: build_acorn_1(x, gen, M=m))
    timed("hnsw", lambda gen: build_hnsw(x, gen, M=m, efc=efc))
    timed("oracle", lambda gen: OraclePartitionIndex.build(
        x, {v: labels == v for v in range(card)}, gen, M=m, efc=efc))
    return built


def fig7_methods(x, g_gamma, built, selectivity: float) -> dict:
    """The four graph methods of Figure 7 over ``x``: {name: (run,
    comps)}, ``run(xq, masks, labels, ef) -> (ids, dists, dist_comps (B,)
    or None)`` and ``comps(xq, ef)`` the dist_comps where ``run`` gives
    None.  ACORN-γ (M,
    M_β of the build phase) and ACORN-1 (m = m_β = BASE_M) through
    ``hybrid_search`` with max_expansions 4·ef, as the reference's
    benchmark runs them; post-filter through ``postfilter_search`` at
    ``selectivity`` (its dist_comps from the same pool's ``ann_search``,
    run after it); the oracle one batch per label (``labels``, numpy)."""
    import torch
    from repro_torch.core import ann_search, hybrid_search, postfilter_search
    from repro_torch.core.baselines import postfilter_pool

    def acorn(g, variant, m, m_beta):
        def run(q, pm, lab, ef):
            ids, d, st = hybrid_search(
                g, x, q, pm, k=K, ef=ef, variant=variant, m=m, m_beta=m_beta,
                compressed_level0=variant == "acorn-gamma",
                max_expansions=4 * ef)
            return ids, d, st.dist_comps
        return run

    def post(q, pm, lab, ef):
        return postfilter_search(built["hnsw"], x, q, pm, K,
                                 selectivity=selectivity, ef=ef,
                                 m=BASE_M) + (None,)

    def post_comps(q, ef):
        kk, ef_eff = postfilter_pool(K, selectivity, ef)
        return ann_search(built["hnsw"], x, q, k=kk, ef=ef_eff,
                          m=BASE_M)[2].dist_comps

    def oracle(q, pm, lab, ef):
        ids = torch.full((q.shape[0], K), -1, dtype=torch.int32,
                         device=q.device)
        d = torch.full((q.shape[0], K), float("inf"), device=q.device)
        dc = torch.zeros((q.shape[0],), dtype=torch.int32, device=q.device)
        for pid in np.unique(lab):
            sel = torch.as_tensor(np.nonzero(lab == pid)[0], device=q.device)
            i, dd, st = built["oracle"].search(int(pid), q[sel], K, ef=ef)
            ids[sel], d[sel], dc[sel] = i, dd, st.dist_comps
        return ids, d, dc

    return {"acorn-gamma": (acorn(g_gamma, "acorn-gamma", M, M_BETA), None),
            "acorn-1": (acorn(built["acorn-1"], "acorn-1", BASE_M, BASE_M),
                        None),
            "postfilter": (post, post_comps), "oracle": (oracle, None)}


def baselines_search(dev, x, g_gamma, built, xq, masks, labels, gt,
                     ef_sweep=BASE_EF_SWEEP, n_parity: int = BASE_PARITY
                     ) -> dict:
    """Figure 7 on ``dev``: each graph method at every ef of ``ef_sweep``
    and pre-filter once, over the queries ``xq`` (masks (B, n), labels
    (B,) numpy, exact top-K ``gt``): recall@K, QPS (one timed call of
    the batch) and mean dist_comps, with the launch counters zeroed just
    before each call and read just after.  Checks: every id passes its
    predicate; pre-filter recall >= 0.999; on the card gather_distance
    launches for every graph method and neighbor_expand for ACORN-γ and
    ACORN-1 only; ``n_parity`` queries of each method at ef 64 equal a CPU
    copy's (plain versions) except at near ties; a method whose recall at
    the sweep's last ef is below BASE_RECALL_FLOOR returns, on every
    query at that ef, the CPU copy's ids except at near ties (the floor
    guards against a broken kernel; below it, the recall must be the
    plain versions' own).  Returns {method: launches}."""
    import torch
    from repro_torch.core import prefilter_search, recall_at_k
    from repro_torch.kernels.gather_distance import gather_distance_cuda
    from repro_torch.kernels.neighbor_expand import neighbor_expand_cuda
    sel = float(masks.float().mean())
    methods = fig7_methods(x, g_gamma, built, sel)
    nq = xq.shape[0]
    launches, curves, last = {}, {}, {}

    def counted(fn):
        sync(dev)
        gather_distance_cuda.launches = 0
        neighbor_expand_cuda.launches = 0
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        secs = time.perf_counter() - t0
        return out, secs, {"gather_distance": gather_distance_cuda.launches,
                           "neighbor_expand": neighbor_expand_cuda.launches}

    for name, (run, comps) in methods.items():
        run(xq[:16], masks[:16], labels[:16], ef_sweep[0])   # warm-up
        pts = []
        for ef in ef_sweep:
            out, secs, cnt = counted(lambda: run(xq, masks, labels, ef))
            ids, dc = out[0], (out[2] if comps is None else comps(xq, ef))
            assert_ids_pass(ids, masks, f"{name} ef={ef}")
            pts.append(dict(ef=ef, recall=round(recall_at_k(ids, gt), 4),
                            qps=round(nq / secs, 1),
                            dist_comps=round(float(dc.float().mean()), 1)))
            log("baselines", method=name, **pts[-1], launches=cnt)
            for k, v in cnt.items():
                launches.setdefault(name, {}).setdefault(k, 0)
                launches[name][k] += v
        curves[name] = pts
        last[name] = out[:2]
    (ids, _), secs, cnt = counted(lambda: prefilter_search(xq, x, masks, K))
    assert_ids_pass(ids, masks, "prefilter")
    pre = dict(recall=round(recall_at_k(ids, gt), 4), qps=round(nq / secs, 1),
               dist_comps=round(float(masks.sum(dim=1).float().mean()), 1))
    log("baselines", method="prefilter", **pre, launches=cnt)
    if pre["recall"] < 0.999:
        raise AssertionError(f"prefilter recall {pre['recall']} < 0.999")
    if dev.type == "cuda":
        for name, cnt in launches.items():
            if cnt["gather_distance"] <= 0:
                raise AssertionError(f"{name}: gather_distance not launched")
            if (cnt["neighbor_expand"] > 0) != name.startswith("acorn"):
                raise AssertionError(f"{name}: neighbor_expand launched "
                                     f"{cnt['neighbor_expand']} times")
    at = {name: max([p["qps"] for p in pts
                     if p["recall"] >= RECALL_TARGET], default=None)
          for name, pts in curves.items()}
    at["prefilter"] = pre["qps"] if pre["recall"] >= RECALL_TARGET else None
    log("baselines", qps_at_recall=RECALL_TARGET, **at,
        order=sorted(at, key=lambda k: -(at[k] or 0.0)), selectivity=sel)

    # card (kernels) vs a CPU copy (plain versions), ef 64
    cpu = torch.device("cpu")
    cpu_built = {"acorn-1": built["acorn-1"].to(cpu),
                 "hnsw": built["hnsw"].to(cpu),
                 "oracle": oracle_to(built["oracle"], cpu)}
    x_cpu = x.cpu()
    cpu_methods = fig7_methods(x_cpu, g_gamma.to(cpu), cpu_built, sel)
    q, pm, lab = xq[:n_parity], masks[:n_parity], labels[:n_parity]
    for name, (run, _) in methods.items():
        run_cpu = cpu_methods[name][0]
        ids_c, d_c = run(q, pm, lab, 64)[:2]
        ids_h, d_h = run_cpu(q.cpu(), pm.cpu(), lab, 64)[:2]
        err, ties = assert_topk_match(ids_c, d_c, ids_h, d_h, q.cpu(), x_cpu,
                                      "l2", f"{name} card vs CPU")
        log("parity", path="baselines", method=name, queries=n_parity,
            near_ties=ties, max_abs_err=err)
    # below the floor at the last ef, the CPU copy must give the same ids
    # on every query: the recall is then the plain versions' own
    for name, pts in curves.items():
        if pts[-1]["recall"] >= BASE_RECALL_FLOOR:
            continue
        ef = ef_sweep[-1]
        ids_h, d_h = cpu_methods[name][0](xq.cpu(), masks.cpu(), labels,
                                          ef)[:2]
        err, ties = assert_topk_match(*last[name], ids_h, d_h, xq.cpu(),
                                      x_cpu, "l2", f"{name} ef={ef} below "
                                      f"the floor, card vs CPU")
        log("parity", path="baselines", method=name, ef=ef, queries=nq,
            recall=pts[-1]["recall"], floor=BASE_RECALL_FLOOR,
            cpu_recall=round(recall_at_k(ids_h, gt.cpu()), 4),
            near_ties=ties, max_abs_err=err)
    return launches


def incremental_states(x, lv, variant: str, m: int, gamma: int, efc: int):
    """The incremental builder's state after inserting every row of ``x``
    in order, with levels ``lv`` (numpy)."""
    from repro_torch.core.build_incremental import (insert, new_state,
                                                    variant_params)
    caps, ef_b = variant_params(variant, m, gamma, efc, int(lv.max()) + 1)
    st = new_state(x.shape[0], caps, int(lv[0]), x.device)
    beams = {}
    for v in range(x.shape[0]):
        st = insert(st, x, v, int(lv[v]), caps, m, ef_b, beams)
    return st, caps, ef_b


def insert_near_tie(x, v: int, pre, a, b) -> bool:
    """Does a near tie explain why inserting ``v`` gave the tables ``a``
    and ``b`` (numpy, per level) from the same tables ``pre``?  Where v's
    own list differs at some level, its float64 distances to the ids of
    both lists must hold a near tie; a reverse list that differs while
    v's lists agree must hold one among its owner's distances to its
    earlier entries and v."""
    def tie(d):
        d = np.sort(d)
        return bool((np.diff(d) <= NEAR_TIE_REL * d[1:]).any())

    for lvl in range(len(pre)):
        if not np.array_equal(a[lvl][v], b[lvl][v]):
            ids = np.union1d(a[lvl][v], b[lvl][v])
            return tie(sq_dists64(x, [v], [ids[ids >= 0]])[0])
    for lvl in range(len(pre)):
        for u in np.nonzero((a[lvl] != b[lvl]).any(axis=1))[0]:
            ids = np.append(pre[lvl][u][pre[lvl][u] >= 0], v)
            if not tie(sq_dists64(x, [u], [ids])[0]):
                return False
    return True


def incremental_parity(x_card, lv, variant: str, m: int, gamma: int,
                       efc: int) -> int:
    """The incremental builder on ``x_card``'s device and on a CPU copy,
    with levels ``lv``: neighbour lists, counts and entry point identical.
    Where they differ, every insert is replayed from the CPU's state on
    both devices and each insert that diverges must be explained by a
    near tie (:func:`insert_near_tie`).  Returns the diverging inserts."""
    import torch
    from repro_torch.core.build_incremental import (IncrementalState, insert,
                                                    new_state)
    x_cpu = x_card.cpu()
    sa, caps, ef_b = incremental_states(x_card, lv, variant, m, gamma, efc)
    sb, _, _ = incremental_states(x_cpu, lv, variant, m, gamma, efc)

    def same(s, t):
        return s.entry == t.entry and all(
            torch.equal(p.cpu(), q.cpu()) for p, q in
            zip(s.neighbors + s.counts, t.neighbors + t.counts))

    if same(sa, sb):
        return 0
    xn, n = x_cpu.numpy(), x_cpu.shape[0]
    sb = new_state(n, caps, int(lv[0]), "cpu")
    diverged = 0
    for v in range(n):
        pre = [t[:n].numpy().copy() for t in sb.neighbors]
        sa = IncrementalState(
            tuple(t.to(x_card.device, copy=True) for t in sb.neighbors),
            tuple(t.to(x_card.device, copy=True) for t in sb.counts),
            sb.entry, sb.entry_level)
        sa = insert(sa, x_card, v, int(lv[v]), caps, m, ef_b)
        sb = insert(sb, x_cpu, v, int(lv[v]), caps, m, ef_b)
        if same(sa, sb):
            continue
        diverged += 1
        if not insert_near_tie(xn, v, pre,
                               [t[:n].cpu().numpy() for t in sa.neighbors],
                               [t[:n].numpy() for t in sb.neighbors]):
            raise AssertionError(f"incremental {variant} card vs CPU: "
                                 f"insert {v} differs off a near tie")
    return diverged


def incremental_phase(dev, x, xq, n_inc: int = N_INC,
                      prefix: int = INC_PREFIX, m: int = BASE_M,
                      gamma: int = GAMMA, efc: int = INC_EFC) -> dict:
    """Table 4 on ``dev``: ``build_incremental`` for hnsw, acorn-1 and
    acorn-gamma over the first ``n_inc`` rows of ``x`` (one generator
    seed for all three): TTI seconds, index bytes and recall@K of the
    queries ``xq``, unfiltered, through ``ann_search`` / ``hybrid_search``
    against their exact top-K over those rows; then each variant over the
    first ``prefix`` rows on ``dev`` and on a CPU copy, identical except
    at near ties.  Returns {variant: TTI seconds}."""
    import torch
    from repro_torch.core import (ann_search, assign_levels, hybrid_search,
                                  masked_topk, memory_bytes, recall_at_k)
    from repro_torch.core.build_incremental import build_incremental
    xs = x[:n_inc].contiguous()
    gt, _ = masked_topk(xq, xs, None, K)
    tti = {}
    for variant in INC_VARIANTS:
        g, secs = build_incremental(xs, torch.Generator().manual_seed(0), m,
                                    variant=variant, gamma=gamma, efc=efc)
        if variant == "hnsw":
            ids = ann_search(g, xs, xq, k=K, ef=EF, m=m)[0]
        else:
            ids = hybrid_search(g, xs, xq, None, k=K, ef=EF, variant=variant,
                                m=m, m_beta=2 * m,
                                compressed_level0=False)[0]
        tti[variant] = secs
        log("incremental", variant=variant, n=n_inc, M=m,
            gamma=gamma if variant == "acorn-gamma" else 1, efc=efc,
            tti_s=f"{secs:.3f}", index_bytes=memory_bytes(g),
            levels=[tuple(t.shape) for t in g.neighbors],
            recall=round(recall_at_k(ids, gt), 4), queries=xq.shape[0])
    log("incremental", tti_order_as_paper=bool(
        tti["acorn-1"] < tti["hnsw"] < tti["acorn-gamma"]),
        tti_s={k: round(v, 3) for k, v in tti.items()})
    lv = assign_levels(torch.Generator().manual_seed(0), prefix, m).numpy()
    for variant in INC_VARIANTS:
        t0 = time.perf_counter()
        div = incremental_parity(x[:prefix].contiguous(), lv, variant, m,
                                 gamma, efc)
        log("parity", path="incremental", variant=variant, rows=prefix,
            diverging_inserts=div, seconds=f"{time.perf_counter() - t0:.1f}")
    return tti


# ---- mesh: the distributed paths on a one-rank process group ----
MESH_SEED = 0
MESH_CHECK = {"serve_1m": 16, "serve_25m": 8}  # queries held to fp64
MESH_TIMED = 3              # timed calls per acorn variant, after one warm-up
MESH_EXACT_ROWS = 1 << 18   # rows per block of the fp64 recompute
MESH_ENGINE_QUERIES = 256   # closed-loop queries through each engine path
MESH_PARITY = 16            # of them, SPMD on the card vs a CPU copy
MESH_CHUNK = 8192           # the reference's scan block (its step default)
MESH_WIDE_CHUNK = 1 << 16   # a wider block, timed beside it (same answer)
GROUP_TIMEOUT_S = 60        # a collective waits this long, then raises


def mesh_group(dev) -> None:
    """Join a one-rank default process group on ``dev`` (``nccl`` on the
    card, ``gloo`` on the CPU; a ``HashStore``, so no TCP) and check that an
    all-gather of a tensor on ``dev`` returns it unchanged."""
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import local_device_count
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", store=dist.HashStore(),
        rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    t = torch.arange(4096, dtype=torch.float32, device=dev)
    parts = [torch.empty_like(t)]
    dist.all_gather(parts, t)
    sync(dev)
    if not torch.equal(parts[0], t):
        raise AssertionError("an all-gather over one rank changed its input")
    log("mesh", backend=dist.get_backend(), world_size=dist.get_world_size(),
        local_device_count=local_device_count(), all_gather_equal=True)


def exact_topk64(x, q, masks, k: int, rows: int = MESH_EXACT_ROWS) -> tuple:
    """The exact masked top-k of queries ``q`` over ``x`` in float64 (the
    expanded form), in blocks of ``rows`` rows: (ids, squared distances),
    -1 / inf where fewer than k rows pass."""
    import torch
    qd = q.double()
    qn = (qd * qd).sum(dim=1, keepdim=True)
    b = q.shape[0]
    best_d = torch.full((b, k), float("inf"), dtype=torch.float64,
                        device=q.device)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=q.device)
    for s in range(0, x.shape[0], rows):
        xc = x[s:s + rows].double()
        dd = qn + (xc * xc).sum(dim=1)[None, :] - 2.0 * (qd @ xc.T)
        dd = torch.where(masks[:, s:s + rows], dd,
                         torch.full_like(dd, float("inf")))
        ids = torch.arange(s, s + xc.shape[0], device=q.device)
        cd = torch.cat([best_d, dd], dim=1)
        ci = torch.cat([best_i, ids.expand(b, -1)], dim=1)
        best_d, pos = torch.topk(cd, k, dim=1, largest=False, sorted=True)
        best_i = torch.gather(ci, 1, pos)
    best_i = torch.where(torch.isfinite(best_d), best_i,
                         torch.full_like(best_i, -1))
    return best_i.to(torch.int32), best_d


def acorn_serve(dev, shape: str, variants, flush,
                reduced: bool = False) -> dict:
    """The ``acorn`` arch's serve step at ``shape`` on ``make_host_mesh()``
    (one rank): inputs from ``random_inputs`` (masks at density 0.5, drawn
    as bool); each variant, an (``optimized``, ``chunk``) pair, run once,
    checked (every id passes its mask, -1 ids exactly where dists are
    infinite) and, on the card, timed (``MESH_TIMED`` calls, cold L2)
    beside the bound of its bytes (corpus + masks + queries + result) and
    fp32 FLOPs (2 B n d); every variant held to the first (near ties
    only); the first ``MESH_CHECK[shape]`` queries held to
    ``exact_topk64``.  Returns {variant: ms} (``None`` off the card)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.acorn import ACORN_SHAPES, REDUCED_ACORN_SHAPES
    from repro_torch.launch.mesh import make_host_mesh
    arch = get_arch("acorn")
    spec = (REDUCED_ACORN_SHAPES if reduced else ACORN_SHAPES)[shape]
    b, n, d, k = spec["batch"], spec["n"], spec["d"], spec["k"]
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    x, q, masks = arch.random_inputs(shape, seed=MESH_SEED,
                                     reduced=reduced, device=dev)
    sync(dev)
    data_s = time.perf_counter() - t0
    mesh = make_host_mesh()
    args = arch.in_shardings(None, shape, mesh)(x, q, masks)
    nbytes = (x.numel() * 4 + masks.numel() + q.numel() * 4 + b * k * 8)
    bound_ms, bound_by = bound(nbytes, 2.0 * b * n * d)
    log("mesh", arch="acorn", shape=shape, batch=b, n=n, d=d, k=k,
        mesh=dict(zip(mesh.axis_names, mesh.shape)), data_s=f"{data_s:.3f}",
        input_bytes=nbytes, bound_ms=f"{bound_ms:.4f}", bound_by=bound_by)
    results, out = {}, {}
    for opt, chunk in variants:
        if cuda:   # each variant's own peak, over the inputs
            torch.cuda.reset_peak_memory_stats()
        step = arch.step_fn(None, shape, reduced=reduced, mesh=mesh, k=k,
                            optimized=opt, chunk=chunk)
        t0 = time.perf_counter()
        ids, dist_ = step(*args)
        sync(dev)
        first_s = time.perf_counter() - t0
        if ids.shape != (b, k) or not torch.equal(torch.isfinite(dist_),
                                                  ids >= 0):
            raise AssertionError(f"acorn {shape}: ids / dists malformed")
        passing = torch.gather(masks, 1, ids.clamp(min=0).long())
        if not bool((passing | (ids < 0)).all()):
            raise AssertionError(f"acorn {shape}: an id fails its mask")
        ms = time_ms(lambda: step(*args), MESH_TIMED, flush, warmup=0) \
            if cuda else None
        out[opt, chunk] = ms
        results[opt, chunk] = (ids, dist_)
        log("mesh", arch="acorn", shape=shape, optimized=opt,
            chunk=chunk if opt else "-", first_call_s=f"{first_s:.3f}",
            ms=f"{ms:.3f}" if cuda else "not_measured",
            qps=f"{b / ms * 1e3:.1f}" if cuda else "not_measured",
            bound_ms=f"{bound_ms:.4f}",
            peak_memory=(torch.cuda.max_memory_allocated() - mem0 if cuda
                         else "not_measured"))
    (ia, da), *others = results.values()
    for key, (ib, db) in zip(list(results)[1:], others):
        err, ties = assert_topk_match(ib, db, ia, da, q, x, "l2",
                                      f"acorn {shape} {key} vs "
                                      f"{variants[0]}")
        log("mesh", arch="acorn", shape=shape, variant=key,
            vs=variants[0], near_ties=ties, max_abs_err=err)
    c = MESH_CHECK[shape] if not reduced else 4
    want_i, want_d = exact_topk64(x, q[:c], masks[:c], k)
    for key, (ids, dist_) in results.items():
        err, ties = assert_topk_match(ids[:c], dist_[:c], want_i,
                                      want_d.float(), q[:c], x, "l2",
                                      f"acorn {shape} {key} vs float64")
        log("parity", path=f"acorn {shape}", variant=key, queries=c,
            reference="exact float64", near_ties=ties, max_abs_err=err)
    return out


def mesh_engine(dev, ds, closed, n_queries: int = MESH_ENGINE_QUERIES,
                profile: bool = False, kernels=None) -> dict:
    """The serving engine's SPMD path on ``dev``: the launcher's
    configuration (``AcornConfig(M=16, gamma=12, m_beta=32,
    ef_search=96)``, batches of 32, k = 10) with one shard and
    ``ExecutionSpec(corpus_parallel=1)`` over the engine phase's corpus
    ``ds``, so the engine takes the SPMD path on a 1 x 1 mesh; the first
    ``n_queries`` closed-loop queries through ``search_batch`` (the SPMD
    program; launch counters zeroed just before, read just after), again
    (no new variant), and through ``search_batch_host``: ids and dists
    bit-identical, every id passing its predicate; ``MESH_PARITY`` of
    them through the SPMD program held to a CPU copy's host loop (plain
    versions); ``fail_shard(0)`` returns the all-down sentinel, and after
    ``rebuild_shard(0)`` the ids come back.  ``kernels``, a (flush, base,
    by_name) triple, holds gather_distance and neighbor_expand to their
    plain versions on the shard the SPMD program searches
    (``engine_kernels``, phase "mesh").  With ``profile``, one batch
    traced on each path.  Returns the SPMD run's launches by kernel
    name."""
    import torch
    from repro_torch.core import (AcornConfig, ExecutionSpec, SearchRequest,
                                  SearchResult)
    from repro_torch.distributed.corpus_parallel import shard_slice
    from repro_torch.serve import EngineConfig, ServingEngine
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
    acorn = AcornConfig(M=ENGINE_M, gamma=ENGINE_GAMMA, m_beta=ENGINE_M_BETA,
                        ef_search=ENGINE_EF_SEARCH)
    cfg = EngineConfig(batch_size=ENGINE_BATCH, k=ENGINE_K, n_shards=1,
                       spec=ExecutionSpec(corpus_parallel=1))
    t0 = time.perf_counter()
    engine = ServingEngine(ds.x, ds.table, acorn, cfg, seed=0, device=dev)
    sync(dev)
    build_s = time.perf_counter() - t0
    if engine.spmd_mesh_shape() != (1, 1):
        raise AssertionError(f"engine mesh {engine.spmd_mesh_shape()}, "
                             "not (1, 1)")
    if kernels is not None:   # the (2^20, 512) shard the program reads
        engine_kernels(engine, closed, *kernels, phase="mesh",
                       graph_x=shard_slice(engine._stacked_corpus(), 0))
    program = engine.compile(closed.predicates[:n_queries])
    xq = closed.xq[:n_queries]
    reqs = [SearchRequest(xq=xq[s:s + ENGINE_BATCH],
                          predicates=program.take(slice(s, s + ENGINE_BATCH)),
                          k=ENGINE_K)
            for s in range(0, n_queries, ENGINE_BATCH)]

    def run(fn):
        out, t0 = [], time.perf_counter()
        for r in reqs:
            out.append(fn(r))
        sync(dev)
        return out, time.perf_counter() - t0

    def same(a, b, what):
        for i, (ra, rb) in enumerate(zip(a, b)):
            if not (torch.equal(ra.ids, rb.ids)
                    and torch.equal(ra.dists, rb.dists)):
                raise AssertionError(f"{what}: batch {i} differs")

    engine.search_batch(reqs[0])            # warm-up
    sync(dev)
    counters = all_launchers()
    for fn in counters:
        fn.launches = 0
    spmd, spmd_s = run(engine.search_batch)
    launches = {fn.__name__[:-len("_cuda")]: fn.launches for fn in counters}
    traces = engine.spmd_traces()
    again, again_s = run(engine.search_batch)
    if engine.spmd_traces() != traces:
        raise AssertionError(f"SPMD variants grew on a repeat: {traces} -> "
                             f"{engine.spmd_traces()}")
    host, host_s = run(engine.search_batch_host)
    same(spmd, again, "SPMD repeat")
    same(spmd, host, "SPMD vs host loop")
    res = SearchResult.concatenate(spmd)
    routes = check_served(res, corpus_masks(engine, program),
                          "SPMD engine")
    cpu_copy_parity(engine, closed, program,
                    np.nonzero(res.routes == "graph")[0][:MESH_PARITY],
                    "engine spmd")
    if profile:
        profile_call(lambda: engine.search_batch(reqs[1]), path="engine spmd")
        profile_call(lambda: engine.search_batch_host(reqs[1]),
                     path="engine host loop")
    engine.fail_shard(0)
    down = engine.search_batch(reqs[0])
    if not (bool((down.ids == -1).all()) and bool(torch.isinf(
            down.dists).all()) and bool(down.degraded.all())):
        raise AssertionError("every shard down: not the -1 / inf sentinel")
    t0 = time.perf_counter()
    engine.rebuild_shard(0)
    sync(dev)
    rebuild_s = time.perf_counter() - t0
    rebuilt, _ = run(engine.search_batch)
    same(spmd, rebuilt, "rebuilt shard")
    log("mesh", path="engine spmd", n=ds.n, d=ds.x.shape[1],
        shards=1, mesh=engine.spmd_mesh_shape(),
        build_s=f"{build_s:.3f}", rebuild_s=f"{rebuild_s:.3f}",
        peak_memory=(torch.cuda.max_memory_allocated() - mem0 if cuda
                     else "not_measured"),
        queries=n_queries, spmd_qps=f"{n_queries / spmd_s:.2f}",
        spmd_repeat_qps=f"{n_queries / again_s:.2f}",
        host_qps=f"{n_queries / host_s:.2f}", routes=routes,
        spmd_traces=traces, bit_identical_to_host=True,
        fail_all_down_sentinel=True, rebuilt_equal=True,
        launches={k_: v for k_, v in launches.items() if v})
    return launches


def all_launchers() -> list:
    """The launch-counted wrapper of every kernel of the port."""
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda
    from repro_torch.kernels.filtered_topk import filtered_topk_cuda
    from repro_torch.kernels.gather_distance import gather_distance_cuda
    from repro_torch.kernels.neighbor_expand import neighbor_expand_cuda
    from repro_torch.kernels.pna_aggregate import pna_aggregate_cuda
    return [embedding_bag_cuda, filtered_topk_cuda, gather_distance_cuda,
            neighbor_expand_cuda, pna_aggregate_cuda]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one request per route, one "
                         "retrieval request, one PNA request, one engine "
                         "batch and one SPMD and one host-loop batch of the "
                         "mesh phase's engine with torch.profiler and print "
                         "where the device time goes")
    ap.add_argument("--baseline", metavar="DIR",
                    help="a directory holding an earlier gather_distance.cu, "
                         "neighbor_expand.cu, filtered_topk.cu and "
                         "pna_aggregate.cu: build them into a library of "
                         "their own and time them in turns with the port's "
                         "at the timed and path-captured shapes")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist
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
    from repro_torch.kernels.neighbor_expand import neighbor_expand_cuda

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
    # a one-rank NCCL group: the mesh paths (retrieve and mesh phases)
    # gather through it
    mesh_group(dev)

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
            torch.cuda.synchronize()
            err = assert_gather_close(
                got, gather_distance_ref(ids, qq, index.x, metric),
                f"gather_distance {metric} ({loads} loads)")
            log("kernels", kernel="gather_distance", metric=metric,
                loads=loads, max_abs_err=err)
            gd_err = max(gd_err, err)
    edge_err = check_gather_edges(dev)
    log("kernels", kernel="gather_distance", edge_cases=len(GD_EDGE_CASES)
        * 2, max_abs_err=edge_err)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    base = baseline_kernels(args.baseline) if args.baseline else None
    one = torch.zeros(1, device=dev)
    floor_ms = time_ms(one.zero_, ITERS, flush)
    log("kernels", launch_floor_ms=floor_ms,
        what="'one 1-element zero_() timed as the kernels are'")
    gd = measure_gather(ids, q, index.x, "l2", flush, base, "timed shape")
    gd["max_abs_err"] = max(gd_err, edge_err, gd["max_abs_err"])
    records.append(dict(
        name="gather_distance", route="cuda",
        source="src/repro_torch/csrc/gather_distance.cu",
        replaces="src/repro/kernels/gather_distance/kernel.py:61",
        launch_floor_ms=floor_ms, **gd))

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
    graph_calls = [(row, tbl, pos, pm, vis,
                    dict(strategy=strategy, m=M, m_beta=mb))
                   for strategy, row, tbl, pos, mb in cases]
    log("kernels", kernel="neighbor_expand",
        cases=check_expand(graph_calls, "graph rows"),
        edge_cases=check_expand(expand_edge_calls(dev), "edge case"),
        bit_identical=True)
    ne = measure_expand((row0, g.neighbors[0], g.pos[0], pm, vis),
                        dict(strategy="compress", m=M, m_beta=M_BETA), flush,
                        base, "timed shape")
    records.append(dict(
        name="neighbor_expand", route="cuda",
        source="src/repro_torch/csrc/neighbor_expand.cu",
        replaces="src/repro/kernels/neighbor_expand/kernel.py:157",
        launch_floor_ms=floor_ms, **ne))
    del vis
    topk_lcps = measure_filtered_topk(q, index.x, pm, TOPK_K, "l2", flush,
                                      base, "filtered_topk LCPS")
    check_filtered_topk_edges(dev)

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
            profile_call(lambda: index.search(SearchRequest(
                xq=requests[0].xq, predicates=requests[0].predicates, k=K,
                route=route)), route=route)

    # ---- parity: card (kernels) vs a CPU copy (plain versions) ----
    gsel = np.nonzero(routes == "graph")[0][:16]
    qs, ms = xq_all[gsel], masks[gsel]
    kw = dict(k=K, ef=EF, variant="acorn-gamma", m=M, m_beta=M_BETA,
              compressed_level0=True)
    ids_c, d_c, _ = hybrid_search(g, index.x, qs, ms, **kw)
    x_cpu = index.x.cpu()
    ids_h, d_h, _ = hybrid_search(g.to("cpu"), x_cpu, qs.cpu(), ms.cpu(),
                                  **kw)
    err, ties = assert_topk_match(ids_c, d_c, ids_h, d_h, qs.cpu(), x_cpu,
                                  "l2", "graph route card vs CPU")
    log("parity", queries=len(gsel), near_ties=ties, max_abs_err=err)

    # ---- hops: both kernels at shapes captured from one graph request ----
    hops, n_hops = capture_hops(index, SearchRequest(
        xq=requests[0].xq, predicates=requests[0].predicates, k=K,
        route="graph"))
    log("hops", level0_hops=n_hops, captured=list(HOPS[:len(hops)]))
    if not hops:
        raise AssertionError("no level-0 hop was captured")
    by_name = {r["name"]: r for r in records}
    for hop, (ne_args, ne_kw, gd_args) in zip(HOPS, hops):
        what = f"level-0 hop {hop}"
        by_name["neighbor_expand"].setdefault("other_shapes", []).append(
            dict(hop=hop, **measure_expand(ne_args, ne_kw, flush, base,
                                           what)))
        by_name["gather_distance"].setdefault("other_shapes", []).append(
            dict(hop=hop, **measure_gather(*gd_args, flush, base, what)))
    del hops

    # ---- baselines: Figure 7 beside ACORN-γ on the build phase's data ----
    t0 = time.perf_counter()
    built = baselines_build(dev, index.x, index.table.int_cols["label"])
    base_launches = baselines_search(
        dev, index.x, g, built, wl.xq[:B], masks_all[:B],
        np.array([p.value for p in wl.predicates[:B]]), gt[:B])
    for name in ("gather_distance", "neighbor_expand"):
        by_name[name]["baselines_launches"] = {
            method: cnt[name] for method, cnt in base_launches.items()}
    del built
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    log("parity", path="build_hnsw", rows=BASE_HNSW_ROWS, M=BASE_M,
        efc=BASE_EFC, **hnsw_build_parity(index.x[:BASE_HNSW_ROWS], BASE_M,
                                          BASE_EFC),
        seconds=f"{time.perf_counter() - t1:.1f}")
    log("baselines", seconds=f"{time.perf_counter() - t0:.1f}")

    # ---- incremental: Table 4's time to index ----
    t0 = time.perf_counter()
    incremental_phase(dev, index.x, wl.xq[:INC_QUERIES])
    log("incremental", seconds=f"{time.perf_counter() - t0:.1f}")

    rec, model = retrieve_phases(dev, flush, args.profile, base)
    rec["kernel_ms"] = rec["ms"]
    rec["other_shapes"] = [topk_lcps]
    records.append(rec)
    # at (512, 4) the launch floor, not the bytes bound, is the least time
    records.append(dict(bag_phases(dev, flush, model.user_emb),
                        launch_floor_ms=floor_ms))
    del model
    torch.cuda.empty_cache()
    records.append(pna_phases(dev, flush, args.profile, base, floor_ms))

    # ---- engine: HCPS serving at LAION-1M scale, four shards ----
    t0 = time.perf_counter()
    ds_e, engine = engine_build(dev)
    closed, kinds = engine_workloads(ds_e)
    engine_kernels(engine, closed, flush, base, by_name)
    engine_launches = engine_serving(dev, ds_e, engine, closed, kinds,
                                     args.profile)
    for name in ("gather_distance", "neighbor_expand"):
        if engine_launches[name] <= 0:
            raise AssertionError(f"{name} was not launched in the engine's "
                                 "closed loop")
        by_name[name]["engine_launches"] = engine_launches[name]
    del engine
    torch.cuda.empty_cache()
    log("engine", seconds=f"{time.perf_counter() - t0:.1f}")

    # ---- mesh: the SPMD engine, then the acorn arch at full width ----
    t0 = time.perf_counter()
    mesh_launches = mesh_engine(dev, ds_e, closed, profile=args.profile,
                                kernels=(flush, base, by_name))
    for name in ("gather_distance", "neighbor_expand"):
        if mesh_launches[name] <= 0:
            raise AssertionError(f"{name} was not launched in the SPMD "
                                 "engine's run")
        by_name[name]["mesh_launches"] = mesh_launches[name]
    # serve_25m holds 64.4 GB of inputs: free what the earlier phases hold
    del ds_e, closed, kinds, index, g, ds, wl, masks_all, masks, pm, q
    del ids, row0, row1, xq_all, ids_all, gt, results, requests
    torch.cuda.empty_cache()
    acorn_ms = acorn_serve(dev, "serve_1m", ((False, MESH_CHUNK),
                                             (True, MESH_CHUNK),
                                             (True, MESH_WIDE_CHUNK)), flush)
    torch.cuda.empty_cache()
    log("mesh", arch="acorn", shape="serve_25m", optimized=False,
        skipped="its (512, 3*2^23) fp32 score matrix alone is 51.5 GB, "
        "beside 64.4 GB of inputs")
    acorn_ms.update({("25m",) + k_: v for k_, v in acorn_serve(
        dev, "serve_25m", ((True, MESH_CHUNK), (True, MESH_WIDE_CHUNK)),
        flush).items()})
    torch.cuda.empty_cache()
    log("mesh", acorn_ms={str(k_): v for k_, v in acorn_ms.items()},
        seconds=f"{time.perf_counter() - t0:.1f}")
    dist.destroy_process_group()

    log("total", seconds=f"{time.perf_counter() - t_all:.1f}")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
