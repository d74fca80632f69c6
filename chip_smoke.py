#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py   # SIFT1M-shaped LCPS index (n = 1,000,000)
                            # with Figure 7's baselines and Table 4's
                            # incremental builds beside it,
                            # two-tower retrieval_cand (n = 1,048,576),
                            # embedding_bag, the train steps (two-tower
                            # train_batch at B = 65,536, PNA molecule,
                            # checkpoints, the launcher; PNA full_graph_sm,
                            # minibatch_lg, ogb_products; DIEN, SASRec and
                            # DCN-v2, every cell at FULL), PNA molecule
                            # inference, the
                            # sharded HCPS serving engine (n = 2^20) and
                            # the distributed paths on a one-rank NCCL
                            # mesh (acorn serve_1m and serve_25m, the
                            # SPMD engine), the five LM arches
                            # at full width (train_4k, prefill_32k,
                            # decode_32k; gemma3's long_500k), and last
                            # the perf twin's timed variants
    python3 chip_smoke.py --baseline DIR   # also time the gather_distance.cu,
                            # neighbor_expand.cu, filtered_topk.cu,
                            # pna_aggregate.cu and embedding_bag.cu in DIR
                            # (an earlier version) in turns with the port's
    python3 chip_smoke.py --profile        # also trace requests (device time
                            # and launches of each of the port's kernels)

Phases, each printed on its own line:

  device   the card's name and power limit (nvidia-smi); build the CUDA
           kernels from ``src/repro_torch/csrc`` (one nvcc per source, all
           started together) and print the build time; join a one-rank
           ``nccl`` process group (``HashStore``, rank 0 of 1, a 60 s
           collective timeout) and check that an all-gather of a CUDA
           tensor returns it (``mesh_group``); the group stays until the
           ``lm`` part has run.
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
           than k), each also on bf16 and fp16 copies of its corpus (q
           fp32, and q in the corpus dtype); then timed with CUDA events
           (with ``--baseline``, in turns with the earlier
           ``filtered_topk.cu``), and on bf16 and fp16 copies of the index's
           vectors beside the 16-bit matmul + mask + ``torch.topk``; k past
           256 (the select-and-sort path) at ``TOPK_LARGE_K_CASES`` (k = n
           with padding, 40,000 kept keys merged in global memory, integer
           ties), k = 257, 1,024, 4,096 at q (64, 128), x (131,072, 128)
           and k = n = 5,000 timed beside one matmul + mask +
           ``torch.topk``; neighbor_expand's global-set variant at
           ``NE_WIDE_CASES`` (m = 8,192 and 16,384 at cap = 128, past its
           227 KB shared-memory set) bit-identical, the two_hop cases
           timed.
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
           128 rows on the card and on a CPU copy: neighbour lists,
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
           padding, sum and mean, within rtol / atol 1e-5; timed beside
           one ``F.embedding_bag`` call of the same result (``bag_library``:
           sum weighted by ``ids >= 0``, mean over the valid ids with
           offsets); the same on bf16 and fp16 copies of the table (and of
           the edge cases' tables: the output in the table's dtype, within
           one unit in its last place times the bag's sum of |rows|),
           ``F.embedding_bag`` on the 16-bit table beside it (with
           ``--baseline``, each of these 12 timed in turns with the earlier
           ``embedding_bag.cu``: ``baseline_ms``, ``speedup``,
           ``bit_identical_to_baseline``, and the edge cases' bits against
           it in all three dtypes); then the op
           at those shapes (fp32) with the launch counters
           zeroed just before and read just after, and its gradient at
           (65,536, 4) against a CPU copy.  Then ``make_sharded_lookup``
           over that table on the one-rank mesh (``P("model", None)``,
           ids (65,536, 4) ``P("data", None)``, 25 % -1 and 1 % >= V):
           bit-identical to ``where(0 <= ids < V, table[ids], 0)``, no
           kernel launch, ms per call (``sharded_lookup_check``).
  train    the training core on the same FULL model (``train_phases``):
           two-tower ``train_batch`` at B = 65,536 (Zipf(1.1) items, logq
           their log-probabilities; ``zipf_batch``): one warm-up step, 10
           counted steps through the arch's step (p50 / max ms,
           examples/s, peak memory, the losses, finite), 2 steps timed in
           parts (forward+backward, ``adamw_update``); the first 4,096 rows
           against a CPU copy of the rows they touch (``step1_parity``:
           the copy runs on the card's ReLU branch, each unit flipped
           against float64 within 1e-5 of its call's largest input; loss
           within 1e-5; the card's path in float64 within 1e-9 of the
           CPU's float64 copy; every fp32 gradient within 4x the copy's
           own fp32 distance to its float64 run or 1e-5 relative L2; one
           ``adamw_update`` from the same gradients within rtol 1e-5, no
           gradient outside the touched rows) and the blocked loss against
           the plain one on the card; one more step plainly and through
           ``sharded_step`` with the arch's ``in_shardings`` on the
           one-rank mesh from a copy of the same state (parameters, both
           moments, step count and loss bit-identical; no launch;
           ``sharded_train``; on one rank nothing is gathered or cut, so
           the record's ``check`` reads "one-rank determinism": the
           sharding itself is tested on gloo ranks); ``compressed_psum``
           of that batch's ``user_emb`` gradient, with no error and then
           with the residual carried, bit for bit against a CPU copy's
           ``quantize_int8`` / ``dequantize_int8``, each error under
           0.05 of max |x| (``compressed_psum_check``).  PNA
           ``molecule`` (4 layers, d 75, 128 graphs of 30 nodes): step 1
           against a CPU copy as above, then 20 counted steps, then one
           through ``sharded_step`` as two-tower's.  Neither path may
           launch any of the port's kernels
           (``train_launches`` in the record).  A sync and an async
           checkpoint of the molecule state restored onto the card,
           bit-identical (the two-tower FULL state, 25.8 GB, is not
           written); ``python -m repro_torch.launch.train`` for two-tower
           at its reduced config, 20 steps, then resumed to 30: finite,
           falling losses.  Then, the two-tower model freed, PNA's sparse
           and minibatch cells (``pna_sparse_phases``), none launching a
           kernel: ``full_graph_sm`` at Cora's shape (2,708 nodes, 10,752
           edges of which 196 padding with dst -1, 140 labelled) with
           step 1 against CPU copies of the plain layer
           (``pna_layer_sparse_ref``) as above (the fp32 gradients with a
           1e-2 floor: a ReLU input within rounding of 0 may land on the
           other side) and the card's path in float64 against the CPU's
           float64 copy within 1e-9, then 20 counted steps;
           ``minibatch_lg``'s sampler on a uniform graph of Reddit's
           size (232,965 nodes, 114,615,892 edges; ``build_csr`` and
           ``sample_fanout`` of 1,024 seeds at fanouts (15, 10) timed
           once) and one step on the sampled block against CPU copies,
           then the cell's fixed-shape batch at 4 layers, 20 counted
           steps (layers 3-4: zero gradients, moved by weight decay
           alone); ``ogb_products`` on a 2^16-node, 2^20-edge cut of its
           law with ``EDGE_CHUNK`` 2^18 (4 chunks) against CPU copies,
           then at full size (2,449,408 nodes, 61,859,328 edges, 196,615
           labelled): a no-grad forward, a warm-up step whose loss must
           equal it within 1e-5, ``OGB_STEPS`` counted steps (finite,
           falling), peak
           memory and the data's host and transfer times.  Then the
           ``recsys`` part (``recsys_phases``): DIEN, SASRec and DCN-v2 at
           FULL width, weights from a seeded generator on the card, the
           traffic of each paper's data from a numpy seed (Zipf(1.1)
           items or ids; DIEN histories of 1-100 steps, 100 for the
           retrieval user, SASRec sequences of 2-50 left-padded, DCN-v2's
           13 dense and 26 sparse Criteo features), TF32 off.  Per arch:
           ``train_batch`` (B = 65,536) with step 1 on its first 4,096
           rows against CPU copies as two-tower's (``step1_parity``) and
           the blocked loss (DIEN's ``GRUScan``, SASRec's ``SampledLogits``)
           against its plain version on the card, then one warm-up and 5
           counted steps (losses finite and not rising); ``serve_p99``
           (B = 512, 10 calls) and ``serve_bulk`` (B = 262,144, 3 calls)
           with 64 rows against a CPU copy (rtol 1e-5, atol 1e-6);
           ``retrieval_cand`` (2^20 candidates, 2 calls after a warm-up)
           with 1,024 scores against a CPU copy, and for DCN-v2
           ``retrieve`` and ``retrieve_opt`` agreeing.  No kernel launches
           (``recsys_launches`` in the record).
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
           (``other_shapes`` entries with ``phase: engine``).  128
           ``contains`` queries through ``engine.serve`` in batches of 32
           after one warm-up batch, counters zeroed just before and read
           just after (``engine_launches`` of both records): QPS, batch
           times, route split, recall@10 per route against ``masked_topk``
           over the whole corpus, every returned id checked against its
           predicate; 32 queries of each of ``ENGINE_KINDS`` (the regex
           pass over 2^20 captions logged on its own line); the first 32
           queries of the closed loop and of each kind forced onto the
           graph route at ef 64 and 256, with the generator clusters their
           exact top-10 span (``graph_forced``); an open loop of
           32 requests of 4 queries through ``ServingRuntime`` at seeded
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
           the engine phase holds them on its own shard; the 128
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
  lm       the five LM arches (``lm_phases``) on a card the earlier phases
           have emptied (``memory_allocated`` logged first), each at FULL
           width (every published width, head count, expert count, top-k,
           window and vocabulary; bf16 weights, attention in fp32 as the
           reference's), depth cut in whole periods of the layer pattern
           and batch cut where a cell would not fit (``LM_CUTS``); token
           ids Zipf(1.1) over the vocabulary.  Per arch: step 1 of a
           one-period model (1 layer; gemma3 6) with the whole embedding,
           drawn in bf16 and cast to fp32 on the card, against an fp32
           CPU copy on 1 x 64 tokens (``lm_parity``: logits and loss
           within rtol 1e-5, gradients by the noise rule against float64
           on the card, a prefill and 3 decode steps, one
           ``adamw_update`` (the CPU holding the embedding's rows of the
           tokens and the last layer's attention and norms), the bf16
           train step against the fp32 one rounded to bf16; the bf16
           model's relative L2 and MoE routing flips recorded);
           ``train_4k`` (one warm-up and 3 counted steps: ms, tokens/s,
           peak memory, losses finite, the first update lowering the loss
           and later rises counted, 6·N·D); ``prefill_32k`` (a 1,024-token warm-up, one counted
           32,768-token call: ms, tokens/s, peak, the fp32 attention's
           FLOP count; MoE arches: two forwards with the same bits);
           ``decode_32k`` and gemma3's ``long_500k`` (a cache filled from
           the generator, 5 counted steps on its last rows: ms a step
           beside the bytes a step reads at 3.35 TB/s); launch counters
           zeroed before each counted run and read after: none of the
           port's kernels may launch (``lm_launches`` in the record).
           Per arch, on the one-rank mesh (``lm_sharded``, a one-rank
           determinism check as the train part's): the
           one-period fp32 model's train step through ``sharded_step``
           with ``in_shardings(cfg, "train_4k", mesh, layout)`` in both
           layouts, each from a fresh draw of the same weights, against
           the plain step (parameters, both moments, step count and
           loss compared by ``bits_digest``), then a prefill and one
           decode step with the ``prefill_32k`` / ``decode_32k`` specs
           (logits and cache bit-identical).  After gemma3, its model
           freed: ``split_kv_decode_attention`` at its ``long_500k``
           cache shape (q (2, 16, 128) fp32, k / v (2, 524,288, 16, 128)
           bf16; row 0 valid below 400,000, row 1 nowhere and exactly
           zero) within 1e-5 of a float64 softmax taken in chunks on
           the card, ms per call beside its bytes at 3.35 TB/s
           (``split_kv_check``).
  perf     the timed half of the perf twin (``repro_torch.launch.perf``;
           ``perf_phase``), after the process group is gone, launch
           counters zeroed just before and read just after
           (``perf_launches`` in the record): acorn ``serve_25m`` at rank
           0's block of the 16 x 16 mesh (98,304 rows, B = 512, d = 512):
           the baseline, the 8,192-row scan (ids equal, dists within
           1e-3), the scan over a bf16 corpus (top-10 overlap >= 0.9),
           ``filtered_topk`` on the block, then the step's merge (its
           kernel launched; ids equal but near ties, counted), and
           ``filtered_topk`` on a bf16 copy of the block (overlap >= 0.9;
           the entry the reference models); then ``filtered_topk`` alone
           at the block on fp32, bf16 and fp16 copies; DCN-v2
           ``retrieval_cand`` at FULL (``retrieve_opt`` within 1e-5 of
           ``retrieve``); smollm ``train_4k`` at ``PERF_SMOLLM`` (2
           layers, B = 1) with fp32 and bf16 logits (losses finite, within
           2e-2).  Each variant: one checked warm-up, the median of 5
           CUDA-event-timed calls, peak memory, and its shape counted on
           meta tensors (``flop_share`` asserted <= 1.05, ``byte_share``);
           one ``[perf]`` line a variant.  The 16 x 16 counts run in the
           twin's own command.
  roofline each timed step counted on meta tensors by
           ``repro_torch.launch.op_cost.OpCounter`` in a process of its own,
           started before the kernel build and waited for after it, before
           the first timed phase (no process group there; ~22 s of host
           time, logged as ``count_host_s`` beside ``waited_s``): the acorn
           variants but serve_25m's 8,192-row blocks, each LM arch's
           ``train_4k`` and ``prefill_32k`` at ``LM_CUTS``, two-tower
           ``train_batch``.
           One ``[roofline]`` line per step: counted FLOPs, the compute
           and memory terms at the H100's peaks
           (``repro_torch.launch.roofline``), ``flop_share = t_compute /
           measured`` (asserted <= 1.05: a step may not beat its counted
           FLOP time) and ``byte_share = t_memory / measured`` (not
           asserted: eager per-op bytes exceed HBM traffic where L2 keeps
           one op's output for the next).
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

# H100 SXM data-sheet peaks (dense), defined once in the port's roofline
from repro_torch.launch.roofline import (  # noqa: E402
    HBM_BYTES_PER_S, PEAK_BF16_PER_S, PEAK_FP32_PER_S,
    ROOFLINE_FLOP_SHARE_MAX)

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

# filtered_topk past the one-launch design's k <= 256 (the select-and-sort
# path), the same as CARD_LARGE_K in tests/test_torch_filtered_topk.py (case
# i drawn with seed i; "half" names a 16-bit corpus): k = 257, 1,024 and
# 4,096 at q (64, 128), x (131,072, 128), density 0.5, and k = n on a
# 5,000-row corpus with fewer passing rows (the first TOPK_LARGE_K_TIMED,
# timed); more kept keys than a CTA sorts in shared memory (merged in global
# memory), integer ties, scalar loads, a bf16 corpus
TOPK_LARGE_K_CASES = [
    dict(b=64, n=131_072, d=128, k=257),
    dict(b=64, n=131_072, d=128, k=1024),
    dict(b=64, n=131_072, d=128, k=4096),
    dict(b=3, n=5000, d=16, k=5000, p=0.3),
    dict(b=3, n=50_000, d=16, k=20_000, p=0.8),
    dict(b=2, n=45_000, d=4, k=40_000, p=1.1, ints=True),
    dict(b=2, n=64 * 2048, d=4, k=2048, p=1.1, ints=True, period=2048),
    dict(b=2, n=20_000, d=13, k=500, p=0.3),
    dict(b=2, n=2100, d=24, k=2000, half="bf16"),
]
TOPK_LARGE_K_TIMED = 4
# the 16-bit corpora (and tables) the kernels read as stored: filtered_topk
# at TOPK_EDGE_CASES, the LCPS shape (kernels phase) and the acorn block
# (perf phase); embedding_bag over a copy of the two-tower user table; one
# unit in the last place of each
HALF_DTYPES = {"bf16": "bfloat16", "fp16": "float16"}
HALF_ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}

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
    dict(b=9, l=3, v=40, d=600), dict(b=5, l=0, v=10, d=8),
    dict(b=64, l=33, v=500, d=256), dict(b=32, l=100, v=5000, d=256),
    dict(b=16, l=4, v=100, d=1024), dict(b=16, l=5, v=100, d=1028),
    dict(b=1, l=4, v=100, d=256), dict(b=131, l=4, v=1000, d=256),
    dict(b=8, l=40, v=300, d=256, kind="empty_bag"),
    dict(b=8, l=33, v=40, d=256, kind="clip")]

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
# `contains` queries, correlation none, seed 1 (cut from 1,024 to fit the
# run's time)
# closed-loop queries, and queries of each of ENGINE_KINDS (seed 2): cut
# from 512 and 64 (then 256) for the run's time
ENGINE_CLOSED = 128
ENGINE_KIND_QUERIES = 32
ENGINE_KINDS = (("between", "none"), ("contains+between", "none"),
                ("regex", "none"), ("contains", "pos"), ("contains", "neg"))
OPEN_REQUESTS, OPEN_SIZE = 256, 4   # open loop: requests of 4 queries
OPEN_LOAD = 0.5                     # of the closed loop's QPS
OVERLOAD_REQUESTS, OVERLOAD_QUEUE = 64, 64
ENGINE_PARITY = 16                  # graph-route queries on a CPU copy
# the first queries of the closed loop and of each kind, forced onto the
# graph route at each ef: does graph recall rise with the search's budget?
ENGINE_SWEEP_QUERIES, ENGINE_EF_SWEEP = 32, (64, 256)   # (cut from 64)

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
# host-driven); N_INC (was 2,048) and INC_PREFIX (was 256) are cut to fit
# the run's time
N_INC = 512                        # rows (cut from 1,024 for the run's time)
INC_VARIANTS = ("hnsw", "acorn-1", "acorn-gamma")
INC_EFC = 40                       # ef_build: 40; ACORN-γ 40·γ = 480
INC_QUERIES = 64
INC_PREFIX = 128                   # rows built on the card and on the CPU

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
# m past neighbor_expand's shared-memory dedup set (> 227 KB from m = 7,681
# at cap = 128): its global-set variant, the same as WIDE_CASES in
# tests/test_torch_neighbor_expand.py (case i drawn with seed i by
# expand_edge_inputs); the two two_hop cases (stream 16,512) are timed
NE_WIDE_CASES = [
    dict(strategy="two_hop", cap=128, m=8192, n=200_000),
    dict(strategy="two_hop", cap=128, m=16_384, n=200_000),
    dict(strategy="compress", cap=128, m=8192, m_beta=32, n=200_000),
]
NE_WIDE_TIMED = 2
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
    tb = bytes_moved / HBM_BYTES_PER_S * 1e3
    to = flops / PEAK_FP32_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def gather_distance_bound(ids, q, x) -> tuple:
    """``gather_distance_cost`` of this call's data: every distinct row
    the valid ids name read once, 3 flops per valid id and column."""
    from repro_torch.kernels.cost import gather_distance_cost
    valid = ids[ids >= 0]
    flops, byts = gather_distance_cost(
        *ids.shape, *x.shape, valid=int(valid.numel()),
        rows=int(valid.unique().numel()))
    return bound(byts, flops)


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
    ``filtered_topk.cu``, ``pna_aggregate.cu`` and ``embedding_bag.cu``
    from ``src_dir`` (the same C entry points; ``repro_embedding_bag``
    with the table's type code), built with the loader's flags into a
    library of their own and loaded beside the port's.  Earlier entry
    points are told apart by their sources: ``neighbor_expand`` with or
    without the global sets' ``set_ws``, ``filtered_topk`` with or without
    the per-query ``state`` buffer of the one-launch design and the
    ``q_type`` / ``x_type`` codes.  Returns (gather_distance, neighbor_expand,
    filtered_topk, pna_aggregate, embedding_bag) callables that take the
    launchers' arguments.  For timing a redesign against the kernels it
    replaced in one run."""
    import ctypes
    import torch
    from repro_torch.kernels import loader
    out = loader.BUILD_DIR / "baseline"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = loader._nvcc()
    names = ("gather_distance", "neighbor_expand", "filtered_topk",
             "pna_aggregate", "embedding_bag")
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

    def source(name):
        with open(os.path.join(src_dir, f"{name}.cu")) as f:
            return f.read()
    set_ws = "void* set_ws" in source("neighbor_expand")
    lib.repro_neighbor_expand.argtypes = ([p] * (7 if set_ws else 6)
                                          + [i] * 7 + [p])
    lib.repro_neighbor_expand.restype = i
    if set_ws:
        lib.repro_neighbor_expand_set_words.argtypes = [i, i]
        lib.repro_neighbor_expand_set_words.restype = ctypes.c_longlong
    topk_src = source("filtered_topk")
    with_state, typed = "void* state" in topk_src, "int q_type" in topk_src
    lib.repro_filtered_topk.argtypes = ([p] * (7 if with_state else 6)
                                        + [i] * (7 if typed else 5) + [p])
    lib.repro_filtered_topk.restype = i
    lib.repro_filtered_topk_workspace.argtypes = [i, i, i]
    lib.repro_filtered_topk_workspace.restype = ctypes.c_longlong
    lib.repro_pna_aggregate.argtypes = [p, p, p, i, i, i, p]
    lib.repro_pna_aggregate.restype = i
    lib.repro_embedding_bag.argtypes = [p, p, p] + [i] * 6 + [p]
    lib.repro_embedding_bag.restype = i
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
        sets = []                        # the global sets, when they are used
        if set_ws:
            words = lib.repro_neighbor_expand_set_words(row.shape[1], m)
            sets = [torch.empty(row.shape[0] * words, dtype=torch.int64,
                                device=row.device) if words else None]
        loader.check(lib.repro_neighbor_expand(
            row.data_ptr(), tbl.data_ptr(), pos.data_ptr(), ptr(pm),
            ptr(vis), out.data_ptr(), *map(ptr, sets), row.shape[0],
            row.shape[1], pos.shape[0], tbl.shape[0], m, m_beta,
            strategies[strategy], torch.cuda.current_stream().cuda_stream),
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
        codes = [loader.float_code(q), loader.float_code(x)] if typed else []
        loader.check(lib.repro_filtered_topk(
            *ptrs, b, n, x.shape[1], k, int(metric == "ip"), *codes,
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

    def bag(ids, table, mode):
        (b, l), (v, d) = ids.shape, table.shape
        out = torch.empty((b, d), dtype=table.dtype, device=table.device)
        loader.check(lib.repro_embedding_bag(
            ids.data_ptr(), table.data_ptr(), out.data_ptr(), b, l, v, d,
            int(mode == "mean"), loader.float_code(table),
            torch.cuda.current_stream().cuda_stream),
            "baseline embedding_bag")
        return out

    return gather, expand, topk, pna, bag


def same_bits(a, b) -> bool:
    """Equal shapes, dtypes and bits (-0.0 and NaN payloads included)."""
    import torch
    ints = {4: torch.int32, 2: torch.int16}
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(ints[a.element_size()]),
                            b.view(ints[b.element_size()])))


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


def expand_edge_calls(dev, cases=NE_EDGE_CASES):
    """``cases`` (NE_EDGE_CASES by default) as (row, tbl, pos, pm, vis,
    kw) on ``dev``."""
    import torch
    for ci, case in enumerate(cases):
        yield (*(torch.from_numpy(a).to(dev)
                 for a in expand_edge_inputs(**case, seed=ci)),
               dict(strategy=case["strategy"], m=case["m"],
                    m_beta=case.get("m_beta", 0)))


def check_expand_wide(dev, flush) -> list:
    """neighbor_expand's global-set variant (NE_WIDE_CASES) bit for bit
    against its plain version with and without the mask and the visited
    set, the first NE_WIDE_TIMED timed by ``measure_expand`` (no baseline:
    an earlier kernel may not take such m); returns their records."""
    calls = list(expand_edge_calls(dev, NE_WIDE_CASES))
    log("kernels", kernel="neighbor_expand",
        wide_cases=check_expand(calls, "wide m"), bit_identical=True)
    return [measure_expand(call[:5], call[5], flush, None,
                           f"global set, m={call[5]['m']}")
            for call in calls[:NE_WIDE_TIMED]]


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
    query and row), the rows that pass some query's mask (d elements
    each, of the corpus's dtype; a row no query passes need not be read),
    the queries and the (ids,
    dists) output; 2 d flops per passing (query, row) pair, plus 2 d per
    row read for |x|^2 under l2.  The dense figures (every row read and
    every pair scored) are returned beside it."""
    from repro_torch.kernels.cost import filtered_topk_cost
    b, n = mask.shape
    d = x.shape[1]
    rows = int(mask.any(dim=0).sum())
    sizes = dict(q_bytes=q.element_size(), x_bytes=x.element_size())
    flops, byts = filtered_topk_cost(b, n, d, k, metric, rows=rows,
                                     pairs=int(mask.sum()), **sizes)
    need, by = bound(byts, flops)
    # the dense figures: filtered_topk's own cost on meta tensors
    flops, byts = filtered_topk_cost(b, n, d, k, metric, rows=n,
                                     pairs=b * n, **sizes)
    dense, dense_by = bound(byts, flops)
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


def topk_case(case, seed, dev) -> tuple:
    """(q, x, mask, k) of an edge case on ``dev``; "half" makes x 16-bit."""
    import torch
    kw = dict(case)
    k = kw.pop("k")
    half = kw.pop("half", None)
    q, x, mask = (torch.from_numpy(a).to(dev)
                  for a in topk_inputs(**kw, seed=seed))
    if half is not None:
        x = x.to(getattr(torch, HALF_DTYPES[half]))
    return q, x, mask, k


def check_topk_cases(cases, dev, what: str, halves=(None,)) -> int:
    """The kernel against its plain version on the card at ``cases``, both
    metrics, with x in each dtype of ``halves`` (None: as drawn; a 16-bit
    corpus also with q in its dtype); returns the near ties."""
    import torch
    from repro_torch.kernels.filtered_topk import (filtered_topk_cuda,
                                                   filtered_topk_ref)
    ties = 0
    for ci, case in enumerate(cases):
        for half in halves:
            q, x, mask, k = topk_case(
                case if half is None else dict(case, half=half), ci, dev)
            qs = (q,) if x.dtype == torch.float32 else (q, q.to(x.dtype))
            for qq in qs:
                for metric in ("l2", "ip"):
                    got = filtered_topk_cuda(qq, x, mask, k, metric)
                    want = filtered_topk_ref(qq, x, mask, k, metric)
                    torch.cuda.synchronize()
                    ties += assert_topk_match(
                        *got, *want, qq.float(), x, metric,
                        f"filtered_topk {what} {case} {x.dtype} q "
                        f"{qq.dtype} {metric}")[1]
    return ties


def check_filtered_topk_edges(dev) -> int:
    """The kernel against its plain version on the card at
    TOPK_EDGE_CASES, both metrics, with the drawn fp32 corpus and its bf16
    and fp16 copies (q fp32, and q in the corpus dtype); returns the near
    ties."""
    ties = check_topk_cases(TOPK_EDGE_CASES, dev, "edge case")
    ties_16 = check_topk_cases(TOPK_EDGE_CASES, dev, "edge case",
                               tuple(HALF_DTYPES))
    log("kernels", kernel="filtered_topk", edge_cases=len(TOPK_EDGE_CASES) * 2,
        near_ties=ties, edge_cases_16bit=len(TOPK_EDGE_CASES) * 8,
        near_ties_16bit=ties_16)
    return ties + ties_16


def check_filtered_topk_large_k(dev, flush) -> list:
    """k past 256 (TOPK_LARGE_K_CASES, the select-and-sort path) against
    the plain version on the card, both metrics; the first
    TOPK_LARGE_K_TIMED timed at l2 by ``measure_filtered_topk`` beside one
    matmul + mask + ``torch.topk``; returns their records."""
    ties = check_topk_cases(TOPK_LARGE_K_CASES, dev, "k > 256")
    log("kernels", kernel="filtered_topk",
        large_k_cases=len(TOPK_LARGE_K_CASES) * 2, near_ties=ties)
    recs = []
    for ci, case in enumerate(TOPK_LARGE_K_CASES[:TOPK_LARGE_K_TIMED]):
        q, x, mask, k = topk_case(case, ci, dev)
        recs.append(measure_filtered_topk(
            q, x, mask, k, "l2", flush, None, f"filtered_topk k={k}",
            library=topk_addmm_library(q, x, mask, k)))
    return recs


def topk_addmm_library(q, x, mask, k: int) -> tuple:
    """(one matmul + mask + ``torch.topk`` computing filtered_topk's l2
    result in x's dtype, its description); its inputs (q in x's dtype,
    -|x|^2) are built here, outside the call."""
    import torch
    qx = q.to(x.dtype)
    neg_xn = -(x.float() ** 2).sum(dim=1).to(x.dtype)
    neg = float("-inf")
    return (lambda: torch.topk(torch.where(mask, torch.addmm(
                neg_xn, qx, x.T, alpha=2.0), neg), k),
            f"torch.topk(torch.where(mask, torch.addmm(-|x|^2, q, x.T, "
            f"alpha=2), -inf), k) in {str(x.dtype).split('.')[-1]}: 3 calls")


def measure_topk_16bit(q, x, mask, k: int, flush, what: str) -> list:
    """filtered_topk at l2 on bf16 and fp16 copies of the corpus ``x`` (q
    fp32), each measured by ``measure_filtered_topk`` beside the 16-bit
    matmul + mask + ``torch.topk``; returns their records."""
    import torch
    recs = []
    for name in HALF_DTYPES.values():
        xh = x.to(getattr(torch, name))
        recs.append(measure_filtered_topk(
            q, xh, mask, k, "l2", flush, None, f"{what} {name}",
            library=topk_addmm_library(q, xh, mask, k)))
        del xh
    return recs


def measure_filtered_topk(q, x, mask, k: int, metric: str, flush, base,
                          what: str, library=None) -> dict:
    """Kernel (and the baseline kernel, if given) vs plain version on the
    card, then the kernel (in turns with the baseline), the plain version
    and the library yardstick (``library``: a (call, description) pair;
    by default the fp32 matmul or cdist + mask + ``torch.topk``) timed with
    a cold L2."""
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
    if library is not None:
        library, calls = library
    elif metric == "ip":
        library = lambda: torch.topk(torch.where(mask, q @ x.T, neg), k)  # noqa: E731
        calls = "torch.topk(torch.where(mask, q @ x.T, -inf), k): 3 calls"
    else:
        library = lambda: torch.topk(  # noqa: E731
            torch.where(mask, -torch.cdist(q, x), neg), k)
        calls = ("torch.topk(torch.where(mask, -torch.cdist(q, x), -inf), "
                 "k): 4 calls")
    x_dtype = "" if x.dtype == torch.float32 else (
        f" x_dtype={str(x.dtype).split('.')[-1]}")
    rec = dict(
        shape=f"q({q.shape[0]},{q.shape[1]}) x({x.shape[0]},{x.shape[1]}) "
              f"k={k} {metric} mask_density={float(mask.float().mean()):.4f}"
              + x_dtype,
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
    """``pna_aggregate_cost`` of this adjacency's edges: adj and feats
    read once, the output written once, 7 operations per (edge,
    feature)."""
    from repro_torch.kernels.cost import pna_aggregate_cost
    flops, byts = pna_aggregate_cost(*feats.shape,
                                     edges=int((adj > 0).sum()))
    return bound(byts, flops)


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
    elif kind == "empty_bag":             # one bag of all -1 among others
        ids[b // 2, :] = -1
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


def assert_bag_match(got, want, ids, table, mode: str, what: str) -> float:
    """An fp32 table: ``assert_bag_close``.  A 16-bit table: the output in
    its dtype, within one unit in its last place times the bag's sum of
    |rows| (over the count for mean) of ``want`` (fp32 sums in another
    order before the one rounding); returns the largest |err|."""
    import torch
    if table.dtype == torch.float32:
        return assert_bag_close(got, want, what)
    if got.dtype != table.dtype:
        raise AssertionError(f"{what}: output {got.dtype}, table "
                             f"{table.dtype}")
    valid = ids >= 0
    rows = table[ids.clamp(0, table.shape[0] - 1).long()].float().abs()
    scale = (rows * valid[..., None]).sum(dim=1)
    if mode == "mean":
        scale = scale / valid.sum(dim=1, keepdim=True).clamp_min(1)
    gap = (got.float() - want.float()).abs()
    ulp = HALF_ULP[str(table.dtype).split(".")[-1]]
    if not bool((gap <= ulp * scale).all()):
        raise AssertionError(f"{what}: more than one unit in the last place "
                             "from the plain version")
    return float(gap.max()) if gap.numel() else 0.0


def embedding_bag_bound(ids, table, mode: str) -> tuple:
    """``embedding_bag_cost`` of this call's ids: each distinct row the
    valid ids name (clipped) read once and the output written once, at
    the table's element size; one add per valid id and column, plus a
    division per output under mean."""
    from repro_torch.kernels.cost import embedding_bag_cost
    v, d = table.shape
    valid = ids[ids >= 0]
    flops, byts = embedding_bag_cost(
        *ids.shape, d, mode, valid=int(valid.numel()),
        rows=int(valid.clamp(max=v - 1).unique().numel()),
        table_bytes=table.element_size())
    return bound(byts, flops)


def bag_library(ids, table, mode: str) -> tuple:
    """(one ``F.embedding_bag`` call computing ``embedding_bag_ref``'s
    result, its description); its inputs are built here, outside the
    call.  Sum weights each clamped id by ``ids >= 0``; mean takes the 1-D
    form over the valid ids only (a bag's offset is the count of valid ids
    before it; an empty bag gives zeros, as ``max(count, 1)`` does)."""
    import torch
    import torch.nn.functional as F
    v = table.shape[0]
    if mode == "sum":
        safe, w = ids.clamp(0, v - 1).long(), (ids >= 0).to(table.dtype)
        return (lambda: F.embedding_bag(safe, table, mode="sum",
                                        per_sample_weights=w),
                "F.embedding_bag(ids.clamp(0, V-1), table, mode='sum', "
                "per_sample_weights=(ids >= 0) in the table's dtype): 1 "
                "call")
    valid = ids >= 0
    flat = ids[valid].clamp(max=v - 1).long()
    offsets = torch.zeros(ids.shape[0], dtype=torch.long, device=ids.device)
    offsets[1:] = valid.sum(dim=1).cumsum(0)[:-1]
    return (lambda: F.embedding_bag(flat, table, offsets, mode="mean"),
            "F.embedding_bag(ids[ids >= 0].clamp(max=V-1), table, offsets "
            "of the valid ids, mode='mean'): 1 call")


def measure_embedding_bag(ids, table, mode: str, flush, base) -> dict:
    """Kernel (and the baseline kernel, if given: its bits) vs plain
    version on the card, then the kernel (in turns with the baseline), the
    plain version and the library yardstick (one ``F.embedding_bag`` call,
    held to the plain version too) timed with a cold L2."""
    import torch
    from repro_torch.kernels.embedding_bag import (embedding_bag_cuda,
                                                   embedding_bag_ref)
    b, l = ids.shape
    v, d = table.shape
    want = embedding_bag_ref(ids, table, mode)
    got = embedding_bag_cuda(ids, table, mode)
    err = assert_bag_match(got, want, ids, table, mode,
                           f"embedding_bag ({b}, {l}) {mode} {table.dtype}")
    same = {}
    if base is not None:
        same = dict(bit_identical_to_baseline=same_bits(
            got, base[4](ids, table, mode)))
    del got
    bound_ms, bound_by = embedding_bag_bound(ids, table, mode)
    rec = dict(
        shape=f"ids({b},{l}) table({v},{d}) {mode} "
              f"valid={float((ids >= 0).float().mean()):.4f}"
              + ("" if table.dtype == torch.float32 else
                 f" dtype={str(table.dtype).split('.')[-1]}"),
        max_abs_err=err,
        **time_in_turns(lambda: embedding_bag_cuda(ids, table, mode),
                        None if base is None else
                        lambda: base[4](ids, table, mode), flush),
        **same,
        plain_ms=time_ms(lambda: embedding_bag_ref(ids, table, mode),
                         ITERS // 5, flush),
        bound_ms=bound_ms, bound_by=bound_by)
    library, calls = bag_library(ids, table, mode)
    rec.update(
        library_ms=time_ms(library, ITERS // 5, flush),
        library_max_abs_err=assert_bag_match(library(), want, ids, table,
                                             mode, "F.embedding_bag"),
        library_calls=calls)
    log("kernels", kernel="embedding_bag", **{
        key: repr(v) if isinstance(v, str) else v for key, v in rec.items()})
    return rec


def bag_16bit(dev, flush, table, inputs, base) -> list:
    """embedding_bag on bf16 and fp16 tables: BAG_EDGE_CASES on 16-bit
    copies of their tables (with a baseline, its bits beside them), then a
    copy of ``table`` at ``inputs``, each mode, held to the plain version
    by ``assert_bag_match``; the latter measured by
    ``measure_embedding_bag`` beside one ``F.embedding_bag`` call on the
    16-bit table.  Returns their records."""
    import torch
    from repro_torch.kernels.embedding_bag import (embedding_bag_cuda,
                                                   embedding_bag_ref)
    from repro_torch.kernels.embedding_bag.ref import MODES
    recs, worst, differ = [], 0.0, []
    for name in HALF_DTYPES.values():
        dt = getattr(torch, name)
        for ci, case in enumerate(BAG_EDGE_CASES):
            ids, tab, _ = (torch.from_numpy(a).to(dev)
                           for a in bag_inputs(**case, seed=ci))
            tab = tab.to(dt)
            for mode in MODES:
                got = embedding_bag_cuda(ids, tab, mode)
                worst = max(worst, assert_bag_match(
                    got, embedding_bag_ref(ids, tab, mode), ids, tab, mode,
                    f"embedding_bag {case} {mode} {name}"))
                if base is not None and not same_bits(
                        got, base[4](ids, tab, mode)):
                    differ.append((ci, mode, name))
        half = table.to(dt)
        recs += [measure_embedding_bag(ids, half, mode, flush, base)
                 for ids in inputs for mode in MODES]
        del half
    log("kernels", kernel="embedding_bag", dtypes=list(HALF_DTYPES.values()),
        edge_cases_16bit=len(BAG_EDGE_CASES) * len(MODES) * 2,
        max_abs_err_16bit=worst,
        **({} if base is None else
           dict(edge_cases_16bit_not_bit_identical_to_baseline=differ)))
    return recs


def bag_phases(dev, flush, table, base) -> dict:
    """The embedding_bag op over ``table`` (the two-tower FULL user
    table): the kernel's checks and times (in turns with the baseline
    kernel, if given, and its bits beside them), the counted forward and
    gradient at the recsys shapes, and the CPU parity of the largest
    shape; returns embedding_bag's record."""
    import torch
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_cuda,
                                                   embedding_bag_ref)
    from repro_torch.kernels.embedding_bag.ref import MODES

    worst, differ = 0.0, []
    for ci, case in enumerate(BAG_EDGE_CASES):
        ids, tab, _ = (torch.from_numpy(a).to(dev)
                       for a in bag_inputs(**case, seed=ci))
        for mode in MODES:
            got = embedding_bag_cuda(ids, tab, mode)
            worst = max(worst, assert_bag_close(
                got, embedding_bag_ref(ids, tab, mode),
                f"embedding_bag {case} {mode}"))
            if base is not None and not same_bits(got,
                                                  base[4](ids, tab, mode)):
                differ.append((ci, mode))
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
        other_dtypes_raise=True,
        **({} if base is None else
           dict(edge_cases_not_bit_identical_to_baseline=differ)))

    v, d = table.shape
    rng = np.random.default_rng(5)
    inputs = []
    for b, l in BAG_SHAPES:
        ids = rng.integers(0, v, size=(b, l))
        ids[rng.random((b, l)) < BAG_PAD] = -1
        inputs.append(torch.as_tensor(ids.astype(np.int32), device=dev))
    recs = [measure_embedding_bag(ids, table, mode, flush, base)
            for ids in inputs for mode in MODES]
    recs += bag_16bit(dev, flush, table, inputs, base)

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
    del leaf, grads_in, table_cpu
    log("bag", **sharded_lookup_check(dev, table))
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
MESH_TIMED = 1              # timed calls a variant, after a warm-up (was 3)
MESH_EXACT_ROWS = 1 << 18   # rows per block of the fp64 recompute
MESH_ENGINE_QUERIES = ENGINE_CLOSED   # queries through each engine path
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
    args = arch.place_inputs(shape, mesh, x, q, masks)
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


# ---------------------------------------------------------------------------
# train: the training core on the two ported arches
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# sharded steps and the mesh collectives, on the one-rank mesh
# ---------------------------------------------------------------------------
# On one rank ``sharded_step`` gathers, copies and cuts nothing, and each
# collective reduces over one member: these checks show that the step runs
# from the arch's specs and is deterministic, and hold the collectives'
# local arithmetic to the plain formula.  Placing, gathering and cutting
# over several ranks are tested on gloo groups (tests/test_torch_sharding.py,
# tests/test_torch_collectives_mesh.py); the records say so in ``check``.
ONE_RANK_STEP = "one-rank determinism"
ONE_RANK_COLLECTIVE = "one-rank local arithmetic"

LOOKUP_SHAPE = (65_536, 4)      # make_sharded_lookup's ids: train_batch x 4
LOOKUP_PAD = 0.25               # of them -1
LOOKUP_OVER = 0.01              # and >= V (both read zeros)
PSUM_REL_TOL = 0.05             # compressed_psum: the reference test's bound
SPLIT_KV_SHAPE = (2, 524_288, 16, 128)  # gemma3 long_500k's (B, S, KV, hd)
SPLIT_KV_VALID = 400_000        # row 0's valid keys; row 1 has none
SPLIT_KV_CHUNK = 1 << 16        # sequence rows per float64 chunk
SPLIT_KV_TIMED = 3              # timed calls, after the checked one
SPLIT_KV_REDUCED = ((2, 1024, 4, 16), 800, 256)   # (shape, valid, chunk)
# digest weights: (i * a mod p) + 1 for element i, p = 2^31 - 1
DIGEST_P = (1 << 31) - 1
DIGEST_MULS = (48_271, 69_621)


def flat_outputs(tree, prefix: str = "") -> dict:
    """{path: tensor} of a step's arguments or outputs: a module's
    parameters by name, the fields of named tuples, dicts and tuples
    walked in order; other leaves left out."""
    import torch
    if isinstance(tree, torch.Tensor):
        return {prefix or ".": tree}
    if isinstance(tree, torch.nn.Module):
        return {prefix + k: p.detach() for k, p in tree.named_parameters()}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = zip(getattr(tree, "_fields", range(len(tree))), tree)
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(flat_outputs(v, f"{prefix}{k}."))
    return out


def bits_digest(t):
    """A digest of a 4-byte tensor's bits, an int64 (3,) tensor on its
    device: the exact sum of the elements' bit patterns read as unsigned
    32-bit ints, and two sums of those mod ``DIGEST_P`` weighted by each
    element's position (weights ``(i * a mod p) + 1``), ``NORM_CHUNK``
    elements at a time.  A change of one element always changes the first
    sum; changes that keep all three equal are a 2^-62 chance.  Up to 2^31
    elements (the exact sum stays below 2^63)."""
    import torch
    from repro_torch.train.optimizer import NORM_CHUNK
    if t.element_size() != 4 or t.numel() >= 1 << 31:
        raise ValueError(f"bits_digest takes < 2^31 4-byte elements, not "
                         f"{t.numel()} x {t.dtype}")
    flat = t.detach().contiguous().view(torch.int32).reshape(-1)
    out = torch.zeros(3, dtype=torch.int64, device=t.device)
    for start in range(0, flat.numel(), NORM_CHUNK):
        b = flat[start:start + NORM_CHUNK].to(torch.int64) & 0xFFFFFFFF
        out[0] += b.sum()
        b %= DIGEST_P
        i = torch.arange(start, start + b.numel(), device=t.device,
                         dtype=torch.int64)
        for j, a in enumerate(DIGEST_MULS, start=1):
            w = (i * a) % DIGEST_P + 1
            out[j] = (out[j] + (b * w % DIGEST_P).sum()) % DIGEST_P
    return out


def assert_bits_equal(got: dict, want: dict, what: str) -> int:
    """Every tensor of ``got`` equal to ``want``'s of the same path, bit for
    bit (dtype, shape and values, NaNs included); returns how many."""
    import torch
    if list(got) != list(want):
        raise AssertionError(f"{what}: outputs {list(got)} vs {list(want)}")
    for k, g in got.items():
        w = want[k]
        same = (g.dtype == w.dtype and g.shape == w.shape and torch.equal(
            *(t.reshape(-1).contiguous().view(torch.uint8) if t.numel()
              else t for t in (g, w))))
        if not same:
            raise AssertionError(f"{what}: {k} differs from the plain call's")
    return len(got)


def sharded_run(step, mesh, specs, args, what: str) -> tuple:
    """``sharded_step(step, mesh, specs)`` on ``place(args, specs, mesh)``,
    the launch counters zeroed just before and read just after (the
    paths it runs reach none of the port's kernels): (outputs, launches,
    seconds)."""
    from repro_torch.distributed.sharding import place, sharded_step
    blocks = place(args, specs, mesh)
    dev = next(iter(flat_outputs(args).values())).device
    sync(dev)
    counters = zero_launches()
    t0 = time.perf_counter()
    outs = sharded_step(step, mesh, specs)(*blocks)
    sync(dev)
    seconds = time.perf_counter() - t0
    return outs, check_no_launches(counters, what), seconds


def sharded_train(dev, arch_id: str, cfg, shape: str, model, opt, batch,
                  what: str) -> tuple:
    """One train step of the arch from (``model``, ``opt``) plainly, in
    place, and through ``sharded_step`` with ``in_shardings(cfg, shape,
    mesh)`` on ``make_host_mesh()`` from a copy of the same state: the
    parameters, both moments, the step count and the loss bit-identical.
    Returns (record, the plain step's AdamW state)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import set_named_params
    from repro_torch.train.optimizer import AdamWState
    arch = get_arch(arch_id)
    mesh = make_host_mesh()
    specs = arch.in_shardings(cfg, shape, mesh)
    step = arch.step_fn(cfg, shape)
    copy = set_named_params(arch.module(cfg), {
        k: p.detach().clone() for k, p in model.named_parameters()})
    copy_opt = AdamWState(step=opt.step.clone(),
                          mu={k: v.clone() for k, v in opt.mu.items()},
                          nu={k: v.clone() for k, v in opt.nu.items()})
    sync(dev)
    t0 = time.perf_counter()
    _, opt, loss = step(model, opt, batch)
    sync(dev)
    plain_s = time.perf_counter() - t0
    outs, launches, sharded_s = sharded_run(step, mesh, specs,
                                            (copy, copy_opt, batch), what)
    n = assert_bits_equal(flat_outputs(outs), flat_outputs(
        (model, opt, loss)), f"{what} sharded_step")
    del copy, copy_opt, outs
    rec = dict(path=f"{what} sharded_step", cell=shape,
               check=ONE_RANK_STEP,
               mesh=dict(zip(mesh.axis_names, mesh.shape)),
               bit_identical_tensors=n, plain_step_s=round(plain_s, 4),
               sharded_step_s=round(sharded_s, 4),
               sharded_launches=launches)
    return rec, opt


def compressed_psum_check(grad, what: str) -> dict:
    """``compressed_psum`` of ``grad`` over ``data`` of ``make_host_mesh()``
    with no error, then with the residual carried: each mean and residual,
    and the card's int8 codes and scale, equal a CPU copy's
    ``quantize_int8`` / ``dequantize_int8`` bit for bit; each mean within
    ``PSUM_REL_TOL`` (max |err| over max |value|, the reference test's
    measure) of the value it reduced.  The CPU copy holds the rows where
    ``grad`` is nonzero (a table's gradient touches the batch's rows
    only): elsewhere both are zero, which the card's outputs must be
    (copying a 4.3 GB table gradient and quantizing it on the host took
    35 s on the card's 8-core host)."""
    import torch
    from repro_torch.distributed.collectives import (compressed_psum,
                                                     dequantize_int8,
                                                     quantize_int8)
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh()
    t0 = time.perf_counter()
    mean1, err1 = compressed_psum(grad, mesh, "data")
    mean2, err2 = compressed_psum(grad, mesh, "data", error=err1)
    sync(grad.device)
    card_s = time.perf_counter() - t0
    q_card, s_card = quantize_int8(grad)
    flat = grad.reshape(grad.shape[0], -1)
    touched = (flat != 0).any(dim=1)
    rows = touched.nonzero().reshape(-1)
    for t in (mean1, err1, mean2, err2):
        if bool(t.reshape(flat.shape)[~touched].any()):
            raise AssertionError(f"{what} compressed_psum: nonzero output "
                                 "where the gradient is zero")
    x = grad[rows].cpu()
    rec = dict(path=f"{what} compressed_psum", check=ONE_RANK_COLLECTIVE,
               shape=tuple(grad.shape),
               rows_nonzero=int(rows.numel()), card_s=round(card_s, 4))
    for i, (mean, err) in enumerate(((mean1, err1), (mean2, err2)), 1):
        q, scale = quantize_int8(x)
        if i == 1:
            assert_bits_equal({"q": q_card[rows].cpu(),
                               "scale": s_card.cpu()},
                              {"q": q, "scale": scale}, f"{what} int8 codes")
            del q_card
        deq = dequantize_int8(q, scale)
        new_err = x - deq
        assert_bits_equal({"mean": mean[rows].cpu(), "error": err[rows].cpu()},
                          {"mean": deq, "error": new_err},
                          f"{what} compressed_psum call {i}")
        rel = float((deq - x).abs().max() / x.abs().max().clamp_min(1e-30))
        if not rel < PSUM_REL_TOL:
            raise AssertionError(f"{what} compressed_psum call {i}: error "
                                 f"{rel} >= {PSUM_REL_TOL}")
        rec[f"call{i}_rel_err"] = rel
        rec[f"call{i}_scale"] = float(scale.reshape(()))
        x = x + new_err                 # the second call reduces x + error
    rec["bit_identical_to_cpu"] = True
    rec["seconds"] = round(time.perf_counter() - t0, 3)
    return rec


def sharded_lookup_check(dev, table) -> dict:
    """``make_sharded_lookup`` over ``table`` (V, D) on ``make_host_mesh()``
    (the table cut ``P("model", None)``, the ids ``P("data", None)``): ids
    ``LOOKUP_SHAPE`` uniform over the rows, ``LOOKUP_PAD`` of them -1 and
    ``LOOKUP_OVER`` >= V; the result bit-identical to ``where(0 <= ids <
    V, table[ids], 0)``; launch counters zeroed just before and read just
    after (none); ms per call."""
    import torch
    from repro_torch.distributed.collectives import make_sharded_lookup
    from repro_torch.distributed.sharding import P, place
    from repro_torch.launch.mesh import make_host_mesh
    v, d = table.shape
    rng = np.random.default_rng(7)
    ids = rng.integers(0, v, size=LOOKUP_SHAPE)
    r = rng.random(LOOKUP_SHAPE)
    ids[r < LOOKUP_PAD] = -1
    over = (r >= LOOKUP_PAD) & (r < LOOKUP_PAD + LOOKUP_OVER)
    ids[over] = v + rng.integers(0, v, size=int(over.sum()))
    ids = torch.as_tensor(ids.astype(np.int32), device=dev)
    mesh = make_host_mesh()
    lookup = make_sharded_lookup(mesh, "data", "model")
    tab_l, ids_l = place((table, ids), (P("model", None), P("data", None)),
                         mesh)
    sync(dev)
    counters = zero_launches()
    t0 = time.perf_counter()
    got = lookup(tab_l, ids_l)
    sync(dev)
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = check_no_launches(counters, "make_sharded_lookup")
    ok = (ids >= 0) & (ids < v)
    want = torch.where(ok[..., None], table[ids.clamp(0, v - 1).long()],
                       table.new_zeros(()))
    assert_bits_equal({"out": got}, {"out": want}, "make_sharded_lookup")
    rec = dict(path="make_sharded_lookup", check=ONE_RANK_COLLECTIVE,
               table=(v, d),
               ids=LOOKUP_SHAPE, padding=int((ids < 0).sum()),
               over_v=int((ids >= v).sum()), bit_identical=True,
               first_call_ms=round(first_ms, 3), sharded_launches=launches)
    if dev.type == "cuda":
        flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
        rec["ms"] = time_ms(lambda: lookup(tab_l, ids_l), 10, flush)
    return rec


def split_kv_check(dev, shape=SPLIT_KV_SHAPE, valid_rows=SPLIT_KV_VALID,
                   chunk=SPLIT_KV_CHUNK) -> dict:
    """``split_kv_decode_attention`` over ``data`` of ``make_host_mesh()``
    at a long-context decode cache: q (B, H, hd) fp32 (normal, scaled by
    hd^-0.5), k / v (B, S, H, hd) bf16 normal from a seeded generator on
    ``dev``; row 0 valid below ``valid_rows``, row 1 nowhere, which must
    come back exactly zero.  The output within rtol ``LM_TOL`` (and an atol
    of ``LM_TOL`` times its largest |value|) of a float64 softmax taken on
    ``dev`` over ``chunk``-row chunks of the sequence; ms per call beside
    the bytes read at 3.35 TB/s."""
    import torch
    from repro_torch.distributed.collectives import split_kv_decode_attention
    from repro_torch.distributed.sharding import P, place
    from repro_torch.launch.mesh import make_host_mesh
    b, s, h, hd = shape
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 7)
    q = torch.randn((b, h, hd), generator=gen, device=dev) * hd ** -0.5
    k = torch.randn((b, s, h, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn((b, s, h, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    valid = torch.zeros((b, s), dtype=torch.bool, device=dev)
    valid[0, :valid_rows] = True
    mesh = make_host_mesh()
    attn = split_kv_decode_attention(mesh, "data")
    seq = P(None, "data")
    args = place((q, k, v, valid), (P(), seq, seq, seq), mesh)
    mem0 = reset_peak(dev)
    sync(dev)
    counters = zero_launches()
    t0 = time.perf_counter()
    out = attn(*args)
    sync(dev)
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = check_no_launches(counters, "split_kv_decode_attention")
    peak = peak_memory(dev, mem0)
    if bool(out[1].any()):
        raise AssertionError("split-KV: a query with no valid key is not 0")
    # float64 on dev, chunk by chunk: the max, then the sums
    q64 = q.double()
    m = torch.full((b, h), float("-inf"), dtype=torch.float64, device=dev)
    for c in range(0, s, chunk):
        sc = torch.einsum("bhd,bshd->bhs", q64, k[:, c:c + chunk].double())
        sc = sc.masked_fill(~valid[:, None, c:c + chunk], float("-inf"))
        m = torch.maximum(m, sc.amax(dim=-1))
    z = torch.zeros((b, h), dtype=torch.float64, device=dev)
    wv = torch.zeros((b, h, hd), dtype=torch.float64, device=dev)
    for c in range(0, s, chunk):
        keep = valid[:, None, c:c + chunk]
        sc = torch.einsum("bhd,bshd->bhs", q64, k[:, c:c + chunk].double())
        e = torch.exp(sc - m[..., None]).masked_fill(~keep, 0.0)
        z += e.sum(dim=-1)
        wv += torch.einsum("bhs,bshd->bhd", e, v[:, c:c + chunk].double())
    want = (wv / z.clamp_min(1e-30)[..., None])[0].cpu()
    err = assert_lm_close(out[0], want, "split-KV decode attention")
    nbytes = (k.numel() * k.element_size() * 2 + valid.numel()
              + q.numel() * 4 + out.numel() * 4)
    rec = dict(path="split_kv_decode_attention", check=ONE_RANK_COLLECTIVE,
               q=tuple(q.shape),
               kv=tuple(k.shape), kv_dtype="bfloat16", valid_rows=valid_rows,
               empty_row_zero=True, max_abs_err=err,
               first_call_ms=round(first_ms, 3), bytes_read=nbytes,
               bytes_bound_ms=round(nbytes / HBM_BYTES_PER_S * 1e3, 4),
               sharded_launches=launches, **peak)
    if dev.type == "cuda":
        flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
        rec["ms"] = time_ms(lambda: attn(*args), SPLIT_KV_TIMED, flush,
                            warmup=0)
    return rec


TRAIN_SEED = 8
TRAIN_STEPS = 10            # two-tower train_batch steps, after one warm-up
TRAIN_SPLIT = 2             # more steps timed in parts: fwd+bwd, adamw_update
TRAIN_PARITY_ROWS = 4096    # rows of the batch held to a CPU copy
ZIPF_EXPONENT = 1.1         # item popularity of the sampled-softmax batches
PNA_TRAIN_STEPS = 20
LAUNCHER_STEPS = (20, 30)   # the launcher's run, then its resume to 30
# the card's gradient may stand this far (relative L2) from the CPU copy's
# when the CPU copy's own fp32 rounding (against float64) is below it
GRAD_REL_FLOOR = 1e-5
GRAD_NOISE_FACTOR = 4.0
# Step 1 of the recsys arches (two-tower and the recsys part) on a CPU
# copy.  A ReLU input within fp32 rounding of 0 may land on the other side
# on the card and then moves whole gradient rows: on an NVIDIA H100 80GB
# HBM3 at 700.00 W one unit of two-tower's first user-tower layer put its
# user_emb and first-layer gradients 1.9e-3 (relative L2) from the CPU
# copy's, where the copy stood 1.6e-6 from float64.  So the CPU copies take
# the card's ReLU branch (``relu_branch``), every unit where that branch
# differs from float64's must have a float64 input within RELU_FLIP_TOL of
# its call's largest |input|, and the gradients keep GRAD_REL_FLOOR.  The
# card's path also runs in float64, held to the CPU float64 copy within
# RECSYS_FP64_TOL.
RELU_FLIP_TOL = 1e-5
RECSYS_FP64_TOL = 1e-9


def zipf_batch(cfg, b: int, seed: int) -> dict:
    """A numpy ``train_batch`` of ``b`` rows, the YouTube sampled-softmax
    traffic: users and their feature ids uniform over ``n_users``, items
    drawn from a Zipf law (exponent ``ZIPF_EXPONENT``) over ``n_items``
    (popularity ranks shuffled over the ids), ``logq`` the log of each
    drawn item's probability."""
    rng = np.random.default_rng(seed)
    p = np.arange(1, cfg.n_items + 1, dtype=np.float64) ** -ZIPF_EXPONENT
    p /= p.sum()
    rank = rng.choice(cfg.n_items, size=b, p=p)
    item_of_rank = rng.permutation(cfg.n_items)
    return {"user_id": rng.integers(0, cfg.n_users, size=b, dtype=np.int32),
            "user_feats": rng.integers(0, cfg.n_users,
                                       size=(b, cfg.n_user_feats),
                                       dtype=np.int32),
            "item_id": item_of_rank[rank].astype(np.int32),
            "logq": np.log(p[rank]).astype(np.float32)}


def reset_peak(dev) -> int:
    """Reset the peak-memory counter; returns the bytes allocated now (0 on
    the CPU), which the peak then includes."""
    import torch
    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def peak_memory(dev, start: int) -> dict:
    """Peak device memory since :func:`reset_peak` (``start`` bytes were
    allocated then), or None on the CPU."""
    import torch
    if dev.type != "cuda":
        return dict(peak_memory_bytes=None, peak_above_start_bytes=None)
    peak = torch.cuda.max_memory_allocated(dev)
    return dict(peak_memory_bytes=peak, peak_above_start_bytes=peak - start)


def grad_parity(card: dict, cpu: dict, cpu64, rows: dict,
                what: str, floor: float = GRAD_REL_FLOOR) -> dict:
    """Gradients of the card against a CPU copy's, the copy's own fp32
    rounding measured against its float64 run ``cpu64`` (on any device):
    for each parameter the relative L2 distance card-to-CPU must stay
    within ``GRAD_NOISE_FACTOR`` times the CPU's distance to float64, or
    ``floor``; with ``cpu64=None``, within ``floor``.  ``rows`` names, per
    table, the card rows the copy holds.  The distances run in float64 on
    the card's device, ``NORM_CHUNK`` elements at a time, relative to the
    float64 gradient's norm (without it, the CPU's).  Returns the worst
    ratios and elementwise errors."""
    import itertools
    from repro_torch.train.optimizer import NORM_CHUNK
    out = {}
    for k, g in card.items():
        g = (g[rows[k]] if k in rows else g).detach()

        def parts(t):
            return (c.to(g.device).double()
                    for c in t.reshape(-1).split(NORM_CHUNK))
        s, err_max = np.zeros(3), 0.0
        for gc, hc, tc in zip(parts(g), parts(cpu[k]),
                              itertools.repeat(None) if cpu64 is None
                              else parts(cpu64[k])):
            tc = hc if tc is None else tc
            s += [float(((gc - hc) ** 2).sum()),
                  float(((hc - tc) ** 2).sum()), float((tc ** 2).sum())]
            err_max = max(err_max, float((gc - hc).abs().max()))
        norm = float(np.sqrt(s[2])) or 1.0
        err_card = float(np.sqrt(s[0])) / norm
        err_cpu = None if cpu64 is None else float(np.sqrt(s[1])) / norm
        limit = max(floor, GRAD_NOISE_FACTOR * (err_cpu or 0.0))
        if not err_card <= limit:
            raise AssertionError(
                f"{what} gradient {k}: card vs CPU {err_card:.3g} > "
                f"{limit:.3g} (CPU fp32 vs float64 {err_cpu})")
        out[k] = (err_card, err_cpu, err_max)
    worst = max(out, key=lambda k: out[k][0])
    return dict(worst_param=worst, worst_rel_l2=out[worst][0],
                cpu_fp32_vs_fp64=out[worst][1],
                max_rel_l2=max(v[0] for v in out.values()),
                max_abs_err=max(v[2] for v in out.values()))


def update_parity(model, state, cpu_model, cpu_state, rows: dict,
                  what: str, keys=None) -> float:
    """Parameters and moments after one ``adamw_update`` from the same
    gradients on the card and on a CPU copy: within rtol 1e-5 and an atol
    of 1e-6 of each tensor's largest magnitude (the same arithmetic; the
    global norm's sum runs in another order), compared on the card.
    ``cpu_model`` (a module or a mapping of named parameters) holds the
    parameters named ``keys`` (by default every one of ``model``'s), and
    ``rows`` names, per table, the card rows the copy holds.  Returns the
    largest |err|."""
    import torch
    from repro_torch.train.optimizer import named_tensors
    card = {"param": dict(model.named_parameters()), "mu": state.mu,
            "nu": state.nu}
    cpu = {"param": named_tensors(cpu_model), "mu": cpu_state.mu,
           "nu": cpu_state.nu}
    want = set(card["param"] if keys is None else keys)
    for part, held in cpu.items():
        if set(held) != want or not want:
            raise AssertionError(f"{what}: the CPU copy's {part} holds "
                                 f"{sorted(held)}, not {sorted(want)}")
    worst = 0.0
    for part in card:
        for k, want in cpu[part].items():
            t = card[part][k].detach()
            got = t[rows[k]] if k in rows else t
            want = want.detach().to(got.device)
            atol = 1e-6 * float(want.abs().max())
            if not torch.allclose(got, want, rtol=1e-5, atol=atol):
                over = (got - want).abs() - 1e-5 * want.abs()
                i = int(over.argmax())
                raise AssertionError(
                    f"{what}: {part} {k} after adamw_update differs card vs "
                    f"CPU: {float(got.flatten()[i])} vs "
                    f"{float(want.flatten()[i])} (atol {atol:.3g})")
            worst = max(worst, float((got - want).abs().max()))
    if int(state.step) != int(cpu_state.step):
        raise AssertionError(f"{what}: step counts differ")
    return worst


def zero_launches() -> list:
    counters = all_launchers()
    for fn in counters:
        fn.launches = 0
    return counters


def check_no_launches(counters, what: str) -> dict:
    """The train path reaches none of the port's kernels (its PNA step runs
    the plain aggregator, the two-tower lookups are plain gathers)."""
    launches = {fn.__name__: fn.launches for fn in counters}
    if any(launches.values()):
        raise AssertionError(f"{what} launched a kernel: {launches}")
    return launches


def relu_branch(card=None, seen=None):
    """A ``TorchFunctionMode`` over ``torch.relu``: each call's input is
    appended to ``seen`` (when given); with ``card``, the inputs of a run
    on the card call by call, the i-th call takes the card's branch: its
    input where ``card[i] > 0`` and 0 elsewhere, the gradient likewise."""
    import torch
    from torch.overrides import TorchFunctionMode
    relus = (torch.relu, torch.nn.functional.relu, torch.Tensor.relu)

    class Branch(TorchFunctionMode):
        calls = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func not in relus:
                return func(*args, **(kwargs or {}))
            x = args[0]
            if seen is not None:
                seen.append(x.detach().clone())
            if card is None:
                return func(*args, **(kwargs or {}))
            z = card[self.calls]
            self.calls += 1
            if z.shape != x.shape:
                raise AssertionError(f"ReLU call {self.calls}: input "
                                     f"{tuple(x.shape)}, the card's "
                                     f"{tuple(z.shape)}")
            return torch.where((z > 0).to(x.device), x, x.new_zeros(()))

    return Branch()


def two_tower_train(dev, model, cfg, b: int, steps: int = TRAIN_STEPS,
                    split: int = TRAIN_SPLIT,
                    parity_rows: int = TRAIN_PARITY_ROWS) -> dict:
    """The two-tower ``train_batch`` step on ``model``: one warm-up step,
    ``steps`` counted steps through the arch's step (step ms, examples/s,
    peak memory, the loss of each step, which must be finite), ``split``
    steps timed in their parts, then the first ``parity_rows`` rows of the
    batch against a CPU copy of the rows they touch (:func:`step1_parity`)
    and the blocked loss against the plain one on ``dev``."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.recsys import in_batch_softmax, \
        in_batch_softmax_ref
    from repro_torch.train import adamw_update, init_adamw, value_and_grad

    arch = get_arch("two-tower-retrieval")
    step = arch.step_fn(cfg, "train_batch")
    loss_fn = arch.loss_fn(cfg, "train_batch")
    t0 = time.perf_counter()
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in zipf_batch(cfg, b, TRAIN_SEED).items()}
    data_s = time.perf_counter() - t0
    mem0 = reset_peak(dev)
    t0 = time.perf_counter()
    opt = init_adamw(model)
    _, opt, loss0 = step(model, opt, batch)            # warm-up
    sync(dev)
    warm_s = time.perf_counter() - t0
    counters = zero_launches()
    ms, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        _, opt, loss = step(model, opt, batch)
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches = check_no_launches(counters, "two-tower train_batch")
    fwd_bwd, upd = [], []
    for _ in range(split):
        t0 = time.perf_counter()
        _, grads = value_and_grad(loss_fn, model, batch)
        sync(dev)
        t1 = time.perf_counter()
        _, opt = adamw_update(arch.opt, grads, opt, model)
        sync(dev)
        fwd_bwd.append((t1 - t0) * 1e3)
        upd.append((time.perf_counter() - t1) * 1e3)
        del grads
    peak = peak_memory(dev, mem0)
    if not all(np.isfinite([float(loss0)] + losses)):
        raise AssertionError(f"two-tower train loss not finite: {losses}")
    ms_a = np.array(ms)
    fb, up = float(np.median(fwd_bwd)), float(np.median(upd))
    rec = dict(batch=b, steps=steps, data_s=round(data_s, 3),
               warmup_step_s=round(warm_s, 3),
               step_p50_ms=round(float(np.percentile(ms_a, 50)), 3),
               step_max_ms=round(float(ms_a.max()), 3),
               examples_per_s=round(b / np.percentile(ms_a, 50) * 1e3, 1),
               fwd_bwd_ms=round(fb, 3), adamw_ms=round(up, 3),
               fwd_bwd_share=round(fb / (fb + up), 4),
               adamw_share=round(up / (fb + up), 4),
               **peak, loss_warmup=float(loss0),
               losses=[round(v, 6) for v in losses],
               kernel_launches=launches)
    log("train", arch="two-tower-retrieval", shape="train_batch", **rec)

    # parity: the first rows on a CPU copy of the rows they touch
    sub = {k: v[:parity_rows] for k, v in batch.items()}
    opt, par = step1_parity(dev, "two-tower-retrieval", model, opt, sub,
                            "two-tower")
    # the blocked loss against the plain one on the card
    with torch.no_grad():
        u = model.user_embed(sub)
        v = model.item_embed(sub["item_id"])
    u.requires_grad_()
    v.requires_grad_()
    blk = in_batch_softmax(u, v, sub["logq"], 0.05)
    ref = in_batch_softmax_ref(u, v, sub["logq"], 0.05)
    gb = torch.autograd.grad(blk, (u, v))
    gr = torch.autograd.grad(ref, (u, v))
    blk, ref = float(blk.detach()), float(ref.detach())
    blk_err = abs(blk - ref)
    if not blk_err <= 1e-6 * abs(ref) + 1e-7:
        raise AssertionError(f"blocked loss {blk} vs plain {ref}")
    g_err = 0.0
    for a, w in zip(gb, gr):
        scale = max(1.0, float(w.abs().max()))
        if not torch.allclose(a, w, rtol=1e-5, atol=1e-6 * scale):
            raise AssertionError("blocked loss gradient vs plain")
        g_err = max(g_err, float((a - w).abs().max()))
    log("parity", path="two-tower train_batch", rows=parity_rows, **par,
        blocked_vs_plain_loss_err=blk_err, blocked_vs_plain_grad_err=g_err)
    rec.update(parity_loss_card=par["loss_card"],
               parity_loss_cpu=par["loss_cpu"])
    del u, v, gb, gr
    # the same step through sharded_step, then compressed_psum on the
    # user table's gradient of that batch
    shard, opt = sharded_train(dev, "two-tower-retrieval", cfg,
                               "train_batch", model, opt, batch, "two-tower")
    log("train", **shard)
    _, grads = value_and_grad(loss_fn, model, batch)
    grad = grads.pop("user_emb")
    del grads
    psum = compressed_psum_check(grad, "two-tower user_emb gradient")
    del grad
    log("train", **psum)
    rec.update(sharded=shard, compressed_psum=psum)
    return rec


def pna_train(dev, reduced: bool = False, b: int = None,
              steps: int = PNA_TRAIN_STEPS) -> tuple:
    """The PNA ``molecule`` train step (plain aggregator, as the reference
    trains): step 1 on the card against a CPU copy (loss, gradients beside
    the copy's float64 run, one ``adamw_update`` from the same gradients),
    then ``steps`` counted steps through the arch's step: step ms, peak
    memory, the losses.  Returns (record, model, AdamW state)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.pna import PNA_SHAPES, REDUCED_SHAPES

    arch = get_arch("pna")
    cfg = arch.config(reduced=reduced, shape="molecule")
    spec = (REDUCED_SHAPES if reduced else PNA_SHAPES)["molecule"]
    b = b or spec["batch"]
    n = spec["n_nodes"]
    model = arch.init(cfg, torch.Generator(device=dev).manual_seed(
        TRAIN_SEED), device=dev)
    adj, feats = molecule_graphs(b, n, cfg.d_in, seed=TRAIN_SEED)
    labels = np.random.default_rng(TRAIN_SEED).integers(
        0, cfg.n_classes, size=b).astype(np.int32)
    batch = {"feats": torch.from_numpy(feats).to(dev),
             "adj": torch.from_numpy(adj).to(dev),
             "labels": torch.from_numpy(labels).to(dev)}
    opt, _ = pna_step_parity(dev, model, arch.loss_fn(cfg, "molecule",
                                                      reduced=reduced),
                             batch, "dense", "pna molecule", graphs=b)
    mem0 = reset_peak(dev)
    opt, ms, losses, launches = counted_steps(
        dev, arch.step_fn(cfg, "molecule", reduced=reduced), model, opt,
        batch, steps, "PNA molecule train")
    ms_a = np.array(ms[1:] or ms)
    rec = dict(graphs=b, n_nodes=n, layers=cfg.n_layers,
               d_hidden=cfg.d_hidden, steps=steps,
               first_step_ms=round(ms[0], 3),
               step_p50_ms=round(float(np.percentile(ms_a, 50)), 3),
               step_max_ms=round(float(ms_a.max()), 3),
               graphs_per_s=round(b / np.percentile(ms_a, 50) * 1e3, 1),
               **peak_memory(dev, mem0),
               losses=[round(v, 6) for v in losses],
               kernel_launches=launches)
    log("train", arch="pna", shape="molecule", **rec)
    shard, opt = sharded_train(dev, "pna", cfg, "molecule", model, opt,
                               batch, "pna molecule")
    log("train", **shard)
    rec["sharded"] = shard
    return rec, model, opt


def checkpoint_roundtrip(dev, model, opt) -> dict:
    """Save ``(parameters, AdamW state)`` with a synchronous and an async
    ``CheckpointManager``, restore each onto ``dev`` and require every
    tensor bit-identical (dtype and device too)."""
    import tempfile
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.train.optimizer import named_tensors

    tree = (named_tensors(model), opt)
    want = _flatten(tree)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for mode in ("sync", "async"):
            mgr = CheckpointManager(os.path.join(d, mode), keep=1,
                                    async_save=mode == "async")
            t0 = time.perf_counter()
            mgr.save(1, tree, extra={"note": mode})
            mgr.wait()
            t1 = time.perf_counter()
            restored, step = mgr.restore(tree, device=dev)
            sync(dev)
            t2 = time.perf_counter()
            got = _flatten(restored)
            if step != 1 or list(got) != list(want):
                raise AssertionError(f"{mode} checkpoint: keys or step differ")
            for k, t in want.items():
                r = got[k]
                if (r.device.type != dev.type or r.dtype != t.dtype
                        or not torch.equal(r, t)):
                    raise AssertionError(f"{mode} checkpoint: {k} differs")
            out[mode] = dict(save_s=round(t1 - t0, 4),
                             restore_s=round(t2 - t1, 4))
        nbytes = sum(t.numel() * t.element_size() for t in want.values())
    log("train", checkpoint="pna molecule (parameters, AdamW state)",
        tensors=len(want), bytes=nbytes, bit_identical=True,
        restored_on=dev.type, **out)
    log("train", checkpoint="two-tower FULL state not written",
        why="'parameters and AdamW moments are 25.8 GB: minutes of disk "
            "writes and more disk than the machine may have'")
    return out


def launcher_run(dev) -> dict:
    """``python -m repro_torch.launch.train`` for two-tower at its reduced
    config: ``LAUNCHER_STEPS[0]`` steps with a checkpoint directory, then
    the same command resumed to ``LAUNCHER_STEPS[1]``; the losses must be
    finite and fall."""
    import tempfile
    from repro_torch.launch.train import main as train_main

    with tempfile.TemporaryDirectory() as d:
        argv = ["--arch", "two-tower-retrieval", "--ckpt-dir", d,
                "--ckpt-every", "10", "--device", dev.type]
        first = train_main(argv + ["--steps", str(LAUNCHER_STEPS[0])])
        resumed = train_main(argv + ["--steps", str(LAUNCHER_STEPS[1])])
    losses = first["losses"] + resumed["losses"]
    if not np.isfinite([v for _, v in losses]).all():
        raise AssertionError(f"launcher losses not finite: {losses}")
    if resumed["steps"] != LAUNCHER_STEPS[1] - LAUNCHER_STEPS[0] or \
            resumed["losses"][0][0] != LAUNCHER_STEPS[0]:
        raise AssertionError("the launcher did not resume from its "
                             "checkpoint")
    if not losses[-1][1] < losses[0][1]:
        raise AssertionError(f"launcher loss did not fall: {losses}")
    rec = dict(steps=LAUNCHER_STEPS, losses=losses,
               seconds=[round(first["seconds"], 3),
                        round(resumed["seconds"], 3)])
    log("train", path="launch.train two-tower-retrieval (reduced)", **rec)
    return rec


def train_phases(dev, model, reduced: bool = False) -> dict:
    """The ``train`` phase: two-tower ``train_batch`` on ``model`` (B =
    65,536; the REDUCED batch with ``reduced``), PNA ``molecule``, a
    checkpoint round trip of the molecule state and the launcher with a
    resume."""
    from repro_torch.configs.recsys_common import (RECSYS_SHAPES,
                                                   REDUCED_RECSYS_SHAPES)
    shapes = REDUCED_RECSYS_SHAPES if reduced else RECSYS_SHAPES
    t0 = time.perf_counter()
    tt = two_tower_train(dev, model, model.cfg,
                         shapes["train_batch"]["batch"])
    pna, pna_model, pna_opt = pna_train(dev, reduced=reduced)
    checkpoint_roundtrip(dev, pna_model, pna_opt)
    launcher = launcher_run(dev)
    seconds = time.perf_counter() - t0
    log("train", seconds=f"{seconds:.1f}")
    return dict(two_tower=tt, pna=pna, launcher=launcher, seconds=seconds)


# ---------------------------------------------------------------------------
# pna_sparse: PNA's sparse and minibatch train cells
# ---------------------------------------------------------------------------

SPARSE_SEED = 9
SPARSE_STEPS = 20      # counted full_graph_sm and minibatch_lg steps
OGB_STEPS = 2          # counted ogb_products steps, after one warm-up (was 5)
# The sparse cells' step-1 parity.  Their fp32 gradients may also differ
# from the CPU copy's where a ReLU input lies within fp32 rounding of 0
# and lands on the other side: on the sampled Reddit block one such
# element (pre-activation 6.4e-8 in float64, <= 0 on the card) moved
# layer 2's gradients by 1.1e-3 (relative L2) while the CPU copy's fp32
# stood 1.8e-7 from float64.  So the card's code path also runs in float64,
# held to the CPU float64 copy within SPARSE_FP64_TOL, and the fp32
# gradients keep the noise rule with a floor of SPARSE_GRAD_FLOOR.
SPARSE_FP64_TOL = 1e-9
SPARSE_GRAD_FLOOR = 1e-2
# each cell's graph at full size and REDUCED: the real nodes and edges (the
# rest padding: edges with dst -1, nodes without edges or labels) and the
# labelled nodes (full_graph_sm: Cora's 140; ogb_products: the 196,615 of
# ogbn-products' train split); src and dst uniform over the real nodes
SPARSE_GRAPHS = {
    False: {"full_graph_sm": dict(real_nodes=2_708, real_edges=10_556,
                                  labelled=140),
            "ogb_products": dict(real_nodes=2_449_029,
                                 real_edges=61_859_140, labelled=196_615)},
    True: {"full_graph_sm": dict(real_nodes=200, real_edges=790,
                                 labelled=40),
           "ogb_products": dict(real_nodes=290, real_edges=1_190,
                                labelled=60)}}
# ogb_products' parity cut (nodes, edges, EDGE_CHUNK: 4 chunks) of the
# same law, its model the cell's.  Cut from 2^18 nodes and 2^22 edges, whose
# CPU copies (fp32 and float64, the plain layer) took 142 s on the card's
# 8-core host, nearly all of the 150 s this part may add to the run
OGB_CUT = {False: (1 << 16, 1 << 20, 1 << 18), True: (96, 400, 100)}
# the sampler's graph (Reddit: nodes, edges), its seeds and fanouts
REDDIT = {False: dict(nodes=232_965, edges=114_615_892, seeds=1_024,
                      fanouts=(15, 10)),
          True: dict(nodes=3_000, edges=30_000, seeds=32, fanouts=(3, 2))}


def sparse_batch(dev, n: int, e: int, d_feat: int, classes: int,
                 real_nodes: int, real_edges: int, labelled: int,
                 seed: int) -> tuple:
    """A sparse cell's batch on ``dev``: src / dst uniform over the real
    nodes from numpy generators, the padding edges' dst -1 (src 0);
    features normal from a ``torch.Generator`` on ``dev`` (padding nodes
    zero); labels uniform over the classes; ``label_mask`` 1 on
    ``labelled`` real nodes drawn without replacement.  Returns (batch,
    host seconds generating, seconds moving to ``dev``)."""
    import torch
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    src = np.zeros(e, np.int32)
    dst = np.full(e, -1, np.int32)
    src[:real_edges] = rng.integers(0, real_nodes, real_edges, dtype=np.int32)
    dst[:real_edges] = rng.integers(0, real_nodes, real_edges, dtype=np.int32)
    labels = rng.integers(0, classes, n, dtype=np.int32)
    mask = np.zeros(n, np.float32)
    mask[rng.choice(real_nodes, labelled, replace=False)] = 1.0
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in (
        ("src", src), ("dst", dst), ("labels", labels), ("label_mask", mask))}
    gen = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.zeros((n, d_feat), device=dev)
    feats[:real_nodes].normal_(generator=gen)
    batch["feats"] = feats
    sync(dev)
    return batch, host_s, time.perf_counter() - t0


def pna_copy(model, batch: dict, dtype) -> tuple:
    """A CPU copy of a PNA ``model`` and its ``batch`` in ``dtype``."""
    import dataclasses
    from repro_torch.models.gnn import PNA, set_pna_params

    def c(t):
        return t.detach().cpu().to(dtype).clone()
    cpu = set_pna_params(PNA(dataclasses.replace(model.cfg, dtype=dtype)),
                         c(model.enc), c(model.dec),
                         [(c(lp.w_msg), c(lp.w_upd)) for lp in model.layers])
    return cpu, {k: (v.cpu().to(dtype) if v.is_floating_point() else v.cpu())
                 for k, v in batch.items()}


def plain_loss(regime: str):
    """The loss of a PNA regime on the plain layer (``pna_layer_sparse_ref``,
    every (E, F) tensor at once, the reference op for op), for the CPU
    copies; ``dense``: the arch's own (the plain aggregator)."""
    from repro_torch.models.common import cross_entropy
    from repro_torch.models.gnn import (forward_minibatch, loss_dense,
                                        loss_sparse, pna_layer_sparse_ref,
                                        take_rows)
    if regime == "dense":
        return lambda m, b: loss_dense(m.cfg, m, b["feats"], b["adj"],
                                       b["labels"], use_kernel=False)
    if regime == "sparse":
        return lambda m, b: loss_sparse(
            m.cfg, m, b["feats"], b["src"], b["dst"], b["labels"],
            b["label_mask"], layer=pna_layer_sparse_ref)
    return lambda m, b: cross_entropy(take_rows(forward_minibatch(
        m.cfg, m, b["feats"], [(b["src2"], b["dst2"]), (b["src1"], b["dst1"])],
        b["feats"].shape[0], layer=pna_layer_sparse_ref), b["seed_idx"]),
        b["labels"])


def pna_step_parity(dev, model, loss_fn, batch: dict, regime: str,
                    what: str, sparse: bool = False, **logged) -> tuple:
    """Step 1 of a PNA cell on ``dev`` against CPU copies running the plain
    version (``plain_loss``): the loss within rtol 1e-5 of the fp32 copy's,
    the gradients beside the copy's float64 run (``grad_parity``), one
    ``adamw_update`` from the card's gradients on both (``update_parity``;
    ``model`` takes that step).  ``sparse``: the card's path also runs in
    float64 and must give the CPU float64 copy's loss and gradients
    within ``SPARSE_FP64_TOL`` (relative L2), and the fp32 gradients are
    held with the floor ``SPARSE_GRAD_FLOOR``.  Returns (AdamW state, CPU
    seconds)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.train import adamw_update, init_adamw, value_and_grad
    opt_cfg = get_arch("pna").opt
    loss_c, grads_c = value_and_grad(loss_fn, model, batch)
    t0 = time.perf_counter()
    cpu, cpu_batch = pna_copy(model, batch, torch.float32)
    loss_h, grads_h = value_and_grad(plain_loss(regime), cpu, cpu_batch)
    cpu64, batch64 = pna_copy(model, batch, torch.float64)
    loss_64, grads_64 = value_and_grad(plain_loss(regime), cpu64, batch64)
    cpu_s = time.perf_counter() - t0
    if not abs(float(loss_c) - float(loss_h)) <= 1e-5 * abs(float(loss_h)):
        raise AssertionError(f"{what} loss card {float(loss_c)} vs CPU "
                             f"{float(loss_h)}")
    fp64 = None
    if sparse:       # the card's code path in float64: an exact check
        card64 = cpu64.to(dev)
        loss_c64, grads_c64 = value_and_grad(
            loss_fn, card64, {k: v.to(dev) for k, v in batch64.items()})
        fp64 = max([abs(float(loss_c64) - float(loss_64))
                    / abs(float(loss_64))]
                   + [float((g.cpu() - grads_64[k]).norm())
                      / (float(grads_64[k].norm()) or 1.0)
                      for k, g in grads_c64.items()])
        if not fp64 <= SPARSE_FP64_TOL:
            raise AssertionError(f"{what} in float64: card vs CPU {fp64:.3g}"
                                 f" > {SPARSE_FP64_TOL}")
        del card64, grads_c64
    del cpu64, batch64
    gpar = grad_parity(grads_c, grads_h, grads_64, {}, what,
                       floor=SPARSE_GRAD_FLOOR if sparse else GRAD_REL_FLOOR)
    opt, cpu_opt = init_adamw(model), init_adamw(cpu)
    _, opt = adamw_update(opt_cfg, grads_c, opt, model)
    _, cpu_opt = adamw_update(opt_cfg, {k: g.cpu() for k, g in
                                        grads_c.items()}, cpu_opt, cpu)
    upd_err = update_parity(model, opt, cpu, cpu_opt, {}, what)
    log("parity", path=f"{what} train step 1", **logged,
        loss_card=float(loss_c), loss_cpu=float(loss_h),
        loss_fp64=float(loss_64), gradients=gpar,
        **({} if fp64 is None else dict(card_fp64_vs_cpu_fp64=fp64)),
        adamw_update_max_abs_err=upd_err, cpu_s=round(cpu_s, 3))
    return opt, cpu_s


def counted_steps(dev, step, model, opt, batch, steps: int, what: str,
                  check=None) -> tuple:
    """``steps`` steps of ``step`` with the launch counters zeroed just
    before and read just after (none may launch); ``check(opt)`` after
    each.  Returns (AdamW state, step ms, losses, launches)."""
    counters = zero_launches()
    ms, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        _, opt, loss = step(model, opt, batch)
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        if check:
            check(opt)
    launches = check_no_launches(counters, what)
    if not np.isfinite(losses).all():
        raise AssertionError(f"{what} loss not finite: {losses}")
    return opt, ms, losses, launches


def step_stats(ms) -> dict:
    ms_a = np.array(ms[1:] or ms)
    return dict(first_step_ms=round(ms[0], 3),
                step_p50_ms=round(float(np.percentile(ms_a, 50)), 3),
                step_max_ms=round(float(ms_a.max()), 3))


def sparse_cell_train(dev, shape: str, reduced: bool = False,
                      steps: int = SPARSE_STEPS) -> dict:
    """``full_graph_sm`` (or another sparse cell) at its shape: the batch
    of ``sparse_batch``, step 1 against CPU copies (``pna_step_parity``),
    then ``steps`` counted steps: step ms, peak memory, the losses."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.pna import PNA_SHAPES, REDUCED_SHAPES
    arch = get_arch("pna")
    spec = (REDUCED_SHAPES if reduced else PNA_SHAPES)[shape]
    cfg = arch.config(reduced=reduced, shape=shape)
    batch, host_s, move_s = sparse_batch(
        dev, spec["n_nodes"], spec["n_edges"], spec["d_feat"],
        spec["classes"], seed=SPARSE_SEED, **SPARSE_GRAPHS[reduced][shape])
    model = arch.init(cfg, torch.Generator(device=dev).manual_seed(
        SPARSE_SEED), device=dev)
    loss_fn = arch.loss_fn(cfg, shape, reduced=reduced)
    opt, _ = pna_step_parity(dev, model, loss_fn, batch, "sparse",
                             f"pna {shape}", sparse=True,
                             n_nodes=spec["n_nodes"], n_edges=spec["n_edges"])
    mem0 = reset_peak(dev)
    opt, ms, losses, launches = counted_steps(
        dev, arch.step_fn(cfg, shape, reduced=reduced), model, opt, batch,
        steps, f"PNA {shape} train")
    rec = dict(n_nodes=spec["n_nodes"], n_edges=spec["n_edges"],
               d_feat=spec["d_feat"], layers=cfg.n_layers,
               d_hidden=cfg.d_hidden, steps=steps, data_host_s=round(host_s, 3),
               data_move_s=round(move_s, 3), **step_stats(ms),
               **peak_memory(dev, mem0), losses=[round(v, 6) for v in losses],
               kernel_launches=launches)
    log("train", arch="pna", shape=shape, **rec)
    return rec


def reddit_sampler(dev, reduced: bool = False) -> dict:
    """``minibatch_lg``'s real sampler at Reddit scale: a numpy-seeded
    uniform graph, ``build_csr`` and ``sample_fanout`` timed on the host
    (one run each), the block's node and edge counts; then one step of the
    cell's model on the sampled block (unpadded, as the reference's
    ``test_pna_neighbor_sampler_real``) against CPU copies."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.pna import PNA_SHAPES, REDUCED_SHAPES
    from repro_torch.models.gnn import build_csr, sample_fanout
    arch = get_arch("pna")
    g = REDDIT[reduced]
    spec = (REDUCED_SHAPES if reduced else PNA_SHAPES)["minibatch_lg"]
    cfg = arch.config(reduced=reduced, shape="minibatch_lg")
    t0 = time.perf_counter()
    rng = np.random.default_rng(SPARSE_SEED)
    src = rng.integers(0, g["nodes"], g["edges"], dtype=np.int32)
    dst = rng.integers(0, g["nodes"], g["edges"], dtype=np.int32)
    seeds = rng.choice(g["nodes"], g["seeds"], replace=False).astype(np.int32)
    t1 = time.perf_counter()
    indptr, indices = build_csr(g["nodes"], src, dst)
    del src, dst
    t2 = time.perf_counter()
    nodes, blocks, seed_idx = sample_fanout(indptr, indices, seeds,
                                            g["fanouts"], rng)
    t3 = time.perf_counter()
    del indptr, indices
    (s2, d2), (s1, d1) = blocks
    labels = rng.integers(0, spec["classes"], len(seed_idx), dtype=np.int32)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in (
        ("src2", s2), ("dst2", d2), ("src1", s1), ("dst1", d1),
        ("seed_idx", seed_idx), ("labels", labels))}
    batch["feats"] = torch.randn(
        (len(nodes), spec["d_feat"]), device=dev,
        generator=torch.Generator(device=dev).manual_seed(SPARSE_SEED))
    model = arch.init(cfg, torch.Generator(device=dev).manual_seed(
        SPARSE_SEED), device=dev)
    counters = zero_launches()
    _, cpu_s = pna_step_parity(
        dev, model, arch.loss_fn(cfg, "minibatch_lg", reduced=reduced), batch,
        "minibatch", "pna minibatch_lg sampled block", sparse=True,
        block_nodes=len(nodes), hop_edges=(len(s2), len(s1)))
    launches = check_no_launches(counters, "PNA sampled block")
    rec = dict(graph_nodes=g["nodes"], graph_edges=g["edges"],
               seeds=g["seeds"], fanouts=g["fanouts"],
               data_host_s=round(t1 - t0, 3), build_csr_s=round(t2 - t1, 3),
               sample_fanout_s=round(t3 - t2, 3), block_nodes=len(nodes),
               hop_edges=(len(s2), len(s1)), seed_rows=len(seed_idx),
               parity_cpu_s=round(cpu_s, 3), kernel_launches=launches)
    log("train", arch="pna", shape="minibatch_lg", part="sampler", **rec)
    return rec


def minibatch_cell(dev, reduced: bool = False,
                   steps: int = SPARSE_STEPS) -> dict:
    """``minibatch_lg``'s fixed-shape batch at full depth (4 layers, two
    blocks): seeds are block rows 0..S-1, hop 1 draws f1 sources per seed,
    hop 2 f2 per hop-1 source, uniform over the block's rows, as the
    sampler's blocks are laid out.  Layers 3-4 must get zero gradients;
    ``steps`` counted steps, after each of which their moments must still
    be zero and their weights must have moved by weight decay alone."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.pna import PNA_SHAPES, REDUCED_SHAPES
    from repro_torch.train import init_adamw, value_and_grad
    from repro_torch.train.optimizer import schedule
    arch = get_arch("pna")
    spec = (REDUCED_SHAPES if reduced else PNA_SHAPES)["minibatch_lg"]
    cfg = dataclasses.replace(arch.config(reduced, "minibatch_lg"),
                              n_layers=4)
    nb, (e2, e1), f1, f2 = (spec["block_nodes"], spec["hop_edges"],
                            *spec["fanouts"])
    seeds = spec["seeds"]
    rng = np.random.default_rng(SPARSE_SEED)
    src1 = rng.integers(0, nb, seeds * f1, dtype=np.int32)
    src2 = rng.integers(0, nb, seeds * f1 * f2, dtype=np.int32)
    arrays = {"src1": src1, "dst1": np.repeat(np.arange(seeds, dtype=np.int32),
                                              f1),
              "src2": src2, "dst2": np.repeat(src1, f2),
              "seed_idx": np.arange(seeds, dtype=np.int32),
              "labels": rng.integers(0, spec["classes"], seeds,
                                     dtype=np.int32)}
    if (len(arrays["src1"]), len(arrays["src2"])) != (e1, e2):
        raise AssertionError("minibatch_lg's hop edges are not seeds x f1 "
                             "and seeds x f1 x f2")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
    batch["feats"] = torch.randn(
        (nb, spec["d_feat"]), device=dev,
        generator=torch.Generator(device=dev).manual_seed(SPARSE_SEED))
    model = arch.init(cfg, torch.Generator(device=dev).manual_seed(
        SPARSE_SEED), device=dev)
    loss_fn = arch.loss_fn(cfg, "minibatch_lg", reduced=reduced)
    _, grads = value_and_grad(loss_fn, model, batch)
    unused = [f"layers.{i}.{w}" for i in (2, 3) for w in ("w_msg", "w_upd")]
    for k, gr in grads.items():
        if bool(gr.any()) == (k in unused):
            raise AssertionError(f"minibatch_lg gradient {k}: zero should "
                                 f"be exactly layers 3-4's ({unused})")
    del grads
    params = dict(model.named_parameters())
    prev = {k: params[k].detach().clone() for k in unused}
    worst = [0.0]

    def decay_only(opt):
        lr = schedule(arch.opt, opt.step)
        for k in unused:
            want = prev[k] - (prev[k] * arch.opt.weight_decay) * lr
            now = params[k].detach()
            if (opt.mu[k].any() or opt.nu[k].any() or torch.equal(now, prev[k])
                    or not torch.allclose(now, want, rtol=1e-6, atol=0)):
                raise AssertionError(f"minibatch_lg {k} moved by more than "
                                     "weight decay")
            worst[0] = max(worst[0], float((now - want).abs().max()))
            prev[k] = now.clone()

    mem0 = reset_peak(dev)
    _, ms, losses, launches = counted_steps(
        dev, arch.step_fn(cfg, "minibatch_lg", reduced=reduced), model,
        init_adamw(model), batch, steps, "PNA minibatch_lg train",
        check=decay_only)
    rec = dict(block_nodes=nb, hop_edges=(e2, e1), seeds=seeds,
               d_feat=spec["d_feat"], layers=cfg.n_layers,
               d_hidden=cfg.d_hidden, steps=steps, **step_stats(ms),
               **peak_memory(dev, mem0), losses=[round(v, 6) for v in losses],
               layers_3_4_zero_grad=True,
               layers_3_4_decay_max_abs_err=worst[0],
               kernel_launches=launches)
    log("train", arch="pna", shape="minibatch_lg", part="fixed-shape cell",
        **rec)
    return rec


def ogb_parity(dev, reduced: bool = False) -> dict:
    """``ogb_products``' model on a cut of its law (``OGB_CUT``: nodes,
    edges; the padding shares of the full graph): the card's streamed,
    checkpointed path with ``EDGE_CHUNK`` lowered so that 4 chunks run,
    against CPU copies of the plain layer in fp32 and float64."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.pna import PNA_SHAPES, REDUCED_SHAPES
    from repro_torch.models import gnn
    arch = get_arch("pna")
    spec = (REDUCED_SHAPES if reduced else PNA_SHAPES)["ogb_products"]
    full = SPARSE_GRAPHS[reduced]["ogb_products"]
    cfg = arch.config(reduced=reduced, shape="ogb_products")
    n, e, chunk = OGB_CUT[reduced]
    law = dict(real_nodes=n - round(n * (1 - full["real_nodes"]
                                         / spec["n_nodes"])),
               real_edges=e - round(e * (1 - full["real_edges"]
                                         / spec["n_edges"])),
               labelled=round(n * full["labelled"] / spec["n_nodes"]))
    batch, _, _ = sparse_batch(dev, n, e, spec["d_feat"], spec["classes"],
                               seed=SPARSE_SEED, **law)
    model = arch.init(cfg, torch.Generator(device=dev).manual_seed(
        SPARSE_SEED), device=dev)
    before = gnn.EDGE_CHUNK
    gnn.EDGE_CHUNK = chunk
    try:
        counters = zero_launches()
        _, cpu_s = pna_step_parity(
            dev, model, arch.loss_fn(cfg, "ogb_products", reduced=reduced),
            batch, "sparse", "pna ogb_products cut", sparse=True, n_nodes=n,
            n_edges=e, edge_chunk=chunk, chunks=-(-e // chunk), **law)
        launches = check_no_launches(counters, "PNA ogb_products cut")
    finally:
        gnn.EDGE_CHUNK = before
    return dict(n_nodes=n, n_edges=e, edge_chunk=chunk, cpu_s=cpu_s,
                kernel_launches=launches, **law)


def ogb_train(dev, reduced: bool = False, steps: int = OGB_STEPS) -> dict:
    """``ogb_products`` at its full size: the graph of ``sparse_batch``
    (data generation and the move to ``dev`` timed), a no-grad forward's
    loss, one warm-up step (its loss, computed under the checkpoints,
    within rtol 1e-5 of the no-grad one), ``steps`` counted steps: step
    ms, peak memory, the losses, finite and falling."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.pna import PNA_SHAPES, REDUCED_SHAPES
    from repro_torch.train import init_adamw
    arch = get_arch("pna")
    spec = (REDUCED_SHAPES if reduced else PNA_SHAPES)["ogb_products"]
    cfg = arch.config(reduced=reduced, shape="ogb_products")
    batch, host_s, move_s = sparse_batch(
        dev, spec["n_nodes"], spec["n_edges"], spec["d_feat"],
        spec["classes"], seed=SPARSE_SEED,
        **SPARSE_GRAPHS[reduced]["ogb_products"])
    model = arch.init(cfg, torch.Generator(device=dev).manual_seed(
        SPARSE_SEED), device=dev)
    loss_fn = arch.loss_fn(cfg, "ogb_products", reduced=reduced)
    step = arch.step_fn(cfg, "ogb_products", reduced=reduced)
    mem0 = reset_peak(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        loss_ng = float(loss_fn(model, batch))
    fwd_s = time.perf_counter() - t0
    opt = init_adamw(model)
    t0 = time.perf_counter()
    _, opt, loss1 = step(model, opt, batch)
    sync(dev)
    warm_s = time.perf_counter() - t0
    loss1 = float(loss1)
    if not abs(loss1 - loss_ng) <= 1e-5 * abs(loss_ng):
        raise AssertionError(f"ogb_products step-1 loss {loss1} vs no-grad "
                             f"forward {loss_ng}")
    opt, ms, losses, launches = counted_steps(
        dev, step, model, opt, batch, steps, "PNA ogb_products train")
    if not losses[-1] < loss1:
        raise AssertionError(f"ogb_products loss did not fall: {loss1}, "
                             f"{losses}")
    rec = dict(n_nodes=spec["n_nodes"], n_edges=spec["n_edges"],
               d_feat=spec["d_feat"], layers=cfg.n_layers,
               d_hidden=cfg.d_hidden, steps=steps,
               data_host_s=round(host_s, 3), data_move_s=round(move_s, 3),
               nograd_forward_s=round(fwd_s, 3), warmup_step_s=round(warm_s, 3),
               loss_nograd=loss_ng, loss_step1=loss1,
               step1_vs_nograd_rel_err=abs(loss1 - loss_ng) / abs(loss_ng),
               step_p50_ms=round(float(np.percentile(ms, 50)), 3),
               step_max_ms=round(float(max(ms)), 3),
               **peak_memory(dev, mem0), losses=[round(v, 6) for v in losses],
               kernel_launches=launches)
    log("train", arch="pna", shape="ogb_products", **rec)
    return rec


def pna_sparse_phases(dev, reduced: bool = False) -> dict:
    """The ``train`` phase's ``pna_sparse`` part: ``full_graph_sm`` (Cora),
    ``minibatch_lg`` (the sampler at Reddit scale, then the cell's
    fixed-shape batch at full depth), ``ogb_products`` (the parity cut,
    then the full graph); none of the port's kernels launches."""
    import torch
    t0 = time.perf_counter()
    out = dict(full_graph_sm=sparse_cell_train(dev, "full_graph_sm",
                                               reduced),
               sampler=reddit_sampler(dev, reduced),
               minibatch_lg=minibatch_cell(dev, reduced),
               ogb_parity=ogb_parity(dev, reduced))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["ogb_products"] = ogb_train(dev, reduced)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    out["kernel_launches"] = {
        name: sum(r["kernel_launches"][name] for r in out.values()
                  if isinstance(r, dict))
        for name in out["full_graph_sm"]["kernel_launches"]}
    log("train", part="pna_sparse", seconds=f"{out['seconds']:.1f}",
        kernel_launches=out["kernel_launches"])
    return out


# ---------------------------------------------------------------------------
# recsys: DIEN, SASRec and DCN-v2, every cell at FULL width
# ---------------------------------------------------------------------------

RECSYS_SEED = 10
RECSYS_ARCHES = ("dien", "sasrec", "dcn-v2")
RECSYS_STEPS = 5            # counted train_batch steps, after one warm-up
RECSYS_SERVE_CALLS = {"serve_p99": 10, "serve_bulk": 3}   # after a warm-up
RECSYS_RETRIEVAL_CALLS = 2  # timed retrieval_cand calls, after a warm-up
RECSYS_PARITY_ROWS = 4096   # train rows held to a CPU copy
RECSYS_SERVE_PARITY = 64    # serve rows held to a CPU copy
RECSYS_CAND_PARITY = 1024   # candidate scores held to a CPU copy
RECSYS_TOL = dict(rtol=1e-5, atol=1e-6)
# a counted step's loss may exceed the one before by fp32 rounding only
LOSS_RISE_RTOL = 1e-6


def recsys_lookups(arch_id: str, cfg) -> list:
    """(table, batch field, column or None) of every table lookup of the
    arch's cells; the candidates ride along under ``cand_*`` names."""
    if arch_id == "two-tower-retrieval":
        return [("user_emb", "user_id", None), ("user_emb", "user_feats", None),
                ("item_emb", "item_id", None)]
    if arch_id == "dien":
        return ([("item_emb", f, None) for f in ("hist_items", "target_item",
                                                 "cand_items")]
                + [("cate_emb", f, None) for f in ("hist_cates",
                                                   "target_cate",
                                                   "cand_cates")])
    if arch_id == "sasrec":
        return [("item_emb", f, None)
                for f in ("seq", "pos", "neg", "target", "cand_ids")]
    return ([(f"tables.{i}", "sparse", i) for i in range(cfg.n_sparse)]
            + [("tables.0", "cand_sparse", None)])


class ZipfIds:
    """Ids of a ``ZIPF_EXPONENT`` popularity law over ``v`` ids, the ranks
    shuffled over the ids (a permutation drawn from ``rng``)."""

    def __init__(self, rng, v: int):
        p = np.arange(1, v + 1, dtype=np.float64) ** -ZIPF_EXPONENT
        self.cdf = np.cumsum(p / p.sum())
        self.cdf[-1] = 1.0
        self.of_rank = rng.permutation(v).astype(np.int32)

    def draw(self, rng, shape) -> np.ndarray:
        rank = np.searchsorted(self.cdf, rng.random(shape), side="right")
        return self.of_rank[np.minimum(rank, len(self.cdf) - 1)]


def recsys_traffic(arch_id: str, cfg, seed: int = RECSYS_SEED):
    """``draw(b, kind) -> numpy batch`` of the arch's paper traffic, all
    batches from one numpy generator seeded ``seed``: DIEN (Amazon Books)
    histories of lengths uniform in [1, S] (prefix mask, -1 beyond), items
    Zipf(1.1) over the items, categories from a fixed item -> category
    map, labels Bernoulli(0.5); SASRec sequences of lengths uniform in
    [2, S] left-padded with -1, items Zipf(1.1), ``pos`` the sequence
    shifted by one, ``N_NEG`` negatives uniform over the items; DCN-v2
    (Criteo) 13 dense features ``log1p`` of exponential draws, each sparse
    column Zipf(1.1) over its own vocabulary, labels Bernoulli(0.25).
    ``kind``: ``train``, ``serve`` or ``retrieval`` (one user, and ``n``
    candidates ``cand_*``: every item id, or every id of DCN-v2's column
    0, in a random order, repeated when ``n`` is larger).  DIEN's
    retrieval user has a full history of S steps: the AUGRU then runs
    every step of the reference's S-step loop (the port skips steps
    masked for all candidates)."""
    from repro_torch.configs.sasrec import N_NEG
    rng = np.random.default_rng(seed)
    if arch_id == "dcn-v2":
        laws = {}
        for v in sorted(set(cfg.vocab_sizes)):
            laws[v] = ZipfIds(rng, v)
    else:
        items = ZipfIds(rng, cfg.n_items)
        cate_of = (rng.integers(0, cfg.n_cates, cfg.n_items, dtype=np.int32)
                   if arch_id == "dien" else None)

    def cands(v: int, n: int) -> np.ndarray:
        return np.resize(rng.permutation(v).astype(np.int32), n)

    def draw(b: int, kind: str, n: int = 0) -> dict:
        if arch_id == "dien":
            s = cfg.seq_len
            lens = (np.full(b, s) if kind == "retrieval"
                    else rng.integers(1, s + 1, b))
            m = np.arange(s)[None] < lens[:, None]
            hist = np.where(m, items.draw(rng, (b, s)), -1).astype(np.int32)
            tgt = items.draw(rng, b)
            out = {"hist_items": hist,
                   "hist_cates": np.where(m, cate_of[np.maximum(hist, 0)],
                                          -1).astype(np.int32),
                   "mask": m.astype(np.float32),
                   "target_item": tgt, "target_cate": cate_of[tgt],
                   "label": (rng.random(b) < 0.5).astype(np.float32)}
            if kind == "retrieval":
                ids = cands(cfg.n_items, n)
                out.update(cand_items=ids, cand_cates=cate_of[ids])
        elif arch_id == "sasrec":
            # a user's L items and the next one, the last L + 1 of S + 1
            s = cfg.seq_len
            lens = rng.integers(2, s + 1, b)
            real = (np.arange(s)[None] >= (s - lens)[:, None])
            full = items.draw(rng, (b, s + 1))
            out = {"seq": np.where(real, full[:, :-1], -1).astype(np.int32)}
            if kind == "train":
                out["pos"] = np.where(real, full[:, 1:], -1).astype(np.int32)
                out["neg"] = rng.integers(0, cfg.n_items, (b, s, N_NEG),
                                          dtype=np.int32)
            elif kind == "serve":
                out["target"] = full[:, -1]
            else:
                out["cand_ids"] = cands(cfg.n_items, n)
        else:
            out = {"dense": np.log1p(rng.exponential(size=(b, cfg.n_dense))
                                     ).astype(np.float32),
                   "sparse": np.stack([laws[v].draw(rng, b)
                                       for v in cfg.vocab_sizes], axis=1),
                   "label": (rng.random(b) < 0.25).astype(np.float32)}
            if kind == "retrieval":
                out["cand_sparse"] = cands(cfg.vocab_sizes[0], n)
        if kind != "train":
            out.pop("label", None)
        return out

    return draw


def recsys_copy(arch_id: str, model, batch: dict, dtype):
    """A CPU copy of ``model`` holding only the table rows ``batch``
    touches (ids clamped to the table, unique, remapped; -1 stays -1), in
    ``dtype``: (copy, its batch on the CPU, {table: card rows}).  Valid for
    ids in [-1, V): a clip-to-0 read of a -1 meets another row 0 here,
    which the arches' paths only do under a mask."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.common import set_named_params
    params = dict(model.named_parameters())
    lookups = [(t, f, c) for t, f, c in recsys_lookups(arch_id, model.cfg)
               if f in batch]

    def ids_of(field, col):
        return batch[field] if col is None else batch[field][:, col]

    rows = {}
    for table in dict.fromkeys(t for t, _, _ in lookups):
        flat = torch.cat([ids_of(f, c).reshape(-1)
                          for t, f, c in lookups if t == table])
        rows[table] = flat[flat >= 0].clamp_max(
            params[table].shape[0] - 1).unique()
    out = {k: (t.detach().to("cpu", dtype) if t.dtype.is_floating_point
               else t.to("cpu", copy=True)) for k, t in batch.items()}
    for table, field, col in lookups:
        ids = ids_of(field, col)
        r = torch.searchsorted(rows[table], ids.clamp(
            0, params[table].shape[0] - 1))
        r = torch.where(ids >= 0, r, ids).to(torch.int32).cpu()
        if col is None:
            out[field] = r
        else:
            out[field][:, col] = r
    cfg = model.cfg
    n = {k: len(r) for k, r in rows.items()}
    if arch_id == "two-tower-retrieval":
        cfg = dataclasses.replace(cfg, n_users=n["user_emb"],
                                  n_items=n["item_emb"], dtype=dtype)
    elif arch_id == "dien":
        cfg = dataclasses.replace(cfg, n_items=n["item_emb"],
                                  n_cates=n["cate_emb"], dtype=dtype)
    elif arch_id == "sasrec":
        cfg = dataclasses.replace(cfg, n_items=n["item_emb"], dtype=dtype)
    else:
        cfg = dataclasses.replace(cfg, dtype=dtype, vocab_sizes=tuple(
            n[f"tables.{i}"] for i in range(cfg.n_sparse)))
    named = {k: (p[rows[k]] if k in rows else p).detach().to(
        "cpu", dtype, copy=True) for k, p in params.items()}
    copy = set_named_params(get_arch(arch_id).module(cfg), named)
    return copy, out, rows


def step1_parity(dev, arch_id: str, model, opt, sub: dict, what: str
                 ) -> tuple:
    """Step 1 of the arch's ``train_batch`` on the rows ``sub`` against CPU
    copies of the table rows they touch (:func:`recsys_copy`) that take the
    card's ReLU branch (:func:`relu_branch`): each unit where the card's
    branch differs from float64's has a float64 input within
    ``RELU_FLIP_TOL`` of its call's largest; the loss within rtol 1e-5 of
    the fp32 copy's; the card's path in float64 within ``RECSYS_FP64_TOL``
    of the float64 copy; the fp32 gradients by :func:`grad_parity`; no
    gradient outside the touched rows; one ``adamw_update`` of ``model`` /
    ``opt`` and of the copy from the card's gradients
    (:func:`update_parity`).  Returns (the updated ``opt``, the record)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.train import adamw_update, value_and_grad
    from repro_torch.train.optimizer import AdamWState
    arch = get_arch(arch_id)
    z_card = []
    with relu_branch(seen=z_card):
        loss_c, grads_c = value_and_grad(
            arch.loss_fn(model.cfg, "train_batch"), model, sub)
    t0 = time.perf_counter()
    runs = {}
    for dtype in (torch.float32, torch.float64):
        cpu, cpu_batch, rows = recsys_copy(arch_id, model, sub, dtype)
        z = []
        with relu_branch(card=z_card, seen=z):
            loss_h, grads_h = value_and_grad(
                arch.loss_fn(cpu.cfg, "train_batch"), cpu, cpu_batch)
        runs[dtype] = (cpu, cpu_batch, float(loss_h), grads_h, z)
    cpu_s = time.perf_counter() - t0
    cpu, _, loss_h, grads_h, _ = runs[torch.float32]
    cpu64, batch64, loss_64, grads_64, z64 = runs[torch.float64]
    flips, flip_worst = 0, 0.0
    for zc, zd in zip(z_card, z64):
        f = (zc.cpu() > 0) != (zd > 0)
        if bool(f.any()):
            flips += int(f.sum())
            flip_worst = max(flip_worst, float(zd[f].abs().max())
                             / float(zd.abs().max()))
    if not flip_worst <= RELU_FLIP_TOL:
        raise AssertionError(
            f"{what}: a ReLU unit takes another branch on the card than in "
            f"float64 at an input {flip_worst:.3g} of its call's largest "
            f"(> {RELU_FLIP_TOL})")
    if not abs(float(loss_c) - loss_h) <= 1e-5 * abs(loss_h):
        raise AssertionError(f"{what} loss card {float(loss_c)} vs CPU "
                             f"{loss_h}")
    # the card's path in float64 (the copy moved to the card, in place)
    with relu_branch(card=z_card):
        loss_c64, grads_c64 = value_and_grad(
            arch.loss_fn(cpu64.cfg, "train_batch"), cpu64.to(dev),
            {k: v.to(dev) for k, v in batch64.items()})
    fp64 = max([abs(float(loss_c64) - loss_64) / abs(loss_64)]
               + [float((g.cpu() - grads_64[k]).norm())
                  / (float(grads_64[k].norm()) or 1.0)
                  for k, g in grads_c64.items()])
    if not fp64 <= RECSYS_FP64_TOL:
        raise AssertionError(f"{what} in float64: card vs CPU {fp64:.3g} > "
                             f"{RECSYS_FP64_TOL}")
    del runs, cpu64, batch64, grads_c64, z_card, z64
    gpar = grad_parity(grads_c, grads_h, grads_64, rows, what)

    def host(t, k):             # a copy, also when dev is the CPU
        return (t[rows[k]] if k in rows else t).to("cpu", copy=True)

    cpu_opt = AdamWState(step=opt.step.to("cpu", copy=True),
                         mu={k: host(m, k) for k, m in opt.mu.items()},
                         nu={k: host(v, k) for k, v in opt.nu.items()})
    cpu_grads = {k: host(g, k) for k, g in grads_c.items()}
    _, opt = adamw_update(arch.opt, grads_c, opt, model)
    _, cpu_opt = adamw_update(arch.opt, cpu_grads, cpu_opt, cpu)
    outside = 0
    for k, r in rows.items():          # in place: the gradients are spent
        outside += int(grads_c[k].index_fill_(0, r.long(), 0.0)
                       .count_nonzero())
    if outside:
        raise AssertionError(f"{what}: {outside} gradient entries outside "
                             "the batch's table rows")
    upd_err = update_parity(model, opt, cpu, cpu_opt, rows, what)
    return opt, dict(
        touched_rows={k: len(r) for k, r in rows.items()},
        loss_card=float(loss_c), loss_cpu=loss_h, loss_fp64=loss_64,
        relu_flips=flips, relu_flip_worst=flip_worst, gradients=gpar,
        card_fp64_vs_cpu_fp64=fp64, gradient_outside_rows=outside,
        adamw_update_max_abs_err=upd_err, cpu_s=round(cpu_s, 3))


def recsys_train(dev, arch_id: str, model, draw, b: int,
                 steps: int = RECSYS_STEPS,
                 parity_rows: int = RECSYS_PARITY_ROWS) -> dict:
    """``train_batch``: step 1 on the batch's first ``parity_rows`` rows
    against CPU copies of the rows they touch (:func:`step1_parity`;
    ``model`` takes that step), the blocked loss (DIEN's ``GRUScan``,
    SASRec's ``SampledLogits``) against its plain version on the card, then
    one
    warm-up and ``steps`` counted steps on the whole batch (step ms,
    examples/s, peak memory, losses finite and not rising)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import recsys
    from repro_torch.train import init_adamw, value_and_grad
    arch = get_arch(arch_id)
    cfg = model.cfg
    loss_fn = arch.loss_fn(cfg, "train_batch")
    t0 = time.perf_counter()
    host = draw(b, "train")
    t1 = time.perf_counter()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    sync(dev)
    data = dict(data_host_s=round(t1 - t0, 3),
                data_move_s=round(time.perf_counter() - t1, 3))
    del host
    mem0 = reset_peak(dev)

    # step 1 on the first rows against CPU copies
    sub = {k: v[:parity_rows] for k, v in batch.items()}
    opt, par = step1_parity(dev, arch_id, model, init_adamw(model), sub,
                            arch_id)

    # the blocked loss against the plain one, on the card
    plain = {"dien": lambda m, bt: recsys.dien_loss(cfg, m, bt, plain=True),
             "sasrec": lambda m, bt: recsys.sasrec_loss(cfg, m, bt,
                                                        plain=True)}
    blk = {}
    if arch_id in plain:
        lb, gb = value_and_grad(loss_fn, model, sub)
        lp, gp = value_and_grad(plain[arch_id], model, sub)
        if not abs(float(lb) - float(lp)) <= 1e-6 * abs(float(lp)):
            raise AssertionError(f"{arch_id} blocked loss {float(lb)} vs "
                                 f"plain {float(lp)}")
        g_err = 0.0
        for k, w in gp.items():
            scale = max(1.0, float(w.abs().max()))
            if not torch.allclose(gb[k], w, rtol=1e-5, atol=1e-6 * scale):
                raise AssertionError(f"{arch_id} blocked gradient {k} vs "
                                     "plain")
            g_err = max(g_err, float((gb[k] - w).abs().max()))
        blk = dict(blocked_vs_plain_loss_err=abs(float(lb) - float(lp)),
                   blocked_vs_plain_grad_err=g_err)
        del gb, gp
    log("parity", path=f"{arch_id} train_batch step 1",
        rows=min(parity_rows, b), **par, **blk)
    del sub

    step = arch.step_fn(cfg, "train_batch")
    t0 = time.perf_counter()
    _, opt, loss0 = step(model, opt, batch)              # warm-up
    sync(dev)
    warm_s = time.perf_counter() - t0
    opt, ms, losses, launches = counted_steps(dev, step, model, opt, batch,
                                              steps, f"{arch_id} train")
    seq = [float(loss0)] + losses
    if not np.isfinite(seq).all() or any(
            b2 > a2 + LOSS_RISE_RTOL * abs(a2) for a2, b2 in zip(seq,
                                                                 seq[1:])):
        raise AssertionError(f"{arch_id} train losses rose: {seq}")
    ms_a = np.array(ms)
    rec = dict(batch=b, steps=steps, **data, warmup_step_s=round(warm_s, 3),
               step_p50_ms=round(float(np.percentile(ms_a, 50)), 3),
               step_max_ms=round(float(ms_a.max()), 3),
               examples_per_s=round(b / np.percentile(ms_a, 50) * 1e3, 1),
               **peak_memory(dev, mem0), loss_warmup=float(loss0),
               losses=[round(v, 6) for v in losses],
               parity_loss_card=par["loss_card"],
               parity_loss_cpu=par["loss_cpu"], kernel_launches=launches)
    log("train", arch=arch_id, shape="train_batch", **rec)
    del opt
    return rec


def assert_scores_close(got, want, what: str) -> float:
    import torch
    got = got.detach().cpu().to(want.dtype)
    if not torch.allclose(got, want, **RECSYS_TOL):
        bad = (got - want).abs() - RECSYS_TOL["rtol"] * want.abs()
        i = int(bad.argmax())
        raise AssertionError(f"{what}: card {float(got[i])} vs CPU "
                             f"{float(want[i])} at {i}")
    return float((got - want).abs().max())


def recsys_serve(dev, arch_id: str, model, draw, shape: str, b: int,
                 calls: int) -> dict:
    """A serve cell: one warm-up and ``calls`` timed calls of the arch's
    serve step on a batch of ``b`` (p50 ms, peak memory), the first
    ``RECSYS_SERVE_PARITY`` rows against a CPU copy; no kernel launches."""
    import torch
    from repro_torch.configs import get_arch
    arch = get_arch(arch_id)
    fn = arch.step_fn(model.cfg, shape)
    t0 = time.perf_counter()
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in draw(b, "serve").items()}
    sync(dev)
    data_s = time.perf_counter() - t0
    mem0 = reset_peak(dev)
    with torch.no_grad():
        out = fn(model, batch)
        sync(dev)
        counters = zero_launches()
        ms = []
        for _ in range(calls):
            del out
            t0 = time.perf_counter()
            out = fn(model, batch)
            sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = check_no_launches(counters, f"{arch_id} {shape}")
    peak = peak_memory(dev, mem0)
    if tuple(out.shape) != (b,) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{arch_id} {shape}: output {tuple(out.shape)}"
                             " not (b,) finite")
    sub = {k: v[:RECSYS_SERVE_PARITY] for k, v in batch.items()}
    cpu, cpu_batch, _ = recsys_copy(arch_id, model, sub, torch.float32)
    with torch.no_grad():
        err = assert_scores_close(out[:RECSYS_SERVE_PARITY],
                                  arch.step_fn(cpu.cfg, shape)(cpu,
                                                               cpu_batch),
                                  f"{arch_id} {shape}")
    rec = dict(batch=b, calls=calls, data_s=round(data_s, 3),
               p50_ms=round(float(np.percentile(ms, 50)), 3),
               max_ms=round(float(max(ms)), 3),
               rows_per_s=round(b / np.percentile(ms, 50) * 1e3, 1), **peak,
               parity_rows=RECSYS_SERVE_PARITY, max_abs_err=err,
               kernel_launches=launches)
    log("serve", arch=arch_id, shape=shape, **rec)
    return rec


def dien_retrieval_bound(cfg, n: int, steps: int) -> dict:
    """The fp32 operations of DIEN's ``retrieval_cand`` for one user (the
    AUGRU's hidden-side GEMM and gates over ``steps`` valid steps, the
    attention logits, the head) over the card's fp32 peak."""
    g, e2 = cfg.gru_dim, 2 * cfg.embed_dim
    dims = (g + 3 * e2,) + tuple(cfg.mlp_dims) + (1,)
    flops = n * (steps * (2 * g * 3 * g + 12 * g) + cfg.seq_len * 2 * e2
                 + sum(2 * a * b for a, b in zip(dims, dims[1:])))
    return dict(gemm_bound_ms=flops / PEAK_FP32_PER_S * 1e3,
                flops=flops)


def recsys_retrieval(dev, arch_id: str, model, draw, n: int, chunk_note: str,
                     reduced: bool = False,
                     calls: int = RECSYS_RETRIEVAL_CALLS) -> dict:
    """``retrieval_cand``: one user against ``n`` candidates (every id, in
    a random order), one warm-up and ``calls`` timed calls (p50 ms, peak
    memory), the first ``RECSYS_CAND_PARITY`` scores against a CPU copy.
    DCN-v2 runs both ``retrieve`` and ``retrieve_opt`` and their scores
    must agree."""
    import torch
    from repro_torch.configs import get_arch
    arch = get_arch(arch_id)
    cfg = model.cfg
    host = draw(1, "retrieval", n)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    names = {"dien": ["cand_items", "cand_cates"], "sasrec": ["cand_ids"],
             "dcn-v2": ["cand_sparse"]}[arch_id]
    cands = [batch[nm] for nm in names]
    user = {k: v for k, v in batch.items() if not k.startswith("cand_")}
    opts = {"retrieve": {}}
    if arch_id == "dcn-v2":
        opts["retrieve_opt"] = {"optimized": True}
    variants = {name: arch.step_fn(cfg, "retrieval_cand", reduced=reduced,
                                   **o) for name, o in opts.items()}
    rec = dict(n_candidates=n, calls=calls, chunk=chunk_note)
    scores = {}
    counters = None
    with torch.no_grad():
        for name, fn in variants.items():
            mem0 = reset_peak(dev)
            out = fn(model, user, *cands)
            sync(dev)
            if counters is None:
                counters = zero_launches()
            ms = []
            for _ in range(calls):
                del out
                t0 = time.perf_counter()
                out = fn(model, user, *cands)
                sync(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
            if tuple(out.shape) != (n,) or not bool(
                    torch.isfinite(out).all()):
                raise AssertionError(f"{arch_id} retrieval_cand {name}: "
                                     "output not (n,) finite")
            scores[name] = out
            rec[name] = dict(p50_ms=round(float(np.percentile(ms, 50)), 3),
                             max_ms=round(float(max(ms)), 3),
                             **peak_memory(dev, mem0))
        launches = check_no_launches(counters, f"{arch_id} retrieval_cand")
    if "retrieve_opt" in scores:
        rec["retrieve_vs_opt_max_abs_err"] = assert_scores_close(
            scores["retrieve_opt"], scores["retrieve"].cpu(),
            "dcn-v2 retrieve_opt vs retrieve")
    k = min(RECSYS_CAND_PARITY, n)
    sub = dict(user, **{nm: c[:k] for nm, c in zip(names, cands)})
    cpu, cpu_batch, _ = recsys_copy(arch_id, model, sub, torch.float32)
    cpu_user = {kk: v for kk, v in cpu_batch.items()
                if not kk.startswith("cand_")}
    cpu_cands = [cpu_batch[nm] for nm in names]
    with torch.no_grad():
        for name, o in opts.items():
            fn = arch.step_fn(cpu.cfg, "retrieval_cand", reduced=reduced,
                              **o)
            rec[name]["max_abs_err"] = assert_scores_close(
                scores[name][:k], fn(cpu, cpu_user, *cpu_cands),
                f"{arch_id} retrieval_cand {name}")
    if arch_id == "dien":
        steps = int((user["mask"][0] > 0).sum())
        rec.update(valid_steps=steps,
                   ms_per_step=round(rec["retrieve"]["p50_ms"] / steps, 3),
                   **dien_retrieval_bound(cfg, n, steps))
    rec.update(parity_candidates=k, kernel_launches=launches)
    log("retrieval", arch=arch_id, shape="retrieval_cand", **rec)
    return rec


def recsys_arch(dev, arch_id: str, reduced: bool = False) -> dict:
    """Every cell of one arch on a model drawn from a seeded generator on
    ``dev``: ``train_batch``, ``serve_p99``, ``serve_bulk`` and
    ``retrieval_cand`` at the arch's FULL config (REDUCED with
    ``reduced``)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.recsys_common import (RECSYS_SHAPES,
                                                   REDUCED_RECSYS_SHAPES)
    shapes = REDUCED_RECSYS_SHAPES if reduced else RECSYS_SHAPES
    arch = get_arch(arch_id)
    cfg = arch.config(reduced=reduced)
    t0 = time.perf_counter()
    model = arch.init(cfg, torch.Generator(device=dev).manual_seed(
        RECSYS_SEED), device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    nparams = sum(p.numel() for p in model.parameters())
    t0 = time.perf_counter()
    draw = recsys_traffic(arch_id, cfg)
    log("recsys", arch=arch_id, params=nparams, init_s=round(init_s, 3),
        traffic_setup_s=round(time.perf_counter() - t0, 3),
        reduced=reduced, tf32=bool(torch.backends.cuda.matmul.allow_tf32))
    out = dict(params=nparams)
    out["train_batch"] = recsys_train(dev, arch_id, model, draw,
                                      shapes["train_batch"]["batch"])
    for shape in ("serve_p99", "serve_bulk"):
        out[shape] = recsys_serve(dev, arch_id, model, draw, shape,
                                  shapes[shape]["batch"],
                                  RECSYS_SERVE_CALLS[shape])
    note = {"dien": f"{'64' if reduced else '4096'} candidates a chunk",
            "sasrec": "one GEMM", "dcn-v2": "one batch"}[arch_id]
    out["retrieval_cand"] = recsys_retrieval(
        dev, arch_id, model, draw, shapes["retrieval_cand"]["n_candidates"],
        note, reduced)
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def recsys_phases(dev, reduced: bool = False) -> dict:
    """The ``train`` phase's ``recsys`` part: DIEN, SASRec and DCN-v2, each
    cell at FULL width (fp32 products: TF32 stays off); none of the port's
    kernels launches (their lookups are plain gathers, as the reference's
    ``jnp.take``)."""
    t0 = time.perf_counter()
    out = {}
    for arch_id in RECSYS_ARCHES:
        t1 = time.perf_counter()
        out[arch_id] = recsys_arch(dev, arch_id, reduced)
        out[arch_id]["seconds"] = round(time.perf_counter() - t1, 1)
        log("recsys", arch=arch_id, seconds=out[arch_id]["seconds"])
    out["seconds"] = time.perf_counter() - t0
    names = [fn.__name__ for fn in all_launchers()]
    out["kernel_launches"] = {
        name: sum(out[a][cell]["kernel_launches"][name]
                  for a in RECSYS_ARCHES
                  for cell in ("train_batch", "serve_p99", "serve_bulk",
                               "retrieval_cand"))
        for name in names}
    log("train", part="recsys", seconds=f"{out['seconds']:.1f}",
        kernel_launches=out["kernel_launches"])
    return out


# ---------------------------------------------------------------------------
# lm: the five LM arches, every cell at FULL width
# ---------------------------------------------------------------------------

LM_SEED = 11
LM_ARCHES = ("smollm-360m", "qwen3-8b", "gemma3-27b", "deepseek-v2-lite-16b",
             "moonshot-v1-16b-a3b")
LM_TRAIN_STEPS = 3          # counted train_4k steps, after one warm-up
LM_DECODE_STEPS = 5         # counted decode steps at the cache's end (was 10)
LM_PARITY_TOKENS = 64       # step 1 of a one-period copy on 1 x 64 tokens
#                             (cut from 256 for the run's time: gemma3's
#                             copy took 77 s at 256 on an H100 machine, 36 s
#                             of it on its 8-core host)
LM_PARITY_DECODES = 3       # of them, the last 3 decoded after a prefill
LM_WARMUP_PROMPT = 1024     # the prefill warm-up's prompt length
LM_TOL = 1e-5               # rtol, and atol x the largest |value|
# the bf16 train step may differ from the fp32 one rounded to bf16 on this
# share of the entries the latter moves (its first update's signs; on an
# NVIDIA H100 80GB HBM3: 0.67-1.83 % in lm_parity's 64 tokens, 1.04 % and
# 1.14 % for qwen3 and gemma3 at the train cells' cut, tests/lm_probe.py;
# an update gone wrong differs on about all of them)
LM_BF16_STEP_TOL = 0.1
# FULL width: every width, head count, expert count, top-k, window and
# vocabulary as published; (layers, batch) of each cell, the layers in
# whole periods of the layer pattern (gemma3's is 6: five local, one
# global), cut so that the cell fits one 80 GB card; the prefills of
# gemma3 and moonshot are cut further for the run's time (on an NVIDIA
# H100 80GB HBM3 a 32,768-token prefill takes 0.25 s a layer at 15 heads,
# 0.36-0.40 s at 16 and 0.69-0.72 s at 32, most of it the fp32 scores'
# GEMMs and passes over them, the same in every layer)
LM_CUTS = {
    "smollm-360m": {"train_4k": (32, 8), "prefill_32k": (32, 1),
                    "decode_32k": (32, 32)},
    "qwen3-8b": {"train_4k": (8, 2), "prefill_32k": (36, 1),
                 "decode_32k": (36, 8)},
    "gemma3-27b": {"train_4k": (6, 1), "prefill_32k": (6, 1),
                   "decode_32k": (62, 1), "long_500k": (12, 1)},
    "deepseek-v2-lite-16b": {"train_4k": (4, 2), "prefill_32k": (27, 1),
                             "decode_32k": (27, 8)},
    "moonshot-v1-16b-a3b": {"train_4k": (4, 2), "prefill_32k": (8, 1),
                            "decode_32k": (48, 1)},
}


def lm_period(cfg) -> int:
    """Layers of one period of the layer pattern (6 for 5:1 local:global,
    else 1)."""
    return cfg.local_ratio + 1 if cfg.window and cfg.local_ratio else 1


def lm_plan(arch_id: str, reduced: bool) -> dict:
    """{cell: (config, batch, seq)} of the arch's cells that run: FULL
    width cut as ``LM_CUTS`` says, or the REDUCED config and shapes."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.configs.lm_common import LM_SHAPES, REDUCED_SHAPES
    arch = get_arch(arch_id)
    cfg = arch.config(reduced=reduced)
    cells = [c.shape for c in arch.cells() if c.skip is None]
    out = {}
    for shape in cells:
        if reduced:
            spec = REDUCED_SHAPES[shape]
            out[shape] = (cfg, spec["batch"], spec["seq"])
            continue
        layers, b = LM_CUTS[arch_id][shape]
        if layers != cfg.n_layers and layers % lm_period(cfg):
            raise AssertionError(f"{arch_id} {shape}: a cut to {layers} "
                                 "layers is not a whole number of periods")
        out[shape] = (dataclasses.replace(cfg, n_layers=layers), b,
                      LM_SHAPES[shape]["seq"])
    return out


def lm_tokens(rng, zipf, shape) -> "np.ndarray":
    """Token ids of a Zipf(``ZIPF_EXPONENT``) law over the vocabulary (real
    text repeats its common tokens, and the embedding's backward feels
    those repeats), int32."""
    return zipf.draw(rng, shape).astype(np.int32)


def recorded_routes(into: list):
    """A context in which every ``moe_route`` call appends its (T, k)
    expert ids, on the CPU, to ``into``."""
    import contextlib
    from repro_torch.models import transformer as tt

    @contextlib.contextmanager
    def ctx():
        real = tt.moe_route

        def rec(cfg, lp, xf):
            w, i = real(cfg, lp, xf)
            into.append(i.cpu())
            return w, i
        tt.moe_route = rec
        try:
            yield
        finally:
            tt.moe_route = real
    return ctx()


def routing_flips(a: list, b: list) -> int:
    """(token, layer) pairs whose set of top-k experts differs."""
    return sum(int((x.sort(dim=-1).values != y.sort(dim=-1).values)
                   .any(dim=-1).sum()) for x, y in zip(a, b))


def assert_lm_close(got, want, what: str) -> float:
    """``got`` (any device) within rtol ``LM_TOL`` and an atol of
    ``LM_TOL`` times the largest |want| of ``want`` (CPU); returns the
    largest |err|."""
    import torch
    got = got.detach().cpu().to(want.dtype)
    atol = LM_TOL * float(want.abs().max())
    if not torch.allclose(got, want, rtol=LM_TOL, atol=atol):
        bad = (got - want).abs() - LM_TOL * want.abs()
        i = int(bad.argmax())
        raise AssertionError(f"{what}: card {float(got.flatten()[i])} vs CPU "
                             f"{float(want.flatten()[i])} (atol {atol:.3g})")
    return float((got - want).abs().max())


def lm_parity(dev, arch_id: str, cfg, n_tokens: int = LM_PARITY_TOKENS
              ) -> dict:
    """Step 1 of a model cut to one period of ``cfg`` (the embedding
    whole), drawn in bf16 on ``dev`` and cast to fp32 there, against an
    fp32 CPU copy, on 1 x ``n_tokens`` Zipf tokens: the logits and the
    loss within rtol ``LM_TOL``; every gradient by the noise rule
    (:func:`grad_parity`; float64 on ``dev`` when a gradient stands more
    than ``GRAD_REL_FLOOR`` from the CPU's); a prefill of all but the last
    ``LM_PARITY_DECODES`` tokens, which are then decoded (logits and
    caches); one ``adamw_update`` of every parameter from the card's
    gradients, the CPU copy updating the embedding's rows of the tokens
    and one row they do not touch, its last layer's attention, norms and
    router and its final norm from those gradients (the clip scale's norm
    over every gradient, the others the CPU's own) to be held to the
    card's.  Recorded, not gated: the bf16 model's relative L2 to the
    fp32 one and its MoE routing flips.  Runs without ``remat`` (the same
    arithmetic)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tt
    from repro_torch.models.common import cross_entropy, set_named_params
    from repro_torch.train import adamw_update, init_adamw, value_and_grad
    arch = get_arch(arch_id)
    c16 = dataclasses.replace(cfg, n_layers=lm_period(cfg), remat=False,
                              dtype=torch.bfloat16)
    c32 = dataclasses.replace(c16, dtype=torch.float32)
    rng = np.random.default_rng(LM_SEED + 1)
    ids = torch.from_numpy(lm_tokens(rng, ZipfIds(rng, cfg.vocab),
                                     (1, n_tokens + 1)))
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    card_batch = {k: v.to(dev) for k, v in batch.items()}
    logits = {}

    def loss_fn(name):
        def loss(model, b):
            out = tt.forward(c32, model, b["tokens"])
            logits[name] = out.detach()
            return cross_entropy(out, b["labels"])
        return loss

    laps, clock = {}, [time.perf_counter()]

    def lap(stage):
        now = time.perf_counter()
        laps[stage] = round(now - clock[0], 3)
        clock[0] = now

    m16 = arch.init(c16, torch.Generator(device=dev).manual_seed(LM_SEED),
                    device=dev)
    r16, r32 = [], []
    with torch.no_grad(), recorded_routes(r16):
        logits16 = tt.forward(c16, m16, card_batch["tokens"])
    m32 = set_named_params(arch.module(c32), {
        k: p.float() for k, p in m16.named_parameters()})
    del m16
    with recorded_routes(r32):
        loss_c, grads_c = value_and_grad(loss_fn("card"), m32, card_batch)
    bf16_rel_l2 = float((logits16 - logits["card"]).norm()
                        / logits["card"].norm())
    del logits16
    lap("card")
    cpu = set_named_params(arch.module(c32), {
        k: p.detach().to("cpu", copy=True)
        for k, p in m32.named_parameters()})
    lap("copy")
    loss_h, grads_h = value_and_grad(loss_fn("cpu"), cpu, batch)
    lap("cpu")
    if not abs(float(loss_c) - float(loss_h)) <= LM_TOL * abs(float(loss_h)):
        raise AssertionError(f"{arch_id} loss card {float(loss_c)} vs CPU "
                             f"{float(loss_h)}")
    rec = dict(layers=c32.n_layers, tokens=n_tokens,
               loss_card=float(loss_c), loss_cpu=float(loss_h),
               logits_max_abs_err=assert_lm_close(
                   logits.pop("card"), logits.pop("cpu"),
                   f"{arch_id} logits"),
               bf16_vs_fp32_rel_l2=bf16_rel_l2,
               bf16_routing_flips=routing_flips(r16, r32))

    # serving: a prefill of the first tokens, then the last ones decoded
    p = n_tokens - LM_PARITY_DECODES
    serve = {}
    with torch.no_grad():
        for name, model, dv in (("card", m32, dev),
                                ("cpu", cpu, torch.device("cpu"))):
            tok = batch["tokens"].to(dv)
            out, cache = tt.prefill(c32, model, tok[:, :p], n_tokens)
            outs = [out]
            for i in range(p, n_tokens):
                out, cache = tt.decode_step(c32, model, cache,
                                            tok[:, i:i + 1],
                                            torch.tensor(i, device=dv))
                outs.append(out)
            serve[name] = (outs, cache)
    serve_err = max(
        [assert_lm_close(a, b, f"{arch_id} prefill/decode logits {i}")
         for i, (a, b) in enumerate(zip(serve["card"][0], serve["cpu"][0]))]
        + [assert_lm_close(a, b, f"{arch_id} cache")
           for a, b in zip(serve["card"][1], serve["cpu"][1])])
    del serve
    lap("serve")

    # gradients; their float64 run (on dev, the fp32 model set aside) only
    # when a gradient stands beyond the floor
    try:
        gpar = grad_parity(grads_c, grads_h, None, {}, arch_id)
    except AssertionError:
        grads_c = {k: g.cpu() for k, g in grads_c.items()}
        del m32
        free(dev)
        c64 = dataclasses.replace(c32, dtype=torch.float64)
        copy64 = set_named_params(arch.module(c64), {
            k: p.to(dev, torch.float64) for k, p in cpu.named_parameters()})
        _, g64 = value_and_grad(arch.loss_fn(c64, "train_4k"), copy64,
                                card_batch)
        del copy64
        grads_c = {k: g.to(dev) for k, g in grads_c.items()}
        gpar = grad_parity(grads_c, grads_h, g64, {}, arch_id)
        del g64
        free(dev)
        m32 = set_named_params(arch.module(c32), {
            k: p.to(dev, copy=True) for k, p in cpu.named_parameters()})
    lap("gradients")

    # one adamw_update from the card's gradients
    opt = init_adamw(m32)
    _, opt = adamw_update(arch.opt, grads_c, opt, m32)
    # the CPU updates the embedding's rows of the tokens and one row they
    # do not touch (the card walks that table NORM_CHUNK elements at a
    # time), the last layer's attention, norms and router, and the final
    # norm (its FFN or experts would cost seconds of host time for the
    # same elementwise arithmetic) from the card's gradients; its clip
    # scale's norm takes the others from its own gradients, which the rule
    # above held within 1e-5 of the card's (no 15.6 GB copy of gemma3's)
    touched = ids.unique().long()
    spare = np.setdiff1d(np.arange(len(touched) + 1), touched.numpy())[0]
    rows = {"embed": torch.cat([touched, torch.tensor([int(spare)])])
            .sort().values}
    ffn = ("w_gate", "w_up", "w_down", "ws_gate", "ws_up", "ws_down")
    keys = ["embed", "final_norm"] + [
        f"layers.{c32.n_layers - 1}.{k}"
        for k, _ in m32.layers[-1].named_parameters() if k not in ffn]
    named = dict(cpu.named_parameters())
    cpu_params = {k: named[k][rows[k]] if k in rows else named[k]
                  for k in keys}
    # the CPU's own embedding gradient, its updated rows zeroed, stands in
    # the norm for the rows the copy does not hold
    grads_h["embed (other rows)"] = grads_h.pop("embed").index_fill_(
        0, rows["embed"], 0.0)
    grads_h.update({k: (grads_c[k][rows[k]] if k in rows else grads_c[k])
                    .cpu() for k in keys})
    cpu_opt = init_adamw(cpu_params)
    _, cpu_opt = adamw_update(arch.opt, grads_h, cpu_opt, cpu_params)
    del grads_h
    upd_err = update_parity(m32, opt, cpu_params, cpu_opt, rows, arch_id,
                            keys=keys)
    rec.update(adamw_update_params=len(cpu_params),
               adamw_update_embed_rows=len(rows["embed"]))
    del cpu, cpu_opt, cpu_params, grads_c, named
    # the bf16 train step from the same weights (drawn again) against this
    # fp32 step rounded to bf16: Adam's first update is about the sign of
    # each gradient, so the two differ only where bf16 rounding turned a
    # gradient's sign or routed a token elsewhere
    ref = {k: p.detach().to(torch.bfloat16) for k, p in m32.named_parameters()}
    del m32, opt
    free(dev)
    m16 = arch.init(c16, torch.Generator(device=dev).manual_seed(LM_SEED),
                    device=dev)
    moved = sum(int((ref[k] != p).sum()) for k, p in m16.named_parameters())
    arch.step_fn(c16, "train_4k")(m16, init_adamw(m16), card_batch)
    differ = sum(int((ref[k] != p).sum()) for k, p in m16.named_parameters())
    rec["bf16_step"] = dict(
        entries=sum(p.numel() for p in ref.values()), moved_by_fp32=moved,
        differ=differ, differ_share_of_moved=differ / max(moved, 1))
    if not (moved and differ <= LM_BF16_STEP_TOL * moved):
        raise AssertionError(f"{arch_id}: the bf16 train step differs from "
                             f"the fp32 one rounded on {differ} entries of "
                             f"the {moved} it moves")
    del m16, ref
    free(dev)
    lap("adamw")
    rec["sharded"] = lm_sharded(dev, arch_id, c16, c32, card_batch)
    lap("sharded")
    rec.update(prefill_decode_max_abs_err=serve_err, gradients=gpar,
               adamw_update_max_abs_err=upd_err, stage_s=laps,
               seconds=round(sum(laps.values()), 3))
    log("parity", path=f"{arch_id} step 1 (one period, fp32)",
        **{k: v for k, v in rec.items() if k != "sharded"})
    return rec


def lm_sharded(dev, arch_id: str, c16, c32, batch: dict) -> dict:
    """The arch's steps through ``sharded_step`` with ``in_shardings(cfg,
    cell, mesh)`` on ``make_host_mesh()``, each against the plain call on
    the same inputs, bit for bit: the ``train_4k`` step in both layouts
    (``baseline`` and ``pure_dp``) from the one-period fp32 model as
    ``lm_parity`` draws it (parameters, both moments, the step count and
    the loss compared through ``bits_digest``: two copies of gemma3's
    47 GB state would not fit the card), then, from the updated model, a
    ``prefill_32k`` call on the tokens (logits and cache) and one
    ``decode_32k`` step at the last position on a copy of that cache
    (logits and cache).  Logged on an ``[lm]`` line."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import set_named_params
    from repro_torch.train import init_adamw
    arch = get_arch(arch_id)
    mesh = make_host_mesh()
    t_all = time.perf_counter()

    def fresh():
        m16 = arch.init(c16, torch.Generator(device=dev).manual_seed(
            LM_SEED), device=dev)
        model = set_named_params(arch.module(c32), {
            k: p.float() for k, p in m16.named_parameters()})
        return model, init_adamw(model)

    def digests(outs) -> dict:
        return {k: bits_digest(t) for k, t in flat_outputs(outs).items()}

    step = arch.step_fn(c32, "train_4k")
    model, opt = fresh()
    want = digests(step(model, opt, batch))
    del model, opt
    free(dev)
    rec = dict(check=ONE_RANK_STEP,
               mesh=dict(zip(mesh.axis_names, mesh.shape)))
    for layout in ("baseline", "pure_dp"):
        model, opt = fresh()
        what = f"{arch_id} train_4k {layout}"
        outs, launches, sec = sharded_run(
            step, mesh, arch.in_shardings(c32, "train_4k", mesh, layout),
            (model, opt, batch), what)
        rec[f"train_{layout}"] = dict(
            bit_identical_tensors=assert_bits_equal(digests(outs), want,
                                                    what),
            seconds=round(sec, 4), launches=launches)
        del opt, outs
        if layout != "pure_dp":
            del model
            free(dev)
    tokens = batch["tokens"]
    for shape in ("prefill_32k", "decode_32k"):
        fn = arch.step_fn(c32, shape)
        if shape == "prefill_32k":
            args = (model, {"tokens": tokens})
            plain = fn(*args)
            cache = plain[1]
        else:
            dbatch = {"tokens": tokens[:, -1:],
                      "pos": torch.tensor(tokens.shape[1] - 1,
                                          dtype=torch.int32, device=dev)}
            args = (model, tuple(c.clone() for c in cache), dbatch)
            plain = fn(model, cache, dbatch)
        what = f"{arch_id} {shape}"
        outs, launches, sec = sharded_run(
            fn, mesh, arch.in_shardings(c32, shape, mesh), args, what)
        rec[shape] = dict(
            bit_identical_tensors=assert_bits_equal(
                flat_outputs(outs), flat_outputs(plain), what),
            seconds=round(sec, 4), launches=launches)
        del outs, plain, args
    del model, cache
    free(dev)
    rec["seconds"] = round(time.perf_counter() - t_all, 3)
    log("lm", arch=arch_id, path="sharded_step (one period, fp32)", **rec)
    return rec


def lm_init(dev, arch_id: str, cfg, seed: int):
    """The arch's model for ``cfg`` on ``dev``, drawn from a seeded
    generator there; (model, seconds)."""
    import torch
    from repro_torch.configs import get_arch
    t0 = time.perf_counter()
    model = get_arch(arch_id).init(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    sync(dev)
    return model, time.perf_counter() - t0


def free(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def lm_train(dev, arch_id: str, cfg, b: int, s: int, rng, zipf) -> dict:
    """``train_4k``: one warm-up and ``LM_TRAIN_STEPS`` counted steps of the
    arch's step (AdamW's defaults, as the reference's) on one (b, s) batch
    of next-token pairs: step ms, tokens/s, peak memory, 6·N·D beside the
    step time, and every loss: finite, the first update (the smallest
    learning rate of the warm-up) lowering it.  Later steps may raise it
    and are counted (``loss_rises``, beyond ``LOSS_RISE_RTOL``): Adam's
    first updates move each weight by about the learning rate, and on one
    batch at full width they overshoot.  ``tests/lm_probe.py`` ran this
    cell's steps from the same weights and batch on an NVIDIA H100 80GB
    HBM3: qwen3 and gemma3 rise on the third update in bf16 and already on
    the second in fp32, where every entry moves (bf16 rounding keeps ~95 %
    of them still); the bf16 step's check is ``lm_parity``'s."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.lm_common import model_flops
    from repro_torch.train import init_adamw
    arch = get_arch(arch_id)
    mem0 = reset_peak(dev)
    model, init_s = lm_init(dev, arch_id, cfg, LM_SEED + 3)
    ids = torch.from_numpy(lm_tokens(rng, zipf, (b, s + 1))).to(dev)
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    step = arch.step_fn(cfg, "train_4k")
    opt = init_adamw(model)
    t0 = time.perf_counter()
    _, opt, loss0 = step(model, opt, batch)
    sync(dev)
    warm_s = time.perf_counter() - t0
    opt, ms, losses, launches = counted_steps(
        dev, step, model, opt, batch, LM_TRAIN_STEPS, f"{arch_id} train_4k")
    seq = [float(loss0)] + losses
    if not seq[1] < seq[0]:
        raise AssertionError(f"{arch_id} train_4k: the first step did not "
                             f"lower the loss: {seq}")
    rises = sum(b2 > a2 + LOSS_RISE_RTOL * abs(a2)
                for a2, b2 in zip(seq, seq[1:]))
    p50 = float(np.percentile(ms, 50))
    flops = model_flops(cfg, b * s, train=True)
    rec = dict(layers=cfg.n_layers, batch=b, seq=s, steps=LM_TRAIN_STEPS,
               init_s=round(init_s, 3), warmup_step_s=round(warm_s, 3),
               step_p50_ms=round(p50, 3), step_max_ms=round(max(ms), 3),
               tokens_per_s=round(b * s / p50 * 1e3, 1),
               **peak_memory(dev, mem0), loss_warmup=float(loss0),
               losses=[round(v, 6) for v in losses], loss_rises=rises,
               model_flops=flops,
               bf16_bound_ms=round(flops / PEAK_BF16_PER_S * 1e3, 3),
               kernel_launches=launches)
    del model, opt, batch, ids
    free(dev)
    log("lm", arch=arch_id, shape="train_4k", **rec)
    return rec


def attention_flops(cfg, b: int, sq: int, sk: int) -> float:
    """The fp32 operations of the reference's attention over ``cfg``'s
    layers: q.k and p.v over every (query, key) pair, masked or not."""
    hdk = cfg.head_dim + (cfg.rope_head_dim if cfg.is_mla else 0)
    return 2.0 * b * sq * sk * cfg.n_heads * (hdk + cfg.vdim()) * cfg.n_layers


def lm_prefill(dev, arch_id: str, cfg, b: int, s: int, rng, zipf) -> dict:
    """``prefill_32k``: a warm-up of ``LM_WARMUP_PROMPT`` tokens, then one
    counted call on a (b, s) prompt: ms, tokens/s, peak memory, the fp32
    attention's and the bf16 GEMMs' FLOP counts beside it; logits finite,
    the cache as long as the prompt.  MoE arches: two forwards of the
    warm-up prompt give the same bits."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.lm_common import model_flops
    from repro_torch.models import transformer as tt
    arch = get_arch(arch_id)
    mem0 = reset_peak(dev)
    model, init_s = lm_init(dev, arch_id, cfg, LM_SEED + 4)
    step = arch.step_fn(cfg, "prefill_32k")
    warm = torch.from_numpy(lm_tokens(rng, zipf, (b, min(LM_WARMUP_PROMPT,
                                                         s)))).to(dev)
    step(model, {"tokens": warm})
    rec = dict(layers=cfg.n_layers, batch=b, seq=s, init_s=round(init_s, 3))
    if cfg.is_moe:
        with torch.no_grad():
            a = tt.forward(cfg, model, warm)
            same = torch.equal(a, tt.forward(cfg, model, warm))
        if not same:
            raise AssertionError(f"{arch_id}: two MoE forwards differ")
        rec["moe_forward_bit_identical"] = same
        del a
    tok = torch.from_numpy(lm_tokens(rng, zipf, (b, s))).to(dev)
    sync(dev)
    counters = zero_launches()
    t0 = time.perf_counter()
    logits, cache = step(model, {"tokens": tok})
    sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    launches = check_no_launches(counters, f"{arch_id} prefill_32k")
    if tuple(logits.shape) != (b, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{arch_id} prefill: logits not (b, V) finite")
    if cache[0].shape[:3] != (cfg.n_layers, b, s):
        raise AssertionError(f"{arch_id} prefill: cache {cache[0].shape}")
    attn = attention_flops(cfg, b, s, s)
    gemm = model_flops(cfg, b * s)
    rec.update(ms=round(ms, 3), tokens_per_s=round(b * s / ms * 1e3, 1),
               **peak_memory(dev, mem0), attention_fp32_flops=attn,
               attention_fp32_bound_ms=round(attn / PEAK_FP32_PER_S * 1e3, 3),
               model_flops=gemm,
               gemm_bf16_bound_ms=round(gemm / PEAK_BF16_PER_S * 1e3, 3),
               kernel_launches=launches)
    del model, logits, cache, tok, warm
    free(dev)
    log("lm", arch=arch_id, shape="prefill_32k", **rec)
    return rec


def decode_bytes(cfg, model, cache, experts_read) -> float:
    """Bytes one decode step must read: every weight (the tied embedding
    once, as the head; of the routed experts only the ``experts_read``
    (layer, expert) pairs the step's tokens reach) and the whole cache
    (the reference attends all Smax rows under the mask)."""
    total = 0
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] in ("w_gate", "w_up", "w_down") \
                and cfg.is_moe:
            continue
        total += p.numel() * p.element_size()
    if cfg.is_moe:
        total += experts_read * 3 * cfg.d_model * cfg.d_expert * (
            model.embed.element_size())
    return float(total + sum(c.numel() * c.element_size() for c in cache))


def lm_decode(dev, arch_id: str, shape: str, cfg, b: int, smax: int, rng,
              zipf) -> dict:
    """``decode_32k`` / ``long_500k``: a (b, smax) cache filled from the
    generator, one warm-up step at row smax - ``LM_DECODE_STEPS`` - 1, then
    ``LM_DECODE_STEPS`` counted steps on the last rows: ms per step, peak
    memory, the bytes a step reads (weights and cache) beside the step
    time as its bound at 3.35 TB/s; logits finite, the cache written in
    place."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tt
    arch = get_arch(arch_id)
    mem0 = reset_peak(dev)
    model, init_s = lm_init(dev, arch_id, cfg, LM_SEED + 5)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 6)
    cache = tt.init_cache(cfg, b, smax, dev)
    for c in cache:
        c.normal_(generator=gen)
    sync(dev)
    fill_s = time.perf_counter() - t0
    step = arch.step_fn(cfg, "decode_32k")
    first = smax - LM_DECODE_STEPS - 1
    toks = torch.from_numpy(lm_tokens(rng, zipf, (LM_DECODE_STEPS + 1, b,
                                                  1))).to(dev)
    pos = torch.arange(first, smax, device=dev, dtype=torch.int32)
    routes = []
    with recorded_routes(routes):
        step(model, cache, {"tokens": toks[0], "pos": pos[0]})
    experts = sum(int(r.unique().numel()) for r in routes)
    sync(dev)
    counters = zero_launches()
    ms = []
    for i in range(1, LM_DECODE_STEPS + 1):
        t1 = time.perf_counter()
        logits, out = step(model, cache, {"tokens": toks[i], "pos": pos[i]})
        sync(dev)
        ms.append((time.perf_counter() - t1) * 1e3)
    launches = check_no_launches(counters, f"{arch_id} {shape}")
    if out[0] is not cache[0] or out[1] is not cache[1]:
        raise AssertionError(f"{arch_id} {shape}: the cache was copied")
    if tuple(logits.shape) != (b, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{arch_id} {shape}: logits not (b, V) finite")
    p50 = float(np.percentile(ms, 50))
    nbytes = decode_bytes(cfg, model, cache, experts)
    rec = dict(layers=cfg.n_layers, batch=b, cache_rows=smax,
               steps=LM_DECODE_STEPS, init_s=round(init_s, 3),
               cache_fill_s=round(fill_s, 3), step_p50_ms=round(p50, 3),
               step_max_ms=round(max(ms), 3),
               tokens_per_s=round(b / p50 * 1e3, 1),
               **peak_memory(dev, mem0), bytes_per_step=nbytes,
               bytes_bound_ms=round(nbytes / HBM_BYTES_PER_S * 1e3, 3),
               kernel_launches=launches)
    if cfg.is_moe:
        rec["experts_read"] = experts
    del model, cache, logits, out
    free(dev)
    log("lm", arch=arch_id, shape=shape, **rec)
    return rec


def lm_arch(dev, arch_id: str, reduced: bool = False) -> dict:
    """One arch: step-1 parity of a one-period copy, then every cell that
    runs (``lm_plan``), each on its own model (the one before freed)."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch_id).config(reduced=reduced)
    rng = np.random.default_rng(LM_SEED)
    zipf = ZipfIds(rng, cfg.vocab)
    out = dict(parity=lm_parity(dev, arch_id, cfg,
                                24 if reduced else LM_PARITY_TOKENS))
    for shape, (c, b, s) in lm_plan(arch_id, reduced).items():
        t0 = time.perf_counter()
        if shape == "train_4k":
            out[shape] = lm_train(dev, arch_id, c, b, s, rng, zipf)
        elif shape == "prefill_32k":
            out[shape] = lm_prefill(dev, arch_id, c, b, s, rng, zipf)
        else:
            out[shape] = lm_decode(dev, arch_id, shape, c, b, s, rng, zipf)
        out[shape]["seconds"] = round(time.perf_counter() - t0, 1)
    return out


def lm_phases(dev, reduced: bool = False) -> dict:
    """The ``lm`` part: the five LM arches, every cell that runs at FULL
    width (bf16 weights; fp32 attention and fp32 products elsewhere: TF32
    stays off); none of the port's kernels launches (the LM path has no
    kernel of its own: the reference's attention, MoE dispatch, RoPE and
    RMS norm are plain ``jnp``)."""
    import torch
    t0 = time.perf_counter()
    log("lm", memory_allocated=(torch.cuda.memory_allocated(dev)
                                if dev.type == "cuda" else None),
        reduced=reduced,
        tf32=bool(torch.backends.cuda.matmul.allow_tf32))
    out = {}
    for arch_id in LM_ARCHES:
        t1 = time.perf_counter()
        out[arch_id] = lm_arch(dev, arch_id, reduced)
        out[arch_id]["seconds"] = round(time.perf_counter() - t1, 1)
        log("lm", arch=arch_id, seconds=out[arch_id]["seconds"])
        if arch_id == "gemma3-27b":     # its long_500k cache, gemma3 freed
            t1 = time.perf_counter()
            out["split_kv"] = split_kv_check(
                dev, *(SPLIT_KV_REDUCED if reduced else ()))
            out["split_kv"]["seconds"] = round(time.perf_counter() - t1, 3)
            free(dev)
            log("lm", **out["split_kv"])
    out["seconds"] = time.perf_counter() - t0
    names = [fn.__name__ for fn in all_launchers()]
    out["kernel_launches"] = {
        name: sum(rec["kernel_launches"][name]
                  for a in LM_ARCHES for cell, rec in out[a].items()
                  if cell != "parity" and isinstance(rec, dict))
        for name in names}
    log("lm", part="lm", seconds=f"{out['seconds']:.1f}",
        kernel_launches=out["kernel_launches"])
    return out


# ---------------------------------------------------------------------------
# perf: the timed half of repro_torch.launch.perf
# ---------------------------------------------------------------------------

# smollm train_4k (layers, batch) here: the twin's own command times the
# LM_CUTS step (~4.7 s a call)
PERF_SMOLLM = (2, 1)


def perf_phase(dev, reduced: bool = False) -> dict:
    """The ``perf`` phase: the timed variants of the perf twin
    (``repro_torch.launch.perf``) on ``dev``, the launch counters zeroed
    just before and read just after: acorn ``serve_25m`` at rank 0's block
    of the 16 x 16 mesh (the baseline, the chunked scan, a bf16 corpus,
    ``filtered_topk`` on the fp32 and on a bf16 corpus), DCN-v2
    ``retrieval_cand`` at FULL, smollm
    ``train_4k`` at ``PERF_SMOLLM``.  The twin's gates raise: the chunked
    scan's ids equal the baseline's (dists within 1e-3), a bf16
    corpus's overlap >= 0.9, ``filtered_topk``'s ids equal except at near
    ties, ``retrieve_opt`` within 1e-5 of ``retrieve``, finite losses and
    bf16 logits' within 2e-2 of fp32's, every ``flop_share`` <= 1.05.  On
    the card ``filtered_topk`` must have launched its kernel, and no other
    kernel may launch.  One ``[perf]`` line a variant."""
    from repro_torch.launch import perf
    t0 = time.perf_counter()
    counters = zero_launches()
    dcn = perf.dcn_timed(dev, reduced=reduced)
    lm = perf.smollm_timed(dev, *(() if reduced else PERF_SMOLLM),
                           reduced=reduced)
    out = {"acorn serve_25m": perf.acorn_timed(dev, reduced=reduced),
           "dcn-v2 retrieval_cand": {name: dcn[opt] for name, _, opt
                                     in perf.DCN_VARIANTS},
           "smollm-360m train_4k": {"baseline, pure_dp": lm[True],
                                    "pure_dp + bf16 logits": lm[False]}}
    launches = {fn.__name__: fn.launches for fn in counters}
    if dev.type == "cuda" and launches["filtered_topk_cuda"] <= 0:
        raise AssertionError("perf: filtered_topk did not launch its kernel")
    if any(v for k, v in launches.items() if k != "filtered_topk_cuda"):
        raise AssertionError(f"perf: another kernel launched: {launches}")
    for cell, recs in out.items():
        for variant, rec in recs.items():
            log("perf", cell=repr(cell), variant=repr(variant),
                ms=rec["ms"], peak_gb=rec["peak_gb"],
                flop_share=rec["flop_share"], byte_share=rec["byte_share"],
                calls=rec["calls"], shape=rec["shape"],
                **rec.get("check", {}))
    if dev.type == "cuda":   # the kernel alone at the block, not counted
        out["filtered_topk_block"] = perf_topk_block(dev)
    out["kernel_launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    log("perf", seconds=f"{out['seconds']:.1f}", kernel_launches=launches)
    return out


def perf_topk_block(dev) -> list:
    """``filtered_topk`` at the perf phase's acorn block (the same inputs:
    B = 512, n = 98,304, d = 512, k = 10, l2), measured as the kernels
    phase measures it (cold L2; the plain version and the cdist yardstick
    beside it), and the baseline step's matmul + mask + ``top_k`` timed
    the same way as its library figure; then on bf16 and fp16 copies of
    the block (``measure_topk_16bit``).  Returns the three records."""
    import torch
    from repro_torch.launch import perf
    from repro_torch.configs.acorn import ACORN_SHAPES
    spec = ACORN_SHAPES[perf.ACORN_SHAPE]
    x, q, masks = perf.acorn_inputs(spec["n"] // perf.RANKS, spec["d"],
                                    spec["batch"], dev)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rec = measure_filtered_topk(q, x, masks, spec["k"], "l2", flush, None,
                                "filtered_topk acorn block")
    xn = (x * x).sum(dim=1)
    neg = float("-inf")
    rec["baseline_library_ms"] = time_ms(lambda: torch.topk(torch.where(
        masks, 2.0 * (q @ x.T) - xn[None, :], neg), spec["k"]), ITERS // 5,
        flush)
    rec["baseline_library_calls"] = ("torch.topk(torch.where(mask, 2 q @ "
                                     "x.T - |x|^2, -inf), k): 5 calls")
    log("perf", kernel="filtered_topk", shape=repr(rec["shape"]),
        baseline_library_ms=rec["baseline_library_ms"])
    return [rec] + measure_topk_16bit(q, x, masks, spec["k"], flush,
                                      "filtered_topk acorn block")


# ---------------------------------------------------------------------------
# roofline: the timed steps counted on meta tensors
# ---------------------------------------------------------------------------

# the acorn variants the mesh phase times, (shape, optimized, chunk), but
# serve_25m at MESH_CHUNK: its 3,072 scan blocks take 15 s to run on meta
# tensors (the meta kernels are Python), half the counting's 30 s, and
# count within 0.002 % of the FLOPs and 0.4 % of the bytes of its
# MESH_WIDE_CHUNK twin
ROOFLINE_ACORN = (("serve_1m", False, MESH_CHUNK),
                  ("serve_1m", True, MESH_CHUNK),
                  ("serve_1m", True, MESH_WIDE_CHUNK),
                  ("serve_25m", True, MESH_WIDE_CHUNK))


def acorn_key(shape: str, opt: bool, chunk: int) -> tuple:
    """The key of ``main``'s ``acorn_ms`` for a timed acorn variant."""
    return (("25m",) if shape == "serve_25m" else ()) + (opt, chunk)


def roofline_steps(reduced: bool = False) -> list:
    """[(name, build)]: the timed steps, each ``build()`` returning (step,
    args) on ``meta`` tensors at the shapes the card runs (the acorn
    variants on a one-device mesh, each LM arch's ``train_4k`` and
    ``prefill_32k`` at ``LM_CUTS``, two-tower ``train_batch``)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.acorn import ACORN_SHAPES, REDUCED_ACORN_SHAPES
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import init_adamw

    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    def acorn(shape, opt, chunk):
        spec = (REDUCED_ACORN_SHAPES if reduced else ACORN_SHAPES)[shape]
        b, n, d = spec["batch"], spec["n"], spec["d"]
        arch, mesh = get_arch("acorn"), make_host_mesh()
        step = arch.step_fn(None, shape, reduced=reduced, mesh=mesh,
                            k=spec["k"], optimized=opt, chunk=chunk)
        return step, arch.place_inputs(shape, mesh, meta((n, d)),
                                       meta((b, d)),
                                       meta((b, n), torch.bool))

    def lm(arch_id, shape, cfg, b, s):
        arch = get_arch(arch_id)
        model = arch.module(cfg)
        tok = meta((b, s), torch.int32)
        if shape == "train_4k":
            return arch.step_fn(cfg, shape), (
                model, init_adamw(model), {"tokens": tok, "labels": tok})
        return arch.step_fn(cfg, shape), (model, {"tokens": tok})

    def two_tower():
        arch = get_arch("two-tower-retrieval")
        cfg = arch.config(reduced=reduced)
        _, _, specs = arch.abstract_inputs(cfg, "train_batch",
                                           reduced=reduced)
        model = arch.module(cfg)
        batch = {k: meta(v.shape, v.dtype) for k, v in specs.items()}
        return arch.step_fn(cfg, "train_batch"), (model, init_adamw(model),
                                                  batch)

    out = [(f"acorn {shape} optimized={opt} chunk={chunk if opt else '-'}",
            lambda a=(shape, opt, chunk): acorn(*a))
           for shape, opt, chunk in ROOFLINE_ACORN]
    for arch_id in LM_ARCHES:
        plan = lm_plan(arch_id, reduced)
        for shape in ("train_4k", "prefill_32k"):
            out.append((f"{arch_id} {shape}",
                        lambda a=(arch_id, shape, *plan[shape]): lm(*a)))
    out.append(("two-tower-retrieval train_batch", two_tower))
    return out


def roofline_counts(reduced: bool = False) -> dict:
    """{name: counts} of every :func:`roofline_steps` step, each run once
    on ``meta`` tensors under ``OpCounter`` (no process group may exist:
    the acorn steps gather on a one-device mesh): counted FLOPs (and their
    dot-class share), bytes, and the roofline's compute and memory terms
    at the H100's peaks; ``"seconds"``: the host time of all of it."""
    from repro_torch.launch.op_cost import OpCounter
    from repro_torch.launch.roofline import analyze
    t_all = time.perf_counter()
    out = {}
    for name, build in roofline_steps(reduced):
        t0 = time.perf_counter()
        step, args = build()
        with OpCounter() as c:
            step(*args)
        roof = analyze(c)
        out[name] = dict(counted_flops=roof.total_flops,
                         dot_flops=c.dot_flops, counted_bytes=c.bytes,
                         t_compute_ms=roof.t_compute * 1e3,
                         t_memory_ms=roof.t_memory * 1e3,
                         count_s=round(time.perf_counter() - t0, 3))
    out["seconds"] = time.perf_counter() - t_all
    return out


def roofline_measured(acorn_ms: dict, train: dict, lm: dict) -> dict:
    """{name: ms} of the counted steps, from the phases' records: the
    acorn variants' ms, each LM arch's ``train_4k`` step p50 and
    ``prefill_32k`` call, two-tower's ``train_batch`` step p50."""
    out = {f"acorn {shape} optimized={opt} chunk={chunk if opt else '-'}":
           acorn_ms[acorn_key(shape, opt, chunk)]
           for shape, opt, chunk in ROOFLINE_ACORN}
    for arch_id in LM_ARCHES:
        out[f"{arch_id} train_4k"] = lm[arch_id]["train_4k"]["step_p50_ms"]
        out[f"{arch_id} prefill_32k"] = lm[arch_id]["prefill_32k"]["ms"]
    out["two-tower-retrieval train_batch"] = \
        train["two_tower"]["step_p50_ms"]
    return out


def roofline_lines(counts: dict, measured: dict) -> list:
    """One ``[roofline]`` line per counted step: its counted FLOPs, the
    compute and memory terms, ``flop_share = t_compute / measured`` and
    ``byte_share = t_memory / measured``.  Raises if a step's
    ``flop_share`` exceeds ``ROOFLINE_FLOP_SHARE_MAX`` (the counter
    overcounts, or a peak is wrong); ``byte_share`` is not gated: eager
    per-op bytes exceed HBM traffic where L2 keeps one op's output for the
    next."""
    lines = []
    for name, ms in measured.items():
        c = counts[name]
        flop_share = c["t_compute_ms"] / ms
        byte_share = c["t_memory_ms"] / ms
        if not flop_share <= ROOFLINE_FLOP_SHARE_MAX:
            raise AssertionError(
                f"{name}: measured {ms} ms beats its counted FLOP time "
                f"{c['t_compute_ms']:.4f} ms (share {flop_share:.3f})")
        lines.append("[roofline] " + " ".join(f"{k}={v}" for k, v in dict(
            step=repr(name), measured_ms=ms,
            counted_flops=c["counted_flops"], dot_flops=c["dot_flops"],
            counted_bytes=c["counted_bytes"],
            t_compute_ms=round(c["t_compute_ms"], 4),
            t_memory_ms=round(c["t_memory_ms"], 4),
            flop_share=round(flop_share, 4),
            byte_share=round(byte_share, 4)).items()))
    return lines


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
                         "neighbor_expand.cu, filtered_topk.cu, "
                         "pna_aggregate.cu and embedding_bag.cu: build them "
                         "into a library of "
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
    # the timed steps counted on meta tensors, in a process of its own
    # (no process group there), beside the kernel build and waited for
    # after it
    import concurrent.futures
    import multiprocessing
    counting = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    roofline_future = counting.submit(roofline_counts)

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
    # the counting ends here, before the first timed phase: no timed phase
    # shares the host with it
    t0 = time.perf_counter()
    counts = roofline_future.result()
    counting.shutdown()
    log("roofline", steps=len(counts) - 1,
        count_host_s=f"{counts['seconds']:.1f}",
        waited_s=f"{time.perf_counter() - t0:.1f}",
        ended="before the first timed phase")
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
        launch_floor_ms=floor_ms, other_shapes=check_expand_wide(dev, flush),
        **ne))
    del vis
    topk_lcps = measure_filtered_topk(q, index.x, pm, TOPK_K, "l2", flush,
                                      base, "filtered_topk LCPS")
    topk_more = measure_topk_16bit(q, index.x, pm, TOPK_K, flush,
                                   "filtered_topk LCPS")
    check_filtered_topk_edges(dev)
    topk_more += check_filtered_topk_large_k(dev, flush)

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
    rec["other_shapes"] = [topk_lcps] + topk_more
    records.append(rec)
    # at (512, 4) the launch floor, not the bytes bound, is the least time
    records.append(dict(bag_phases(dev, flush, model.user_emb, base),
                        launch_floor_ms=floor_ms))
    # ---- train: the two-tower train step on the same FULL model, PNA ----
    train = train_phases(dev, model)
    del model
    torch.cuda.empty_cache()
    # ---- train, pna_sparse: PNA's sparse and minibatch cells ----
    sparse = pna_sparse_phases(dev)
    # ---- train, recsys: DIEN, SASRec and DCN-v2, every cell at FULL ----
    recsys = recsys_phases(dev)
    records.append(pna_phases(dev, flush, args.profile, base, floor_ms))
    for rcd in records:   # the train path runs none of the port's kernels
        rcd["train_launches"] = sum(
            part["kernel_launches"][rcd["name"] + "_cuda"]
            for part in (train["two_tower"], train["pna"], sparse))
        rcd["recsys_launches"] = recsys["kernel_launches"][
            rcd["name"] + "_cuda"]

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

    # ---- lm: the five LM arches at full width, on a card emptied first ----
    del flush, one, q_odd, nodes, qs, ms, ids_c, d_c, sel, graph_calls, cases
    del empty
    torch.cuda.empty_cache()
    lm = lm_phases(dev)     # its sharded steps run on the one-rank mesh
    dist.destroy_process_group()
    for rcd in records:   # the LM path runs none of the port's kernels
        rcd["lm_launches"] = lm["kernel_launches"][rcd["name"] + "_cuda"]

    # ---- perf: the perf twin's timed variants (filtered_topk launches) ----
    torch.cuda.empty_cache()
    perf = perf_phase(dev)
    for rcd in records:
        rcd["perf_launches"] = perf["kernel_launches"][rcd["name"] + "_cuda"]
        if rcd["name"] == "filtered_topk":
            rcd["other_shapes"] += perf["filtered_topk_block"]

    # ---- roofline: each timed step's counted terms beside its time ----
    for line in roofline_lines(counts, roofline_measured(acorn_ms, train,
                                                         lm)):
        print(line, flush=True)

    log("total", seconds=f"{time.perf_counter() - t_all:.1f}")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
