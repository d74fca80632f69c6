"""The port's corpus-sharded SPMD serving against the JAX reference.

In-process (no process group, one device): mesh-shape resolution, the
host loop when the devices cannot hold the mesh, ``stack_corpus`` /
``stack_regex_aux`` arrays equal to the reference's for the same shards,
padding invisibility, the empty batch, a corpus without columns,
``search_batch`` refusing a multi-shard ``corpus_parallel``, and the SPMD
path on a 1x1 mesh.  Spawned ``gloo`` groups of 8 ranks on the CPU: the
reference's 8-device script (``tests/test_corpus_parallel.py``) — every
``(data, corpus)`` shape of 8 ranks, the auto mesh, mirrored failover,
rebuild, hard loss and every shard down — and the runtime's SPMD twin
(``tests/test_serving_runtime.py``).

The port's engines are carried across from the reference's shards
(``convert.engine_from_arrays``); the reference serves through its host
loop on one device, which its own tests hold bit-identical to its SPMD
path.  Tolerance: none between the ranks and between the port's SPMD path
and its host loop (ids and distances bit for bit); against the reference,
ids identical except at near ties, distances within rtol 1e-5
(``torch_parity.assert_ids_match``).  A rebuilt shard is the port's own
build (the reference's level draw cannot be reproduced), so after a
rebuild the converted engine is held to its host loop, and the rebuild
drill's "ids come back" runs on an engine the port builds on every rank.

The ranks import this module, so it imports nothing of JAX at module
level.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
import repro_torch.data as TD
from repro_torch.convert import engine_from_arrays
from repro_torch.distributed import (corpus_search_batch, local_device_count,
                                     resolve_corpus_mesh_shape, shard_slice,
                                     stack_corpus, stack_regex_aux)
from repro_torch.serve import (EngineConfig, RuntimeConfig, ServingEngine,
                               ServingRuntime)
from torch_parity import (assert_ids_match, assert_ranks_equal,
                          engine_arrays, one_thread,  # noqa: F401  (fixture)
                          port_engine, run_ranks)

ACORN = dict(M=8, gamma=6, m_beta=16, ef_search=32, buckets=(16, 64))
BS = 16
MESHES = [(2, 4), (4, 2), (1, 8), (8, 1)]


def lcps_workload():
    ds = TD.make_lcps_dataset(n=1200, d=12, card=6, seed=0, device="cpu")
    wl = TD.make_workload(ds, kind="equals", n_queries=37, k=10, seed=1,
                          card=6)
    return ds, wl


# ---------------------------------------------------------------------------
# in-process
# ---------------------------------------------------------------------------


def test_resolve_corpus_mesh_shape_matches_reference():
    from repro.distributed import resolve_corpus_mesh_shape as ref
    assert local_device_count() == 1
    for n_shards in (1, 2, 3):
        for dp in (None, 0, 1, 2, 10 ** 6):
            for cp in (None, 0, n_shards):
                assert resolve_corpus_mesh_shape(n_shards, dp, cp) == ref(
                    n_shards, dp, cp), (n_shards, dp, cp)
    assert resolve_corpus_mesh_shape(1, corpus_parallel=1) == (1, 1)
    for bad in ((2, None, 3), (1, None, 2)):
        with pytest.raises(ValueError):
            resolve_corpus_mesh_shape(*bad)
        with pytest.raises(ValueError):
            ref(*bad)


def test_engine_serves_through_host_loop_without_devices(one_thread):
    """More shards than devices serves through the host loop."""
    ds = TD.make_lcps_dataset(n=400, d=8, card=4, seed=0, device="cpu")
    wl = TD.make_workload(ds, kind="equals", n_queries=5, k=5, seed=1, card=4)
    eng = ServingEngine(ds.x, ds.table, T.AcornConfig(
        M=8, gamma=4, m_beta=16, ef_search=16, buckets=(8,)),
        EngineConfig(batch_size=8, k=5, n_shards=2), device="cpu")
    assert eng.spmd_mesh_shape() is None
    ids, _ = eng.serve(wl.xq, wl.predicates)
    assert ids.shape == (5, 5)
    assert eng.spmd_traces() == {}


@pytest.fixture(scope="module")
def hcps_engines(one_thread):
    """A reference engine over an HCPS corpus (three unequal shards:
    real padding) and the port's engine over its shards."""
    from repro.core import AcornConfig
    from repro.data import make_hcps_dataset
    from repro.serve import EngineConfig as JCfg
    from repro.serve import ServingEngine as JEngine
    jds = make_hcps_dataset(n=700, d=10, seed=0)
    jeng = JEngine(jds.x, jds.table, AcornConfig(M=8, gamma=4, m_beta=16,
                                                 ef_search=24),
                   JCfg(batch_size=8, k=5, n_shards=3))
    teng = port_engine(jeng, T.AcornConfig(M=8, gamma=4, m_beta=16,
                                           ef_search=24),
                       EngineConfig(batch_size=8, k=5, n_shards=3))
    return jeng, teng


def test_stack_corpus_equals_reference(hcps_engines):
    from repro.core import compile_predicates as jcompile
    from repro.core.predicates import RegexMatch as JRegex
    from repro.distributed import stack_corpus as ref_stack
    from repro.distributed import stack_regex_aux as ref_aux
    jeng, teng = hcps_engines
    want = ref_stack([s.index.graph for s in jeng.shards],
                     [s.index.x for s in jeng.shards],
                     [s.base for s in jeng.shards],
                     tables=[s.index.table for s in jeng.shards])
    got = stack_corpus([s.index.graph for s in teng.shards],
                       [s.index.x for s in teng.shards],
                       [s.base for s in teng.shards],
                       tables=[s.index.table for s in teng.shards])
    assert got.n_shards == want.n_shards == 3
    pairs = [(got.x, want.x), (got.bases, want.bases),
             (got.n_rows, want.n_rows), (got.graph.entry_point,
                                         want.graph.entry_point),
             (got.graph.levels, want.graph.levels),
             (got.columns.ints, want.columns.ints)]
    pairs += list(zip(got.graph.neighbors, want.graph.neighbors))
    pairs += list(zip(got.graph.pos, want.graph.pos))
    pairs += list(zip(got.graph.node_ids, want.graph.node_ids))
    for a, b in pairs:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        got.columns.bitsets.numpy().view(np.uint32),
        np.asarray(want.columns.bitsets))
    prog = jcompile([JRegex("caption", r"\bgreen\b"),
                     JRegex("caption", r"\bcity\b")], jeng._table)
    n_max = int(got.x.shape[1])
    np.testing.assert_array_equal(
        stack_regex_aux([s.index.table for s in teng.shards], n_max,
                        prog.regex_leaves).numpy(),
        np.asarray(ref_aux([s.index.table for s in jeng.shards], n_max,
                           prog.regex_leaves)))


def test_stack_corpus_rejects_mixed_schemas(hcps_engines):
    _, teng = hcps_engines
    tables = [s.index.table for s in teng.shards]
    odd = TD.make_lcps_dataset(n=int(teng.shards[2].index.x.shape[0]), d=10,
                               card=4, seed=0, device="cpu").table
    with pytest.raises(ValueError, match="schema"):
        stack_corpus([s.index.graph for s in teng.shards],
                     [s.index.x for s in teng.shards],
                     [s.base for s in teng.shards], tables=tables[:2] + [odd])


def test_stack_corpus_padding_is_search_invisible(one_thread):
    """A shard's slice of the stacked (padded) corpus searches
    bit-identically to its own unpadded graph."""
    ds = TD.make_lcps_dataset(n=700, d=10, card=4, seed=0, device="cpu")
    wl = TD.make_workload(ds, kind="equals", n_queries=7, k=5, seed=1, card=4)
    eng = ServingEngine(ds.x, ds.table, T.AcornConfig(M=8, gamma=4,
                                                      m_beta=16,
                                                      ef_search=24),
                        EngineConfig(batch_size=8, k=5, n_shards=3),
                        device="cpu")
    corpus = stack_corpus([s.index.graph for s in eng.shards],
                          [s.index.x for s in eng.shards],
                          [s.base for s in eng.shards])
    n_max = max(int(s.index.x.shape[0]) for s in eng.shards)
    assert corpus.x.shape == (3, n_max, 10) and corpus.columns is None
    kw = dict(k=5, ef=24, variant="acorn-gamma", m=8, m_beta=16)
    for s, shard in enumerate(eng.shards):
        gp, xp = shard_slice(corpus, s)
        n_s = int(shard.index.x.shape[0])
        assert torch.equal(xp[:n_s], shard.index.x)
        assert bool((xp[n_s:] == 0).all())
        masks = eng.compile(wl.predicates).evaluate(shard.index.table)
        padded = torch.zeros((masks.shape[0], n_max), dtype=torch.bool)
        padded[:, :n_s] = masks
        i1, d1, st1 = T.hybrid_search(shard.index.graph, shard.index.x,
                                      wl.xq, masks, **kw)
        i2, d2, st2 = T.hybrid_search(gp, xp, wl.xq, padded, **kw)
        for a, b in ((i1, i2), (d1, d2), (st1.dist_comps, st2.dist_comps),
                     (st1.hops, st2.hops)):
            assert torch.equal(a, b)


def _two_shard_corpus():
    ds = TD.make_lcps_dataset(n=300, d=8, card=4, seed=0, device="cpu")
    eng = ServingEngine(ds.x, ds.table, T.AcornConfig(M=8, gamma=4,
                                                      m_beta=16,
                                                      ef_search=16),
                        EngineConfig(batch_size=8, k=5, n_shards=2),
                        device="cpu")
    return ds, eng


def _search(corpus, prog, aux, b):
    z = torch.zeros
    return corpus_search_batch(
        corpus, z((b, 8)), prog, aux, z((2, b, 5), dtype=torch.int32),
        z((2, b, 5)), z((2, b), dtype=torch.bool),
        torch.ones((2,), dtype=torch.bool), k=5, ef=16,
        variant="acorn-gamma", m=8, m_beta=16, metric="l2",
        compressed_level0=True, max_expansions=64,
        spec=T.ExecutionSpec(data_parallel=1, corpus_parallel=2),
        buckets=(8,), cache=T.VariantCache())


def test_corpus_search_batch_empty_batch():
    ds, eng = _two_shard_corpus()
    tables = [s.index.table for s in eng.shards]
    corpus = stack_corpus([s.index.graph for s in eng.shards],
                          [s.index.x for s in eng.shards],
                          [s.base for s in eng.shards], tables=tables)
    prog = T.compile_predicates([T.Equals("label", 0)], ds.table).take(
        np.arange(0))
    aux = stack_regex_aux(tables, int(corpus.x.shape[1]), prog.regex_leaves)
    ids, d, dcs, hps = _search(corpus, prog, aux, 0)
    assert ids.shape == (0, 5) and d.shape == (0, 5)
    assert dcs.shape == (2, 0) and hps.shape == (2, 0)


def test_corpus_search_batch_requires_columns():
    ds, eng = _two_shard_corpus()
    corpus = stack_corpus([s.index.graph for s in eng.shards],
                          [s.index.x for s in eng.shards],
                          [s.base for s in eng.shards])  # no tables
    prog = T.compile_predicates([T.Equals("label", 0)], ds.table)
    aux = torch.zeros((2, 1, int(corpus.x.shape[1])), dtype=torch.bool)
    with pytest.raises(ValueError, match="without attribute tables"):
        _search(corpus, prog, aux, 1)


def test_search_batch_rejects_multi_shard_corpus_parallel():
    """search_batch searches one corpus shard: a multi-shard request fails
    loudly; a single-shard one pins cp = 1 in its keys."""
    ds, eng = _two_shard_corpus()
    wl = TD.make_workload(ds, kind="equals", n_queries=4, k=3, seed=1, card=4)
    g = eng.shards[0].index.graph
    x = eng.shards[0].index.x
    masks = wl.masks(ds)[:, : x.shape[0]]
    kw = dict(k=3, ef=8, variant="acorn-gamma", m=8, m_beta=16, buckets=(4,))
    for cp in (2, 3):
        with pytest.raises(ValueError, match="corpus_parallel"):
            T.search_batch(g, x, wl.xq, masks,
                           spec=T.ExecutionSpec(corpus_parallel=cp), **kw)
    cache = T.VariantCache()
    for cp in (None, 0, 1):
        T.search_batch(g, x, wl.xq, masks, cache=cache,
                       spec=T.ExecutionSpec(corpus_parallel=cp), **kw)
    assert {key[-1].corpus_parallel for key in cache.fns} == {1}


def reference(cps, faults=False):
    """The reference's engines over the 8-device script's corpus at each
    shard count of ``cps``, their host-loop answers, the exact top-10 and
    the reference's ``recall_at_k``.  With ``faults``, the 4-shard
    engine's answers with shard 0 down behind a mirror (``mirrored``) and
    with shard 1 lost (``lost1``)."""
    from repro.core import AcornConfig, recall_at_k
    from repro.data import make_lcps_dataset, make_workload
    from repro.serve import EngineConfig as JCfg
    from repro.serve import ServingEngine as JEngine
    jds = make_lcps_dataset(n=1200, d=12, card=6, seed=0)
    jwl = make_workload(jds, kind="equals", n_queries=37, k=10, seed=1,
                        card=6)
    engines, answers = {}, {}
    for cp in cps:
        e = JEngine(jds.x, jds.table, AcornConfig(**ACORN),
                    JCfg(batch_size=BS, k=10, n_shards=cp))
        engines[cp] = e
        answers[cp] = e.serve(jwl.xq, jwl.predicates)
    if faults:
        arrays = {cp: engine_arrays(e) for cp, e in engines.items()}
        e4 = engines[4]
        e4.cfg.duplicate_dispatch = True
        e4.fail_shard(0)
        answers["mirrored"] = e4.serve(jwl.xq, jwl.predicates)
        e4.cfg.duplicate_dispatch = False
        e4.shards[0].healthy = True
        e4.fail_shard(1)
        answers["lost1"] = e4.serve(jwl.xq, jwl.predicates)
        e4.shards[1].healthy = True
    else:
        arrays = {cp: engine_arrays(e) for cp, e in engines.items()}
    return arrays, answers, np.asarray(jwl.gt(jds)), recall_at_k


@pytest.fixture(scope="module")
def reference_1_8(one_thread):
    return reference((1, 8))


def test_spmd_path_on_one_device_matches_host_loop_and_reference(
        reference_1_8):
    """corpus_parallel=1 takes the SPMD path on a 1x1 mesh without a
    process group (the reference does on one device); it equals the host
    loop bit for bit and the reference's ids; ``host_fallback`` forces the
    host loop."""
    arrays, answers, _, _ = reference_1_8
    want = answers[1]
    ds, wl = lcps_workload()
    spec = T.ExecutionSpec(corpus_parallel=1)
    eng, fb = (engine_from_arrays(arrays[1], T.AcornConfig(**ACORN),
                                  EngineConfig(batch_size=BS, k=10,
                                               n_shards=1, spec=spec,
                                               host_fallback=flag),
                                  device="cpu")
               for flag in (False, True))
    assert eng.spmd_mesh_shape() == (1, 1) and fb.spmd_mesh_shape() is None
    got = eng.serve(wl.xq, wl.predicates)
    host = fb.serve(wl.xq, wl.predicates)
    assert torch.equal(got.ids, host.ids) and torch.equal(got.dists,
                                                          host.dists)
    assert list(got.routes) == list(host.routes) == list(want.routes)
    np.testing.assert_array_equal(got.stats["dist_comps"],
                                  np.asarray(want.stats["dist_comps"]))
    assert eng.spmd_traces() == {16: 1} and fb.spmd_traces() == {}
    assert_ids_match(got.ids, want.ids, got.dists, want.dists, ds.x, wl.xq,
                     expanded=True)


# ---------------------------------------------------------------------------
# spawned: the reference's 8-device script on 8 gloo ranks
# ---------------------------------------------------------------------------


def _serve_both(eng, wl):
    """SPMD (``serve``) and host-loop results of the workload, 16-query
    batches, as numpy."""
    r = eng.serve(wl.xq, wl.predicates)
    host = [eng.search_batch_host(wl.xq[s:s + BS],
                                  list(wl.predicates[s:s + BS]))
            for s in range(0, wl.xq.shape[0], BS)]
    return dict(ids=r.ids.numpy(), d=r.dists.numpy(),
                routes=list(r.routes), degraded=r.degraded.tolist(),
                host_ids=torch.cat([h.ids for h in host]).numpy(),
                host_d=torch.cat([h.dists for h in host]).numpy(),
                host_routes=[x for h in host for x in h.routes])


def _engine_rank(rank, world, arrays, meshes, drills):
    """Every (dp, cp) of ``meshes`` over the converted cp-shard engine;
    with ``drills``, the auto mesh over 2 shards, the mirrored failover
    with a rebuild, and the hard loss over 4 shards (2 x 4)."""
    ds, wl = lcps_workload()
    acorn = T.AcornConfig(**ACORN)
    out = dict(resolved=[resolve_corpus_mesh_shape(*a) for a in (
        (1,), (1, None, 1), (world + 1,), (2,), (2, 1), (2, 10 ** 6),
        (4, 2), (8,))])

    def engine(cp, spec, config=acorn, **cfg):
        return engine_from_arrays(
            arrays[cp], config, EngineConfig(
                batch_size=BS, k=10, n_shards=cp, spec=spec, **cfg),
            device="cpu")

    for dp, cp in meshes:
        eng = engine(cp, T.ExecutionSpec(data_parallel=dp,
                                         corpus_parallel=cp))
        res = _serve_both(eng, wl)
        res["mesh"] = eng.spmd_mesh_shape()
        res["traces"] = eng.spmd_traces()
        eng.serve(wl.xq, wl.predicates)
        res["traces_again"] = eng.spmd_traces()
        res["keys"] = [(k[-1], k[-2].data_parallel, k[-2].corpus_parallel,
                        isinstance(k[-3], tuple)) for k in eng.spmd_cache.fns]
        out[f"mesh{dp}x{cp}"] = res
    if not drills:
        return out
    # auto geometry: corpus_parallel=None picks (world // 2, 2)
    eng = engine(2, None, config=T.AcornConfig(data_parallel=0, **ACORN))
    out["auto"] = dict(_serve_both(eng, wl), mesh=eng.spmd_mesh_shape())
    # mirrored failover, then rebuild (the port's own build of shard 0)
    mesh24 = T.ExecutionSpec(data_parallel=2, corpus_parallel=4)
    eng = engine(4, mesh24, duplicate_dispatch=True)
    drill = dict(healthy=_serve_both(eng, wl),
                 dup0=eng.stats["duplicated_dispatches"])
    eng.fail_shard(0)
    drill["failed"] = _serve_both(eng, wl)
    drill["dup1"] = eng.stats["duplicated_dispatches"]
    eng.rebuild_shard(0)
    drill["rebuilt"] = _serve_both(eng, wl)
    drill["dup2"] = eng.stats["duplicated_dispatches"]
    out["mirrored"] = drill
    # hard loss without mirrors, every shard down
    eng = engine(4, mesh24)
    loss = dict(healthy=_serve_both(eng, wl))
    eng.fail_shard(1)
    loss["lost1"] = _serve_both(eng, wl)
    loss["bounds"] = (eng.shards[1].base, eng.shards[2].base)
    for s in range(4):
        eng.fail_shard(s)
    loss["down"] = _serve_both(eng, wl)
    loss["dup"] = eng.stats["duplicated_dispatches"]
    out["loss"] = loss
    return out


def held(res, want, ds, wl, tag):
    """SPMD == host loop bit for bit (ids, distances, routes); with
    ``want``, the reference's routes and ids."""
    np.testing.assert_array_equal(res["ids"], res["host_ids"], err_msg=tag)
    np.testing.assert_array_equal(res["d"], res["host_d"], err_msg=tag)
    assert res["routes"] == res["host_routes"], tag
    if want is not None:
        assert res["routes"] == list(want.routes), tag
        assert_ids_match(res["ids"], want.ids, res["d"], want.dists, ds.x,
                         wl.xq, expanded=True)


def check_meshes(out, meshes, answers, gt, recall_at_k):
    ds, wl = lcps_workload()
    assert out["resolved"] == [None, (8, 1), None, (4, 2), (1, 2), (4, 2),
                               (2, 4), (1, 8)]
    for dp, cp in meshes:
        res = out[f"mesh{dp}x{cp}"]
        tag = f"mesh {dp}x{cp}"
        assert res["mesh"] == (dp, cp), tag
        held(res, answers[cp], ds, wl, tag)
        # parity alone cannot catch a bug both paths share
        assert float(recall_at_k(res["ids"], gt)) > 0.9, tag
        assert res["traces"] == res["traces_again"] == {16: 1}, tag
        assert all(k == ("corpus", dp, cp, True) for k in res["keys"]), tag


def test_corpus_sharded_spmd_parity_8_ranks_1x8_and_8x1(reference_1_8,
                                                         tmp_path):
    """The 1 x 8 and 8 x 1 meshes of 8 ranks (the 2 x 4 and 4 x 2 meshes
    and the fault drills are in ``test_torch_corpus_faults.py``)."""
    arrays, answers, gt, recall_at_k = reference_1_8
    meshes = [(1, 8), (8, 1)]
    got = run_ranks(_engine_rank, 8, tmp_path, arrays, meshes, False)
    assert_ranks_equal(got)
    check_meshes(got[0], meshes, answers, gt, recall_at_k)


# ---------------------------------------------------------------------------
# spawned: the runtime's SPMD twin, and a rebuild on the port's own build
# ---------------------------------------------------------------------------


def _runtime_rank(rank, world, shards):
    """The runtime over a (2, 2) SPMD engine and its host-loop twin; the
    rebuild drill on an engine the port builds (identically on every
    rank)."""
    from repro_torch.core import SearchRequest
    ds, wl = lcps_workload()
    acorn = T.AcornConfig(M=8, gamma=6, m_beta=16, ef_search=32,
                          buckets=(16,))
    mesh = T.ExecutionSpec(data_parallel=2, corpus_parallel=2)

    def run(eng):
        rt = ServingRuntime(eng, RuntimeConfig(coalesce_deadline=0.01))
        tickets = [rt.submit(SearchRequest(
            xq=wl.xq[s:s + 3], predicates=list(wl.predicates[s:s + 3]),
            k=10)) for s in range(0, 24, 3)]
        rt.pump()
        return dict(ids=torch.cat([t.result().ids for t in tickets]).numpy(),
                    d=torch.cat([t.result().dists for t in tickets]).numpy(),
                    log=list(rt.dispatch_log), mesh=eng.spmd_mesh_shape(),
                    traces=eng.spmd_traces())

    out = {}
    for name, fb in (("spmd", False), ("host", True)):
        eng = engine_from_arrays(shards, acorn, EngineConfig(
            batch_size=16, k=10, ef=32, n_shards=2, spec=mesh,
            host_fallback=fb), device="cpu")
        out[name] = run(eng)
    spec = T.ExecutionSpec(data_parallel=2, corpus_parallel=4)
    eng = ServingEngine(ds.x, ds.table, T.AcornConfig(**ACORN), EngineConfig(
        batch_size=BS, k=10, n_shards=4, duplicate_dispatch=True, spec=spec),
        device="cpu")
    drill = dict(healthy=_serve_both(eng, wl))
    eng.fail_shard(2)
    drill["failed"] = _serve_both(eng, wl)
    eng.rebuild_shard(2)
    drill["rebuilt"] = _serve_both(eng, wl)
    eng = ServingEngine(ds.x, ds.table, T.AcornConfig(**ACORN), EngineConfig(
        batch_size=BS, k=10, n_shards=4, spec=spec), device="cpu")
    for s in range(4):
        eng.fail_shard(s)
    drill["down"] = _serve_both(eng, wl)
    for s in range(4):
        eng.rebuild_shard(s)
    drill["all_rebuilt"] = _serve_both(eng, wl)
    out["drill"] = drill
    return out
