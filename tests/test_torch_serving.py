"""The PyTorch port's serving engine: twins of ``tests/test_serving.py``
on an engine the port builds, and parity with the JAX reference's engine.

Parity: the port's engine is carried across from a reference engine's
shards (``convert.engine_from_arrays``: the same graphs, vectors, tables
and sketch seeds, the id bases following from the shards' sizes; the
reference serves through its host loop on one device) and must return the
reference's ids on ``serve``, after ``fail_shard`` with a mirror, after a
hard shard loss and with every shard down, with the same routes, stats and
flags.  Tolerance: ids identical
except at a near tie (two ids whose float64 distances to the query agree
within ``NEAR_TIE_REL`` = 1e-5 relative), distances within rtol 1e-5 where
the ids agree (atol 1e-6 of |q|^2 + |x|^2 on the exact route's expanded
form) — ``torch_parity.assert_ids_match``.
"""
import numpy as np
import pytest
import torch

import repro.core as J
import repro.serve as JS
import repro_torch.core as T
import repro_torch.serve as TS
from repro.data import make_hcps_dataset as jax_hcps
from repro.data import make_lcps_dataset as jax_lcps
from repro.data import make_workload as jax_workload
from repro_torch.data import make_hcps_dataset, make_lcps_dataset, make_workload
from torch_parity import assert_ids_match, one_thread, port_engine  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ACORN = dict(M=8, gamma=6, m_beta=16, ef_search=64)


@pytest.fixture(scope="module")
def setup():
    ds = make_lcps_dataset(n=2000, d=12, card=6, seed=0, device="cpu")
    wl = make_workload(ds, kind="equals", n_queries=24, k=10, seed=1, card=6)
    return ds, wl, T.AcornConfig(**ACORN)


def engine(setup, **cfg):
    ds, _, acorn = setup
    return TS.ServingEngine(ds.x, ds.table, acorn,
                            TS.EngineConfig(**cfg), device="cpu")


# ---------------------------------------------------------------------------
# twins of tests/test_serving.py
# ---------------------------------------------------------------------------


def test_sharded_engine_recall(setup):
    ds, wl, _ = setup
    eng = engine(setup, batch_size=8, k=10, n_shards=2)
    ids, d = eng.serve(wl.xq, wl.predicates)
    r = T.recall_at_k(ids, wl.gt(ds))
    assert r > 0.8, r
    assert eng.stats["queries"] == 24
    assert eng.stats["batches"] == 3
    # global ids must map back to passing rows
    masks = wl.masks(ds).numpy()
    ids_np = ids.numpy()
    for q in range(ids_np.shape[0]):
        for i in ids_np[q]:
            if i >= 0:
                assert masks[q, i]


def test_partial_batch_padding(setup):
    _, wl, _ = setup
    eng = engine(setup, batch_size=16, k=10, n_shards=1)
    ids, d = eng.serve(wl.xq[:5], wl.predicates[:5])
    assert ids.shape == (5, 10)


def test_failed_shard_then_rebuild(setup):
    _, wl, _ = setup
    eng = engine(setup, batch_size=8, k=10, n_shards=2,
                 duplicate_dispatch=True)
    ids0, _ = eng.serve(wl.xq, wl.predicates)
    eng.fail_shard(0)
    ids1, _ = eng.serve(wl.xq, wl.predicates)
    # mirror answered: results unchanged despite the failed primary
    assert torch.equal(ids0, ids1)
    assert eng.stats["duplicated_dispatches"] > 0
    # rebuild restores a healthy primary and identical results
    eng.rebuild_shard(0)
    assert eng.shards[0].healthy
    ids2, _ = eng.serve(wl.xq, wl.predicates)
    assert torch.equal(ids0, ids2)


def test_hard_shard_loss_degrades_gracefully(setup):
    _, wl, _ = setup
    eng = engine(setup, batch_size=8, k=10, n_shards=2,
                 duplicate_dispatch=False)
    eng.fail_shard(1)
    res = eng.serve(wl.xq, wl.predicates)
    ids, _ = res
    assert ids.shape == (24, 10)
    ids_np = ids.numpy()
    assert (ids_np[ids_np >= 0] < eng.shards[1].base).all()
    assert res.degraded.all()
    assert eng.stats["duplicated_dispatches"] == 0


def test_every_shard_down_degrades_to_empty_results(setup):
    _, wl, _ = setup
    eng = engine(setup, batch_size=8, k=10, n_shards=2,
                 duplicate_dispatch=False)
    eng.fail_shard(0)
    eng.fail_shard(1)
    ids, d = eng.serve(wl.xq, wl.predicates)
    assert ids.shape == (24, 10) and d.shape == (24, 10)
    assert ids.device.type == "cpu"
    assert (ids == -1).all() and torch.isinf(d).all()
    assert eng.stats["queries"] == 24
    assert eng.stats["duplicated_dispatches"] == 0
    eng.rebuild_shard(0)
    eng.rebuild_shard(1)
    ids2, _ = eng.serve(wl.xq, wl.predicates)
    assert (ids2[:, 0] >= 0).all()


def test_merge_topk_stable_and_shard_order_invariant():
    d = torch.tensor([[1.0, 1.0, 2.0, float("inf")]])
    ids_a = torch.tensor([[5, 3, 9, -1]], dtype=torch.int32)
    perm = [1, 3, 0, 2]
    out_a = TS.merge_topk(ids_a, d, 3)
    out_b = TS.merge_topk(ids_a[:, perm], d[:, perm], 3)
    assert out_a[0].tolist() == [[3, 5, 9]]
    assert torch.equal(out_a[0], out_b[0]) and torch.equal(out_a[1],
                                                           out_b[1])
    assert TS.merge_topk(ids_a[:, perm], d[:, perm], 1)[0].tolist() == [[3]]


# ---------------------------------------------------------------------------
# the port's surface: spec, SPMD, schema, request forms
# ---------------------------------------------------------------------------


def test_legacy_knobs_and_spmd_path_raise(setup):
    """The retired knobs raise; a mesh spec is a config now.  On one
    device a 2-shard engine serves through the host loop (the reference's
    rule), and its SPMD program cannot get a 1 x 2 mesh without a process
    group; a 1-shard engine asked for corpus_parallel=1 takes the SPMD
    path on a 1 x 1 mesh and equals its host loop."""
    with pytest.raises(TypeError, match="spec=ExecutionSpec"):
        TS.EngineConfig(use_kernel=True)
    cfg = TS.EngineConfig(spec=T.ExecutionSpec(corpus_parallel=2))
    assert cfg.spec.corpus_parallel == 2 and not cfg.host_fallback
    eng = engine(setup, batch_size=8, n_shards=2)
    assert eng.spmd_mesh_shape() is None and eng.spmd_traces() == {}
    _, wl, _ = setup
    with pytest.raises(ValueError, match="process group"):
        eng._search_batch_spmd(wl.xq[:2], wl.predicates[:2], 1, 2)
    one = engine(setup, batch_size=8, n_shards=1,
                 spec=T.ExecutionSpec(corpus_parallel=1))
    assert one.spmd_mesh_shape() == (1, 1)
    got = one.search_batch(wl.xq[:8], wl.predicates[:8])
    host = one.search_batch_host(wl.xq[:8], wl.predicates[:8])
    assert torch.equal(got.ids, host.ids)
    assert torch.equal(got.dists, host.dists)
    assert one.spmd_traces() == {16: 1}


def test_schema_check_and_request_forms(setup):
    ds, wl, _ = setup
    eng = engine(setup, batch_size=8, k=5, n_shards=2)
    with pytest.raises(TypeError, match="requires predicates"):
        eng.search_batch(wl.xq[:2])
    other = make_hcps_dataset(n=64, d=12, device="cpu")
    foreign = T.compile_predicates([T.TruePredicate()] * 2, other.table)
    with pytest.raises(ValueError, match="schema"):
        eng.search_batch(wl.xq[:2], foreign)
    with pytest.raises(ValueError, match="2 queries but 3 predicates"):
        eng.search_batch(wl.xq[:2], wl.predicates[:3])
    with pytest.raises(TypeError, match="inside the SearchRequest"):
        eng.search_batch(T.SearchRequest(xq=wl.xq[:2]), wl.predicates[:2])
    prog = eng.compile(wl.predicates[:4])
    a = eng.search_batch(T.SearchRequest(xq=wl.xq[:4], predicates=prog,
                                         k=3, route="prefilter"))
    assert a.ids.shape == (4, 3) and (a.routes == "prefilter").all()
    b = eng.search_batch_host(wl.xq[:4], prog)
    assert b.ids.shape == (4, 5)
    # steady state: a repeated shape mix adds no variant-cache entry
    before = eng.trace_counts()
    eng.search_batch_host(wl.xq[:4], prog)
    assert eng.trace_counts() == before


# ---------------------------------------------------------------------------
# parity with the reference engine, its shards carried across
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    jds = jax_lcps(n=2000, d=12, card=6, seed=0)
    jwl = jax_workload(jds, kind="equals", n_queries=24, k=10, seed=1,
                       card=6)
    cfg = dict(batch_size=8, k=10, n_shards=2, duplicate_dispatch=True)
    jeng = JS.ServingEngine(jds.x, jds.table, J.AcornConfig(**ACORN),
                            JS.EngineConfig(**cfg), seed=5)
    teng = port_engine(jeng, T.AcornConfig(**ACORN), TS.EngineConfig(**cfg),
                       seed=5)
    twl = make_workload(make_lcps_dataset(n=2000, d=12, card=6, seed=0,
                                          device="cpu"),
                        kind="equals", n_queries=24, k=10, seed=1, card=6)
    return jds, jwl, jeng, teng, twl


def assert_same(tres, jres, jds, xq):
    assert_ids_match(tres.ids, jres.ids, tres.dists, jres.dists, jds.x, xq,
                     expanded=True)
    assert np.array_equal(tres.routes, jres.routes)
    assert np.array_equal(tres.degraded, np.asarray(jres.degraded))
    assert np.array_equal(tres.shed, np.asarray(jres.shed))
    assert np.array_equal(tres.stats["dist_comps"],
                          np.asarray(jres.stats["dist_comps"]))


def test_engine_from_arrays_carries_the_shards(engines):
    jds, _, jeng, teng, _ = engines
    assert [s.base for s in teng.shards] == [s.base for s in jeng.shards]
    assert torch.equal(teng._x, torch.as_tensor(np.array(jds.x)))
    for ts_, js_ in zip(teng.shards, jeng.shards):
        assert ts_.index.x.data_ptr() == teng._x[ts_.base].data_ptr()
        assert np.array_equal(ts_.index.graph.neighbors[0].numpy(),
                              np.asarray(js_.index.graph.neighbors[0]))
        assert ts_.index.sketch.n_total == js_.index.sketch.n_total


def test_built_shards_must_cover_the_corpus(engines):
    _, _, _, teng, _ = engines
    indexes = [s.index for s in teng.shards]
    for cfg, given in ((teng.cfg, indexes[:1]),
                       (TS.EngineConfig(n_shards=1), indexes[:1])):
        with pytest.raises(ValueError, match="shards of"):
            TS.ServingEngine(teng._x, teng._table, teng.acorn, cfg,
                             device="cpu", indexes=given)


def test_serve_matches_reference(engines):
    jds, jwl, jeng, teng, twl = engines
    for shard in (*jeng.shards, *teng.shards):
        shard.healthy = True
    jres = jeng.serve(jwl.xq, jwl.predicates)
    tres = teng.serve(twl.xq, twl.predicates)
    assert_same(tres, jres, jds, jwl.xq)
    # one batch with a forced route, through a SearchRequest
    jr = jeng.search_batch(J.SearchRequest(
        xq=jwl.xq[:8], predicates=jwl.predicates[:8], k=4, route="graph"))
    tr = teng.search_batch(T.SearchRequest(
        xq=twl.xq[:8], predicates=twl.predicates[:8], k=4, route="graph"))
    assert_same(tr, jr, jds, jwl.xq[:8])


def test_failover_matches_reference(engines):
    """Mirror answers for a failed primary; then a hard loss (mirrors
    off) and every shard down, each as the reference serves it."""
    jds, jwl, jeng, teng, twl = engines
    try:
        for eng in (jeng, teng):
            eng.fail_shard(1)
        assert_same(teng.serve(twl.xq, twl.predicates),
                    jeng.serve(jwl.xq, jwl.predicates), jds, jwl.xq)
        for eng in (jeng, teng):
            eng.cfg.duplicate_dispatch = False
        tres = teng.serve(twl.xq, twl.predicates)
        assert_same(tres, jeng.serve(jwl.xq, jwl.predicates), jds, jwl.xq)
        assert tres.degraded.all()
        for eng in (jeng, teng):
            eng.fail_shard(0)
        tres = teng.serve(twl.xq, twl.predicates)
        jres = jeng.serve(jwl.xq, jwl.predicates)
        assert np.array_equal(tres.ids.numpy(), np.asarray(jres.ids))
        assert np.array_equal(tres.dists.numpy(), np.asarray(jres.dists))
        assert np.array_equal(tres.routes, jres.routes)
        assert np.array_equal(tres.degraded, np.asarray(jres.degraded))
        assert teng.stats == jeng.stats
    finally:
        for eng in (jeng, teng):
            eng.cfg.duplicate_dispatch = True
            for shard in eng.shards:
                shard.healthy = True


@pytest.fixture(scope="module")
def hcps_engines():
    jds = jax_hcps(n=1200, d=8, seed=0)
    tds = make_hcps_dataset(n=1200, d=8, seed=0, device="cpu")
    cfg = dict(batch_size=16, k=10, n_shards=2)
    jeng = JS.ServingEngine(jds.x, jds.table, J.AcornConfig(**ACORN),
                            JS.EngineConfig(**cfg))
    teng = port_engine(jeng, T.AcornConfig(**ACORN), TS.EngineConfig(**cfg))
    return jds, tds, jeng, teng


@pytest.mark.parametrize("kind", ["contains", "contains+between", "regex"])
def test_hcps_serve_matches_reference(hcps_engines, kind):
    jds, tds, jeng, teng = hcps_engines
    jwl = jax_workload(jds, kind=kind, n_queries=16, seed=2)
    twl = make_workload(tds, kind=kind, n_queries=16, seed=2)
    assert_same(teng.serve(twl.xq, twl.predicates),
                jeng.serve(jwl.xq, jwl.predicates), jds, jwl.xq)
