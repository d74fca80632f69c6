"""The PyTorch port's ``HybridIndex`` against the JAX reference.

Same data (the numpy-seeded LCPS generator), the reference's graph carried
across, the same sketch seed: ``HybridIndex.search`` must route every
query as the reference does (§5.2) and return its ids on both routes (a
differing slot only at a near tie, which is checked).  Also: bucket
planning and the variant cache of ``search_batch``, the index built by
the port from the reference's levels, and the retired execution kwargs.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.data import make_lcps_dataset as jax_lcps
from repro.data import make_workload as jax_workload
from repro_torch.data import make_lcps_dataset, make_workload
from torch_parity import assert_ids_match, port_graph, port_table

N, D, CARD, M, GAMMA, M_BETA = 1200, 16, 12, 8, 12, 16
# a sketch sample smaller than n, so estimates scatter around 1/CARD and
# the §5.2 rule sends queries down both routes
SKETCH = 600


def _cfgs(variant):
    return (J.AcornConfig(M=M, gamma=GAMMA, m_beta=M_BETA, variant=variant),
            T.AcornConfig(M=M, gamma=GAMMA, m_beta=M_BETA, variant=variant))


@pytest.fixture(scope="module")
def indexes():
    jds = jax_lcps(n=N, d=D, card=CARD, seed=0)
    tds = make_lcps_dataset(n=N, d=D, card=CARD, seed=0, device="cpu")
    assert np.array_equal(tds.x.numpy(), np.asarray(jds.x))
    out = {}
    for variant in ("acorn-gamma", "acorn-1"):
        jcfg, tcfg = _cfgs(variant)
        jidx = dataclasses.replace(
            J.HybridIndex.build(jds.x, jds.table, jcfg, seed=0),
            sketch=J.SelectivitySketch.build(jds.table, SKETCH, seed=0))
        tidx = T.HybridIndex(
            x=tds.x, table=port_table(jds.table), graph=port_graph(jidx.graph),
            config=tcfg,
            sketch=T.SelectivitySketch.build(tds.table, SKETCH, seed=0))
        out[variant] = (jidx, tidx)
    return jds, tds, out


@pytest.mark.parametrize("route", [None, "graph", "prefilter"])
@pytest.mark.parametrize("variant", ["acorn-gamma", "acorn-1"])
def test_search_matches_reference(indexes, variant, route):
    jds, tds, idx = indexes
    jidx, tidx = idx[variant]
    jwl = jax_workload(jds, kind="equals", n_queries=40, card=CARD, seed=3)
    twl = make_workload(tds, kind="equals", n_queries=40, card=CARD, seed=3)
    assert np.array_equal(twl.xq.numpy(), np.asarray(jwl.xq))
    assert twl.predicates == [T.Equals(p.column, p.value)
                              for p in jwl.predicates]
    jres = jidx.search(J.SearchRequest(xq=jwl.xq, predicates=jwl.predicates,
                                       k=10, route=route))
    tres = tidx.search(T.SearchRequest(xq=twl.xq, predicates=twl.predicates,
                                       k=10, route=route))
    assert np.array_equal(tres.routes, jres.routes)
    if route is None:   # the sketch must split this workload both ways
        assert set(tres.routes) == {"graph", "prefilter"}
    assert np.array_equal(tres.stats["selectivity_est"],
                          jres.stats["selectivity_est"])
    assert_ids_match(tres.ids, jres.ids, tres.dists, jres.dists, jds.x,
                     jwl.xq, expanded=route != "graph")
    ids, d, info = tres
    assert ids is tres.ids and "routes" in info


def test_prefilter_ground_truth_matches_reference(indexes):
    jds, tds, _ = indexes
    jwl = jax_workload(jds, kind="equals", n_queries=24, card=CARD, seed=5)
    twl = make_workload(tds, kind="equals", n_queries=24, card=CARD, seed=5)
    assert np.array_equal(twl.masks(tds).numpy(), np.asarray(jwl.masks(jds)))
    jids, jd = J.masked_topk(jwl.xq, jds.x, jwl.masks(jds), 10)
    tids, td = T.masked_topk(twl.xq, tds.x, twl.masks(tds), 10)
    assert_ids_match(tids, jids, td, jd, jds.x, jwl.xq, expanded=True)
    # fewer rows pass than k: -1 / +inf padding as in the reference
    few = np.zeros((2, N), bool)
    few[:, :3] = True
    jids, jd = J.masked_topk(jwl.xq[:2], jds.x, jnp.asarray(few), 10)
    tids, td = T.masked_topk(twl.xq[:2], tds.x, torch.from_numpy(few), 10)
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    assert np.array_equal(np.isinf(td.numpy()), np.isinf(np.asarray(jd)))


def test_build_from_reference_levels(indexes):
    """``HybridIndex.build`` with the reference's levels builds its graph."""
    jds, tds, idx = indexes
    jidx, _ = idx["acorn-gamma"]
    _, tcfg = _cfgs("acorn-gamma")
    built = T.HybridIndex.build(tds.x, tds.table, tcfg, seed=0, device="cpu",
                                levels=np.asarray(jidx.graph.levels))
    for a, b in zip(built.graph.neighbors, jidx.graph.neighbors):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert built.index_bytes == J.memory_bytes(jidx.graph)
    assert built.total_bytes == jidx.total_bytes


def test_plan_chunks_matches_reference():
    for total in (0, 1, 5, 16, 37, 64, 100, 300, 513):
        for buckets in ((1, 16, 64, 256), (16, 64), (8,)):
            assert (T.plan_chunks(total, buckets)
                    == J.plan_chunks(total, buckets))
            if total:
                assert (T.bucket_for(total, buckets)
                        == J.batched.bucket_for(total, buckets))
                assert (T.coalesce_take(total, buckets)
                        == J.batched.coalesce_take(total, buckets))
    assert T.mesh_buckets((1, 16, 64), 8) == J.mesh_buckets((1, 16, 64), 8)


def test_variant_cache_flat_on_repeated_shapes(indexes):
    jds, tds, idx = indexes
    _, tidx = idx["acorn-gamma"]
    twl = make_workload(tds, kind="equals", n_queries=40, card=CARD, seed=4)
    cache = T.VariantCache()
    masks = twl.masks(tds)
    kw = dict(k=10, ef=32, m=M, m_beta=M_BETA, buckets=(1, 16),
              cache=cache)
    for rep in range(2):
        for b in (1, 5, 17, 33):
            ids, d, st = T.search_batch(tidx.graph, tds.x, twl.xq[:b],
                                        masks[:b], **kw)
            ref, _, _ = T.hybrid_search(tidx.graph, tds.x, twl.xq[:b],
                                        masks[:b], k=10, ef=32, m=M,
                                        m_beta=M_BETA)
            assert torch.equal(ids, ref)
        if rep == 0:
            first = dict(cache.bucket_traces())
    assert cache.bucket_traces() == first == {1: 1, 16: 1}


@pytest.mark.parametrize("knob", ["use_kernel", "interpret", "expand_kernel",
                                  "data_parallel", "corpus_parallel"])
def test_retired_kwargs_raise(indexes, knob):
    jds, tds, idx = indexes
    _, tidx = idx["acorn-gamma"]
    twl = make_workload(tds, kind="equals", n_queries=4, card=CARD)
    with pytest.raises(TypeError, match=knob):
        tidx.search(T.SearchRequest(xq=twl.xq, predicates=twl.predicates),
                    **{knob: True})
    with pytest.raises(TypeError, match=knob):
        T.search_batch(tidx.graph, tds.x, twl.xq, None, **{knob: True})
    if knob in ("use_kernel", "interpret", "expand_kernel"):
        with pytest.raises(TypeError, match=knob):
            T.hybrid_search(tidx.graph, tds.x, twl.xq, None, **{knob: True})


@pytest.mark.parametrize("field", ["data_parallel", "corpus_parallel"])
def test_mesh_sizes_wait_for_a_later_slice(field):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.ExecutionSpec(**{field: 2})
    assert T.ExecutionSpec() == T.ExecutionSpec(1, 1)
