"""The port's query-data-parallel dispatch and mesh collectives against
the JAX reference.

In-process (no process group, one device): bucket planning in mesh
multiples, ``resolve_data_parallel``, the ``ExecutionSpec`` /
``AcornConfig`` mesh defaults, ``search_batch`` clamping an oversized
``data_parallel``.  Spawned ``gloo`` groups of 2 and 4 ranks on the CPU:
``gathered_topk_merge`` and ``sharded_topk``, and ``search_batch`` /
``hybrid_search_sharded`` / the engine with ``data_parallel`` up to the
world (and below it, where ranks outside the mesh take the result by
broadcast).  Every rank must return identical arrays.  The reference runs
in this process on one device; its own tests hold its sharded results
bit-identical to that.  Tolerance: none between ranks and between mesh
shapes; against the reference, ids identical except at near ties
(``torch_parity.assert_ids_match``) and merges bit-identical.

The ranks import this module, so it imports nothing of JAX at module
level.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
import repro_torch.data as TD
from repro_torch.convert import graph_from_arrays
from repro_torch.distributed import (gathered_topk_merge, get_mesh,
                                     local_device_count, mesh_buckets,
                                     resolve_data_parallel, sharded_topk)
from torch_parity import (assert_ids_match, assert_ranks_equal, graph_arrays,
                          one_thread, run_ranks)  # noqa: F401  (fixture)

KW = dict(k=10, ef=32, variant="acorn-gamma", m=8, m_beta=16)


# ---------------------------------------------------------------------------
# in-process: planning, resolution, defaults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("total,buckets,mult", [
    (37, (16, 64), 8), (1, (1, 16, 64), 8), (0, (16, 64), 8),
    (6, (1, 5, 64), 8), (37, (16, 64), 3), (100, (1, 16, 64, 256), 4)])
def test_plan_chunks_in_mesh_multiples_match_reference(total, buckets, mult):
    from repro.core import plan_chunks as ref_plan
    assert T.plan_chunks(total, buckets, multiple_of=mult) == ref_plan(
        total, buckets, multiple_of=mult)


@pytest.mark.parametrize("buckets,mult", [((1, 16, 64, 256), 8),
                                          ((1, 16, 64, 256), 1),
                                          ((3, 5), 4)])
def test_mesh_buckets_match_reference(buckets, mult):
    from repro.distributed import mesh_buckets as ref_mesh_buckets
    assert mesh_buckets(buckets, mult) == ref_mesh_buckets(buckets, mult)


def test_resolve_data_parallel_on_one_device():
    """Without a process group there is one device, as in the reference
    on a one-device host."""
    import jax
    from repro.distributed import resolve_data_parallel as ref_resolve
    assert local_device_count() == jax.local_device_count() == 1
    for v in (None, 0, 1, 3, 10 ** 6):
        assert resolve_data_parallel(v) == ref_resolve(v)


def test_spec_and_config_defaults_match_reference():
    from repro.core import AcornConfig as JAcorn
    from repro.core import ExecutionSpec as JSpec
    s, j = T.ExecutionSpec(), JSpec()
    assert (s.data_parallel, s.corpus_parallel) == (j.data_parallel,
                                                     j.corpus_parallel)
    for dp, cp in [(None, None), (0, 0), (4, 2), (1, 8), (None, 3)]:
        a = T.ExecutionSpec(data_parallel=3).resolve(dp, cp)
        b = JSpec(data_parallel=3).resolve(dp, cp)
        assert (a.data_parallel, a.corpus_parallel) == (b.data_parallel,
                                                         b.corpus_parallel)
    o = T.ExecutionSpec().overlay(data_parallel=0, corpus_parallel=None)
    assert o == T.ExecutionSpec(data_parallel=0)
    ta, ja = T.AcornConfig(), JAcorn()
    assert (ta.data_parallel, ta.corpus_parallel) == (ja.data_parallel,
                                                       ja.corpus_parallel)
    spec = ta.execution_spec()
    assert (spec.data_parallel, spec.corpus_parallel) == (1, None)
    assert hash(T.ExecutionSpec(2, 4)) == hash(T.ExecutionSpec(2, 4))


@pytest.fixture(scope="module")
def lcps(one_thread):
    """The reference's graph over the LCPS corpus of its 8-device test,
    and the port's dataset (equal to the reference's)."""
    import jax
    from repro.core import build_acorn_gamma
    from repro.data import make_lcps_dataset
    jds = make_lcps_dataset(n=1200, d=12, card=6, seed=0)
    g = build_acorn_gamma(jds.x, jax.random.PRNGKey(0), M=8, gamma=6,
                          m_beta=16)
    tds = TD.make_lcps_dataset(n=1200, d=12, card=6, seed=0, device="cpu")
    twl = TD.make_workload(tds, kind="equals", n_queries=37, k=10, seed=1,
                           card=6)
    return jds, g, tds, twl


def test_search_batch_clamps_oversized_data_parallel(lcps):
    """data_parallel beyond the devices degrades to what exists — on one
    device exactly the unsharded path; keys carry the resolved count."""
    _, g, tds, twl = lcps
    tg = graph_from_arrays(**graph_arrays(g), device="cpu")
    masks = twl.masks(tds)
    kw = dict(KW, buckets=(16,))
    ids1, d1, _ = T.search_batch(tg, tds.x, twl.xq, masks,
                                 spec=T.ExecutionSpec(data_parallel=1), **kw)
    cache = T.VariantCache()
    ids2, d2, _ = T.search_batch(tg, tds.x, twl.xq, masks, cache=cache,
                                 spec=T.ExecutionSpec(data_parallel=16), **kw)
    assert torch.equal(ids1, ids2) and torch.equal(d1, d2)
    assert all(key[-1].data_parallel == 1 and key[-1].corpus_parallel == 1
               for key in cache.fns)
    ids3, d3, _ = T.hybrid_search_sharded(tg, tds.x, twl.xq, masks, **KW)
    assert torch.equal(ids1, ids3) and torch.equal(d1, d3)
    with pytest.raises(TypeError, match="data_parallel"):
        T.hybrid_search_sharded(tg, tds.x, twl.xq, masks, 2, **KW)


# ---------------------------------------------------------------------------
# spawned gloo groups
# ---------------------------------------------------------------------------


def _collectives_rank(rank, world, ids, d, scores, k):
    """gathered_topk_merge along a 1-D 'corpus' mesh (each rank brings its
    column block of the candidates) and sharded_topk on every
    ("data", "model") factorisation of the world."""
    kp = ids.shape[1] // world
    cols = slice(rank * kp, (rank + 1) * kp)
    mesh = get_mesh((world,), ("corpus",))
    mi, md = gathered_topk_merge(torch.as_tensor(ids[:, cols]),
                                 torch.as_tensor(d[:, cols]), k, "corpus",
                                 mesh)
    out = dict(merge=(mi.numpy(), md.numpy()))
    sids = torch.arange(scores.shape[1], dtype=torch.int32).expand(
        scores.shape[0], -1).contiguous()
    for dp in [v for v in (1, 2, 4) if world % v == 0]:
        mesh2 = get_mesh((dp, world // dp), ("data", "model"))
        i, s = sharded_topk(mesh2, "data", "model")(k)(
            torch.as_tensor(scores), sids)
        out[f"topk{dp}"] = (i.numpy(), s.numpy())
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_match_reference(world, tmp_path):
    import jax
    import jax.numpy as jnp
    from repro.distributed.collectives import merge_topk as ref_merge
    from repro.distributed.collectives import sharded_topk as ref_sharded
    rng = np.random.default_rng(world)
    b, kp, k = 8, 6, 5
    ids = rng.permutation(1000)[: b * kp * world].reshape(b, -1)
    ids = ids.astype(np.int32)
    d = rng.integers(0, 6, size=ids.shape).astype(np.float32)  # ties
    d[rng.random(d.shape) < 0.2] = np.inf
    ids[~np.isfinite(d)] = -1
    ids[0, : kp] = ids[0, kp: 2 * kp]            # exact duplicates (mirror)
    d[0, : kp] = d[0, kp: 2 * kp]
    scores = rng.integers(-4, 4, size=(b, 16 * world)).astype(np.float32)
    scores[rng.random(scores.shape) < 0.3] = -np.inf
    got = run_ranks(_collectives_rank, world, tmp_path, ids, d, scores, k)
    assert_ranks_equal(got)
    wi, wd = ref_merge(jnp.asarray(ids), jnp.asarray(d), k)
    np.testing.assert_array_equal(got[0]["merge"][0], np.asarray(wi))
    np.testing.assert_array_equal(got[0]["merge"][1].view(np.int32),
                                  np.asarray(wd).view(np.int32))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    si, ss = ref_sharded(mesh, "data", "model")(k)(
        jnp.asarray(scores), jnp.asarray(np.broadcast_to(
            np.arange(scores.shape[1], dtype=np.int32), scores.shape)))
    for key in [key for key in got[0] if key.startswith("topk")]:
        np.testing.assert_array_equal(got[0][key][0], np.asarray(si),
                                      err_msg=key)
        np.testing.assert_array_equal(got[0][key][1], np.asarray(ss),
                                      err_msg=key)


def _query_parallel_rank(rank, world, garrays):
    ds = TD.make_lcps_dataset(n=1200, d=12, card=6, seed=0, device="cpu")
    wl = TD.make_workload(ds, kind="equals", n_queries=37, k=10, seed=1,
                          card=6)
    masks = wl.masks(ds)
    g = graph_from_arrays(**garrays, device="cpu")
    out = dict(ndev=local_device_count(),
               resolved=[resolve_data_parallel(v)
                         for v in (None, 0, 1, 3, 10 ** 6)])
    for dp in (1, 2, world):
        cache = T.VariantCache()
        spec = T.ExecutionSpec(data_parallel=dp)
        ids, d, st = T.search_batch(g, ds.x, wl.xq, masks, buckets=(16, 64),
                                    cache=cache, spec=spec, **KW)
        traces = cache.bucket_traces()
        T.search_batch(g, ds.x, wl.xq, masks, buckets=(16, 64), cache=cache,
                       spec=spec, **KW)
        out[f"dp{dp}"] = dict(
            ids=ids.numpy(), d=d.numpy(), dc=st.dist_comps.numpy(),
            hops=st.hops.numpy(), traces=traces, again=cache.num_traces,
            key_dp=sorted({key[-1].data_parallel for key in cache.fns}))
    ids, d, st = T.hybrid_search_sharded(g, ds.x, wl.xq, masks, **KW)
    out["sharded"] = (ids.numpy(), d.numpy(), st.dist_comps.numpy())
    for dp in (1, world):
        ids, d, _ = T.search_batch(g, ds.x, wl.xq, None, buckets=(16,),
                                   spec=T.ExecutionSpec(data_parallel=dp),
                                   **KW)
        out[f"nomask{dp}"] = ids.numpy()
    from repro_torch.serve import EngineConfig, ServingEngine
    acorn = T.AcornConfig(M=8, gamma=6, m_beta=16, ef_search=32,
                          buckets=(16, 64))
    for dp in (1, world):
        eng = ServingEngine(ds.x, ds.table, acorn, EngineConfig(
            batch_size=16, k=10, n_shards=2,
            spec=T.ExecutionSpec(data_parallel=dp)), device="cpu")
        res = eng.serve(wl.xq, wl.predicates)
        out[f"engine{dp}"] = (res.ids.numpy(), res.dists.numpy(),
                              eng.spmd_mesh_shape())
    return out


def test_query_parallel_search_bit_identical(lcps, tmp_path):
    """search_batch at data_parallel 1, 2 and 4 over a 4-rank group (at 2,
    ranks 2-3 are outside the mesh), hybrid_search_sharded over every
    rank, the unfiltered path and the engine's data_parallel: bit-identical
    to one device, on every rank, and the reference's ids."""
    import jax.numpy as jnp
    from repro.core import VariantCache, search_batch
    jds, g, tds, twl = lcps
    world = 4
    got = run_ranks(_query_parallel_rank, world, tmp_path, graph_arrays(g))
    assert_ranks_equal(got)
    out = got[0]
    assert out["ndev"] == world
    assert out["resolved"] == [world, world, 1, 3, world]
    base = out["dp1"]
    for dp in (2, world):
        r = out[f"dp{dp}"]
        for f in ("ids", "d", "dc", "hops"):
            np.testing.assert_array_equal(r[f], base[f], err_msg=f"dp{dp}")
        assert r["traces"] == {16: 1} and r["again"] == 1
        assert r["key_dp"] == [dp]
    np.testing.assert_array_equal(out["sharded"][0], base["ids"])
    np.testing.assert_array_equal(out["sharded"][1], base["d"])
    np.testing.assert_array_equal(out["sharded"][2], base["dc"])
    np.testing.assert_array_equal(out["nomask1"], out[f"nomask{world}"])
    e1, ew = out["engine1"], out[f"engine{world}"]
    np.testing.assert_array_equal(e1[0], ew[0])
    np.testing.assert_array_equal(e1[1], ew[1])
    assert e1[2] == (1, 2) and ew[2] == (2, 2)
    wi, wd, wst = search_batch(g, jds.x, jnp.asarray(twl.xq.numpy()),
                               jnp.asarray(twl.masks(tds).numpy()),
                               buckets=(16, 64), cache=VariantCache(), **KW)
    assert_ids_match(base["ids"], wi, base["d"], wd, tds.x, twl.xq)
    np.testing.assert_array_equal(base["dc"], np.asarray(wst.dist_comps))
