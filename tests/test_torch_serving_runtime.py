"""The PyTorch port's continuous-batching runtime: twins of the one-device
tests of ``tests/test_serving_runtime.py``, each run on the port and, where
the scenario is deterministic (the manual clock), on the reference too.

The port's engine is carried across from the reference engine's shard
(``convert.engine_from_arrays``), so the same request stream must
coalesce into the same dispatches: ``dispatch_log`` compositions, batch
histograms, admission keys and shed counts identical to the reference's,
and the served ids the reference's.  Tolerance for ids: identical except
at a near tie (float64 distances within 1e-5 relative), distances within
rtol 1e-5 — ``torch_parity.assert_ids_match``.  The threaded tests run the
port's worker against the real clock.  The 8-device SPMD twin runs on 8
``gloo`` ranks in ``test_torch_corpus_faults.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core as J
import repro.serve as JS
import repro_torch.core as T
import repro_torch.serve as TS
from repro.data import make_lcps_dataset as jax_lcps
from repro.data import make_workload as jax_workload
from repro_torch.data import make_lcps_dataset, make_workload
from torch_parity import assert_ids_match, one_thread, port_engine  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

K, EF = 5, 16
BUCKETS = (4, 8)          # coalesce cap = 8 queries
ACORN = dict(M=8, gamma=4, m_beta=16, ef_search=EF, buckets=BUCKETS)
ENGINE = dict(batch_size=8, k=K, ef=EF, n_shards=1)


class ManualClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture(scope="module")
def cell():
    jds = jax_lcps(n=400, d=8, card=4, seed=0)
    jwl = jax_workload(jds, kind="equals", n_queries=32, k=K, seed=1, card=4)
    jeng = JS.ServingEngine(jds.x, jds.table, J.AcornConfig(**ACORN),
                            JS.EngineConfig(**ENGINE))
    teng = port_engine(jeng, T.AcornConfig(**ACORN),
                       TS.EngineConfig(**ENGINE))
    tds = make_lcps_dataset(n=400, d=8, card=4, seed=0, device="cpu")
    twl = make_workload(tds, kind="equals", n_queries=32, k=K, seed=1,
                        card=4)
    ref = SimpleNamespace(core=J, serve=JS, eng=jeng, wl=jwl, x=jds.x)
    port = SimpleNamespace(core=T, serve=TS, eng=teng, wl=twl, x=jds.x)
    return ref, port


def reqs(side, size, count, start=0):
    return [side.core.SearchRequest(
        xq=side.wl.xq[start + i * size:start + (i + 1) * size],
        predicates=list(side.wl.predicates[start + i * size:
                                           start + (i + 1) * size]), k=K)
        for i in range(count)]


def ids_of(tickets):
    return np.concatenate([np.asarray(t.result().ids) for t in tickets])


def dists_of(tickets):
    return np.concatenate([np.asarray(t.result().dists) for t in tickets])


def assert_same_results(port_tickets, ref_tickets, cell, xq):
    ref, _ = cell
    assert_ids_match(ids_of(port_tickets), ids_of(ref_tickets),
                     dists_of(port_tickets), dists_of(ref_tickets), ref.x,
                     xq)


def both(cell, scenario):
    """Run ``scenario(side)`` on the reference and on the port; returns
    (reference's, port's) outputs."""
    return tuple(scenario(side) for side in cell)


# ---------------------------------------------------------------------------
# coalescing + dispatch policy (manual clock)
# ---------------------------------------------------------------------------


def test_coalesce_deadline_holds_then_dispatches_one_batch(cell):
    def scenario(side):
        clock = ManualClock()
        rt = side.serve.ServingRuntime(
            side.eng, side.serve.RuntimeConfig(coalesce_deadline=0.01),
            clock=clock)
        tickets = [rt.submit(r) for r in reqs(side, 2, 3)]
        assert rt.step(now=0.0) == 0
        assert all(not t.done() for t in tickets)
        clock.t = 0.01
        assert rt.step(now=0.01) == 3
        assert all(t.done() for t in tickets)
        return rt, tickets

    (rt_j, t_j), (rt_t, t_t) = both(cell, scenario)
    assert rt_t.dispatch_log == rt_j.dispatch_log == [(0, 1, 2)]
    assert rt_t.stats().batch_hist == rt_j.stats().batch_hist == {6: 1}
    assert_same_results(t_t, t_j, cell, cell[0].wl.xq[:6])


def test_full_bucket_dispatches_before_deadline(cell):
    def scenario(side):
        rt = side.serve.ServingRuntime(
            side.eng, side.serve.RuntimeConfig(coalesce_deadline=10.0),
            clock=ManualClock())
        tickets = [rt.submit(r) for r in reqs(side, 2, 4)]
        assert rt.step(now=0.0) == 4
        assert all(t.done() for t in tickets)
        return rt, tickets

    (rt_j, t_j), (rt_t, t_t) = both(cell, scenario)
    assert rt_t.stats().batch_hist == rt_j.stats().batch_hist == {8: 1}
    assert rt_t.dispatch_log == rt_j.dispatch_log
    assert_same_results(t_t, t_j, cell, cell[0].wl.xq[:8])


def test_overfull_group_drains_in_cap_sized_batches(cell):
    def scenario(side):
        clock = ManualClock()
        rt = side.serve.ServingRuntime(
            side.eng, side.serve.RuntimeConfig(coalesce_deadline=0.01),
            clock=clock)
        tickets = [rt.submit(r) for r in reqs(side, 2, 5)]
        assert rt.step(now=0.0) == 4
        assert rt.stats().queued_queries == 2
        clock.t = 0.01
        assert rt.step(now=0.01) == 1
        return rt, tickets

    (rt_j, t_j), (rt_t, t_t) = both(cell, scenario)
    assert rt_t.stats().batch_hist == rt_j.stats().batch_hist == {8: 1, 2: 1}
    assert rt_t.dispatch_log == rt_j.dispatch_log == [(0, 1, 2, 3), (4,)]
    assert_same_results(t_t, t_j, cell, cell[0].wl.xq[:10])


def test_results_match_direct_engine_call(cell):
    _, port = cell
    rt = TS.ServingRuntime(port.eng, clock=ManualClock())
    tickets = [rt.submit(r) for r in reqs(port, 2, 8)]
    rt.pump()
    want = port.eng.search_batch(T.SearchRequest(
        xq=port.wl.xq[:16], predicates=list(port.wl.predicates[:16]), k=K,
        ef=EF))
    assert np.array_equal(ids_of(tickets), want.ids.numpy())
    assert np.array_equal(dists_of(tickets), want.dists.numpy())
    assert not any(bool(t.result().shed.any()) for t in tickets)
    assert all(t.result().ids.device.type == "cpu" for t in tickets)


def test_mixed_program_shapes_group_separately(cell):
    def scenario(side):
        core = side.core
        rt = side.serve.ServingRuntime(side.eng, clock=ManualClock())
        t_a = rt.submit(core.SearchRequest(
            xq=side.wl.xq[:2], predicates=list(side.wl.predicates[:2]), k=K))
        deep = [core.And(tuple(core.Between("label", v, v + 1)
                               for v in range(4))
                         + (core.Equals("label", 0),))] * 2
        t_b = rt.submit(core.SearchRequest(xq=side.wl.xq[2:4],
                                           predicates=deep, k=K))
        assert len(rt._groups) == 2
        keys = sorted(map(repr, rt._groups))
        rt.pump()
        assert rt.stats().dispatches == 2
        want_b = side.eng.search_batch(core.SearchRequest(
            xq=side.wl.xq[2:4], predicates=deep, k=K, ef=EF))
        assert np.array_equal(np.asarray(t_b.result().ids),
                              np.asarray(want_b.ids))
        assert t_a.result().ids.shape == (2, K)
        return rt, keys, [t_a, t_b]

    (rt_j, keys_j, t_j), (rt_t, keys_t, t_t) = both(cell, scenario)
    assert sorted(rt_t.dispatch_log) == sorted(rt_j.dispatch_log) == [
        (0,), (1,)]
    # the admission keys name the same program shapes, k, ef and route
    strip = [k.split(", TableSchema")[0] for k in keys_j]
    assert [k.split(", TableSchema")[0] for k in keys_t] == strip
    assert_same_results(t_t, t_j, cell, cell[0].wl.xq[:4])


# ---------------------------------------------------------------------------
# deterministic coalescing under equal arrival timestamps
# ---------------------------------------------------------------------------


def test_equal_arrival_timestamps_replay_identically(cell):
    def run_once(side):
        rt = side.serve.ServingRuntime(
            side.eng, side.serve.RuntimeConfig(coalesce_deadline=0.01),
            clock=ManualClock(0.0))
        tickets = [rt.submit(r) for r in reqs(side, 2, 7)]
        rt.pump()
        return list(rt.dispatch_log), ids_of(tickets), tickets

    _, port = cell
    log1, ids1, _ = run_once(port)
    log2, ids2, t_t = run_once(port)
    assert log1 == log2
    assert log1[0] == (0, 1, 2, 3)
    assert np.array_equal(ids1, ids2)
    log_j, _, t_j = run_once(cell[0])
    assert log1 == log_j
    assert_same_results(t_t, t_j, cell, cell[0].wl.xq[:14])


# ---------------------------------------------------------------------------
# backpressure
# ---------------------------------------------------------------------------


def test_overload_sheds_sentinel_and_never_raises(cell):
    def scenario(side):
        rt = side.serve.ServingRuntime(
            side.eng, side.serve.RuntimeConfig(max_queue=4,
                                               coalesce_deadline=10.0),
            clock=ManualClock())
        kept = [rt.submit(r) for r in reqs(side, 2, 2)]
        shed = rt.submit(reqs(side, 2, 1, start=4)[0])
        assert shed.done()
        res = shed.result()
        assert bool(np.asarray(res.shed).all())
        assert (np.asarray(res.ids) == -1).all()
        assert np.isinf(np.asarray(res.dists)).all()
        st = rt.stats()
        assert st.shed == 2 and st.queued_queries == 4
        rt.pump()
        assert all((np.asarray(t.result().ids)[:, 0] >= 0).all()
                   for t in kept)
        return rt, kept

    (rt_j, t_j), (rt_t, t_t) = both(cell, scenario)
    assert rt_t.dispatch_log == rt_j.dispatch_log
    assert rt_t.stats().shed == rt_j.stats().shed
    assert_same_results(t_t, t_j, cell, cell[0].wl.xq[:4])


def test_stop_without_drain_sheds_leftovers(cell):
    _, port = cell
    rt = TS.ServingRuntime(port.eng,
                           TS.RuntimeConfig(coalesce_deadline=30.0)).start()
    tickets = [rt.submit(r) for r in reqs(port, 2, 2)]
    rt.stop(drain=False)
    for t in tickets:
        assert bool(t.result(timeout=5).shed.all())
    assert rt.stats().shed == 4


def test_stop_with_drain_serves_far_deadline_queue(cell):
    _, port = cell
    rt = TS.ServingRuntime(port.eng,
                           TS.RuntimeConfig(coalesce_deadline=30.0)).start()
    tickets = [rt.submit(r) for r in reqs(port, 2, 2)]
    rt.stop(drain=True)
    for t in tickets:
        assert not bool(t.result(timeout=5).shed.any())
    assert rt._thread is None


# ---------------------------------------------------------------------------
# SLO-aware ef / route selection
# ---------------------------------------------------------------------------


def test_slo_picks_largest_ef_that_fits_budget(cell):
    def scenario(side):
        cfg = side.serve.RuntimeConfig(coalesce_deadline=0.01,
                                       slo_budget=0.05, ef_ladder=(8, EF))
        rt = side.serve.ServingRuntime(side.eng, cfg, clock=ManualClock())
        rt._ewma_er[(EF, None)] = 10.0
        rt._ewma_er[(8, None)] = 1e-4
        t = rt.submit(reqs(side, 2, 1)[0])
        (key,) = rt._groups
        assert key[-2] == 8 and key[-1] is None
        rt.pump()
        return key[-3:], [t]

    (key_j, t_j), (key_t, t_t) = both(cell, scenario)
    assert key_t == key_j
    assert_same_results(t_t, t_j, cell, cell[0].wl.xq[:2])


def test_slo_unknown_latency_is_optimistic(cell):
    def scenario(side):
        cfg = side.serve.RuntimeConfig(slo_budget=0.05, ef_ladder=(8, EF))
        rt = side.serve.ServingRuntime(side.eng, cfg, clock=ManualClock())
        rt.submit(reqs(side, 2, 1)[0])
        (key,) = rt._groups
        rt.pump()
        return key[-3:]

    key_j, key_t = both(cell, scenario)
    assert key_t == key_j and key_t[-2] == EF


def test_slo_hopeless_budget_routes_selective_to_prefilter(cell):
    def scenario(side):
        core = side.core
        cfg = side.serve.RuntimeConfig(coalesce_deadline=0.01,
                                       slo_budget=0.05, ef_ladder=(8, EF))
        rt = side.serve.ServingRuntime(side.eng, cfg, clock=ManualClock())
        rt._ewma_er[(EF, None)] = 10.0
        rt._ewma_er[(8, None)] = 10.0
        selective = [core.And((core.Equals("label", 0),
                               core.Equals("label", 1)))] * 2
        t = rt.submit(core.SearchRequest(xq=side.wl.xq[:2],
                                         predicates=selective, k=K))
        (key,) = rt._groups
        assert key[-2] == 8 and key[-1] == "prefilter"
        rt.pump()
        assert (np.asarray(t.result().routes) == "prefilter").all()
        return key[-3:], rt.estimate_selectivity(
            side.eng.compile(selective))

    (key_j, est_j), (key_t, est_t) = both(cell, scenario)
    assert key_t == key_j
    assert np.array_equal(est_t, est_j)


# ---------------------------------------------------------------------------
# trace accounting + metrics
# ---------------------------------------------------------------------------


def test_runtime_steady_state_mints_no_new_traces(cell):
    _, port = cell
    ds = make_lcps_dataset(n=400, d=8, card=4, seed=0, device="cpu")
    acorn = T.AcornConfig(**dict(ACORN, gamma=8))
    eng = TS.ServingEngine(ds.x, ds.table, acorn, TS.EngineConfig(**ENGINE),
                           device="cpu")
    rt = TS.ServingRuntime(eng, clock=ManualClock())
    for _ in range(3):
        [rt.submit(r) for r in reqs(port, 2, 4)]
        rt.pump()
    traces = eng.shards[0].index.cache.bucket_traces()
    assert traces and all(v == 1 for v in traces.values()), traces


def test_stats_snapshot(cell):
    def scenario(side):
        clock = ManualClock()
        rt = side.serve.ServingRuntime(
            side.eng, side.serve.RuntimeConfig(max_queue=8,
                                               coalesce_deadline=0.01),
            clock=clock)
        [rt.submit(r) for r in reqs(side, 2, 4)]
        shed = rt.submit(reqs(side, 2, 1, start=8)[0])
        assert shed.done()
        clock.t = 0.02
        rt.step(now=0.02)
        return rt.stats()

    st_j, st = both(cell, scenario)
    assert st.submitted == 5 and st.completed == 8 and st.shed == 2
    assert st.dispatches == 1 and st.queue_depth == 0
    assert st.qps > 0 and st.latency_p50 > 0
    assert st.latency_p99 >= st.latency_p50
    assert sum(k * v for k, v in st.batch_hist.items()) == 8
    assert set(st.per_bucket) == {8}
    assert st.per_bucket[8]["count"] == 8
    ((bucket, ef, route),) = st.latency_model
    assert bucket == 8 and ef == EF and route is None
    for name in ("submitted", "completed", "shed", "degraded", "dispatches",
                 "queue_depth", "queued_queries", "qps", "latency_p50",
                 "latency_p99", "batch_hist"):
        assert getattr(st, name) == getattr(st_j, name), name
    assert set(st.latency_model) == set(st_j.latency_model)


def test_threaded_worker_serves_open_loop(cell):
    _, port = cell
    cfg = TS.RuntimeConfig(coalesce_deadline=0.005)
    with TS.ServingRuntime(port.eng, cfg) as rt:
        tickets = [rt.submit(r) for r in reqs(port, 2, 6)]
        ids = np.concatenate([t.result(timeout=60).ids.numpy()
                              for t in tickets])
    want = port.eng.search_batch(T.SearchRequest(
        xq=port.wl.xq[:12], predicates=list(port.wl.predicates[:12]), k=K,
        ef=EF))
    assert np.array_equal(ids, want.ids.numpy())
    assert rt.stats().completed == 12


def test_queries_stay_on_the_engine_device(cell):
    """numpy queries are admitted onto the engine's device; a request of
    the wrong arity raises at submit."""
    _, port = cell
    rt = TS.ServingRuntime(port.eng, clock=ManualClock())
    t = rt.submit(T.SearchRequest(xq=port.wl.xq[:3].numpy(),
                                  predicates=list(port.wl.predicates[:3]),
                                  k=K))
    (group,) = rt._groups.values()
    assert isinstance(group[0].xq, torch.Tensor)
    assert group[0].xq.device == port.eng.device
    rt.pump()
    assert t.result().ids.shape == (3, K)
    with pytest.raises(ValueError, match="3 queries but 2 predicates"):
        rt.submit(T.SearchRequest(xq=port.wl.xq[:3],
                                  predicates=list(port.wl.predicates[:2])))
