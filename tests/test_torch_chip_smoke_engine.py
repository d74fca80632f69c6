"""``chip_smoke.py``'s engine phase on CPU tensors.

The phase's input helpers must draw what the reference draws at the same
seeds (its workloads are ``make_workload``'s, its open-loop arrivals the
launcher's Poisson schedule), its engine must be the launcher's, and the
whole phase — closed loop, every workload kind, open loop, overload,
failover drill and the CPU-copy parity — must run to its end at a tiny
corpus on the CPU, where no kernel launches.  Tolerance: none; arrays and
predicates equal.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import repro.data as JD
import repro_torch.data as TD
from torch_parity import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")


def _chip_smoke():
    """chip_smoke.py, loaded from the repo root (it imports no torch or
    JAX at module level)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_engine_workloads_are_the_references():
    smoke = _chip_smoke()
    jds = JD.make_hcps_dataset(n=3000, d=8, seed=0)
    tds = TD.make_hcps_dataset(n=3000, d=8, seed=0, device="cpu")
    closed, kinds = smoke.engine_workloads(tds, n_closed=48, n_kind=16)
    want = JD.make_workload(jds, kind="contains", n_queries=48, k=10, seed=1)
    assert np.array_equal(closed.xq.numpy(), np.asarray(want.xq))
    assert [repr(p) for p in closed.predicates] == [
        repr(p) for p in want.predicates]
    assert len(kinds) == len(smoke.ENGINE_KINDS) == 5
    for (kind, cor), (name, wl) in zip(smoke.ENGINE_KINDS, kinds.items()):
        want = JD.make_workload(jds, kind=kind, correlation=cor,
                                n_queries=16, k=10, seed=2)
        assert name == want.name
        assert np.array_equal(wl.xq.numpy(), np.asarray(want.xq))
        assert [repr(p) for p in wl.predicates] == [
            repr(p) for p in want.predicates]


def test_open_loop_arrivals_are_the_launchers():
    smoke = _chip_smoke()
    rng = np.random.default_rng(0)   # as repro.launch.serve.run_open
    want = np.cumsum(rng.exponential(1.0 / 37.5, size=256))
    assert np.array_equal(smoke.open_loop_arrivals(256, 37.5, seed=0), want)


def test_engine_is_the_launchers():
    """The phase serves the launcher's engine at the reference's serve_1m
    corpus shape (n = 2^20, d = 512), four shards."""
    smoke = _chip_smoke()
    assert (smoke.ENGINE_N, smoke.ENGINE_D) == (1 << 20, 512)
    assert smoke.ENGINE_SHARDS == 4 and smoke.ENGINE_BATCH == 32
    assert smoke.ENGINE_M_BETA == 2 * smoke.ENGINE_M == 32
    assert (smoke.ENGINE_GAMMA, smoke.ENGINE_EF_SEARCH) == (12, 96)


def test_engine_phase_runs_on_cpu_tensors(capsys):
    smoke = _chip_smoke()
    dev = torch.device("cpu")
    ds, engine = smoke.engine_build(dev, n=1200, d=8)
    closed, kinds = smoke.engine_workloads(ds, n_closed=32, n_kind=4)
    launches = smoke.engine_serving(dev, ds, engine, closed, kinds,
                                    profile=False)
    assert set(launches.values()) == {0}     # plain versions on the CPU
    out = capsys.readouterr().out
    for line in ("loop=closed", "kind=regex regex_patterns", "loop=open",
                 "loop=overload", "drill=failover", "[parity] path=engine"):
        assert line in out, line
    assert "rebuilt_equal=True" in out
    assert len(engine.shards) == 4 and all(s.healthy for s in engine.shards)


@pytest.mark.parametrize("kind", ["contains", "regex"])
def test_corpus_masks_concatenate_the_shards(kind):
    """The phase's whole-corpus masks, shard by shard, are the masks of the
    whole table."""
    smoke = _chip_smoke()
    from repro_torch.core import AcornConfig
    from repro_torch.serve import EngineConfig, ServingEngine
    ds = TD.make_hcps_dataset(n=1000, d=4, seed=1, device="cpu")
    engine = ServingEngine(ds.x, ds.table, AcornConfig(M=4, gamma=4),
                           EngineConfig(n_shards=3), device="cpu")
    wl = TD.make_workload(ds, kind=kind, n_queries=12)
    prog = engine.compile(wl.predicates)
    assert torch.equal(smoke.corpus_masks(engine, prog),
                       prog.evaluate(ds.table))
