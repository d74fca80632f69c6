"""``chip_smoke.py``'s mesh phase on CPU tensors, at a small size.

The phase's functions take any device: on the CPU they join a one-rank
``gloo`` group, run the ``acorn`` step at its REDUCED shapes (both
variants, held to each other and to an exact float64 recompute) and the
one-shard SPMD engine over an HCPS corpus of 1,200 rows (bit-identical to
its host loop, held to a CPU copy's host loop, the all-down sentinel, a
rebuild returning the same ids), where no kernel launches.  Tolerance: as the phase's own checks (near
ties only; ids and dists bit for bit between the engine's paths).
"""
import importlib.util
import os

import pytest
import torch
import torch.distributed as dist

import repro_torch.data as TD
from torch_parity import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def group():
    """The phase's one-rank process group, left as it was found."""
    smoke = _chip_smoke()
    assert not dist.is_initialized()
    smoke.mesh_group(torch.device("cpu"))
    try:
        yield smoke
    finally:
        dist.destroy_process_group()


def test_mesh_group_gathers_through_gloo(capsys):
    from repro_torch.distributed import local_device_count
    smoke = _chip_smoke()
    smoke.mesh_group(torch.device("cpu"))
    try:
        assert dist.get_backend() == "gloo" and local_device_count() == 1
    finally:
        dist.destroy_process_group()
    assert "all_gather_equal=True" in capsys.readouterr().out


@pytest.mark.parametrize("shape,variants", [
    ("serve_1m", ((False, 8192), (True, 8192), (True, 512))),
    ("serve_25m", ((True, 8192),))])
def test_acorn_serve_runs_on_cpu_tensors(group, shape, variants, capsys):
    ms = group.acorn_serve(torch.device("cpu"), shape, variants, None,
                           reduced=True)
    assert ms == {v: None for v in variants}        # nothing timed here
    out = capsys.readouterr().out
    assert out.count(f"[parity] path=acorn {shape}") == len(variants)
    assert "ms=not_measured" in out and "bound_by=" in out
    assert out.count("near_ties=") == 2 * len(variants) - 1


def test_mesh_engine_runs_on_cpu_tensors(group, capsys):
    smoke = group
    ds = TD.make_hcps_dataset(n=1200, d=8, seed=0, device="cpu")
    closed, _ = smoke.engine_workloads(ds, n_closed=48, n_kind=4)
    launches = smoke.mesh_engine(torch.device("cpu"), ds, closed,
                                 n_queries=48)
    assert set(launches.values()) == {0}     # plain versions on the CPU
    out = capsys.readouterr().out
    for key in ("path=engine spmd", "mesh=(1, 1)",
                "bit_identical_to_host=True", "rebuilt_equal=True",
                "fail_all_down_sentinel=True",
                "[parity] path=engine spmd queries=16"):
        assert key in out, key


def test_exact_topk64_is_the_masked_top_k():
    smoke = _chip_smoke()
    g = torch.Generator().manual_seed(0)
    x = torch.randn((300, 6), generator=g)
    q = torch.randn((4, 6), generator=g)
    masks = torch.rand((4, 300), generator=g) < 0.5
    masks[0, 5:] = False
    ids, d = smoke.exact_topk64(x, q, masks, 10, rows=64)
    full = ((q.double()[:, None] - x.double()[None]) ** 2).sum(-1)
    full[~masks] = float("inf")
    want_d, want_i = torch.sort(full, dim=1, stable=True)
    assert torch.equal(ids[1:].long(), want_i[1:, :10])
    assert torch.allclose(d[1:], want_d[1:, :10], rtol=1e-9)
    assert (ids[0, 5:] == -1).all() and torch.isinf(d[0, 5:]).all()
