"""gather_distance in the PyTorch port against the JAX reference.

The port's plain version is held against the reference's jnp oracle and
its Pallas kernel (interpret mode) on the same numpy inputs, for l2 and
ip, with -1 padding and out-of-range ids (clipped into [0, n-1] before
the row load).  Tolerance rtol 1e-5 / atol 1e-5: the fp32 sums run in
different orders.  The CUDA kernel's edge cases (``CARD_CASES``, the same
list as ``chip_smoke.py``'s ``GD_EDGE_CASES``) are held against the
reference on the CPU and against the plain version on the card (skipped
without one).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gather_distance.kernel import gather_distance_pallas
from repro.kernels.gather_distance.ref import gather_distance_ref as jax_ref
from repro_torch.kernels.gather_distance import (gather_distance,
                                                 gather_distance_cuda,
                                                 gather_distance_ref)
from torch_parity import cuda_device  # noqa: F401  (fixture)

B, M, N, D = 5, 12, 40, 16

# the CUDA kernel's edge cases, the same as GD_EDGE_CASES in chip_smoke.py
# (case i is drawn with seed i by _edge_inputs): d = 13 (scalar loads), all
# ids -1, ids >= n (clipped), M not a multiple of a warp's 4 rows, B = 1,
# more row groups than warps
CARD_CASES = [
    dict(b=5, m=12, n=40, d=16), dict(b=5, m=12, n=40, d=13),
    dict(b=4, m=9, n=50, d=16, kind="invalid"),
    dict(b=3, m=13, n=30, d=24, kind="clip"),
    dict(b=1, m=32, n=100, d=128), dict(b=3, m=70, n=500, d=64)]


def _edge_inputs(b, m, n, d, kind="random", seed=0):
    """(ids, q, x) numpy arrays of a CARD_CASES entry, as chip_smoke.py's
    gather_edge_inputs draws them."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, n, size=(b, m)).astype(np.int32)
    if kind == "invalid":
        ids[:] = -1
    elif kind == "clip":
        ids[:, ::2] = rng.integers(n, n + 5, size=ids[:, ::2].shape)
    q = rng.normal(size=(b, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return ids, q, x


def _edge_id(ci):
    c = CARD_CASES[ci]
    return f"b{c['b']}-m{c['m']}-d{c['d']}-{c.get('kind', 'random')}"


def _inputs(seed, d=D):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, N + 3, size=(B, M)).astype(np.int32)  # -1 and >= n
    ids[0, :3] = -1
    q = rng.normal(size=(B, d)).astype(np.float32)
    x = rng.normal(size=(N, d)).astype(np.float32)
    return ids, q, x


@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_port_ref_matches_reference(metric, oracle):
    ids, q, x = _inputs(0)
    if oracle == "ref":
        want = jax_ref(jnp.asarray(ids), jnp.asarray(q), jnp.asarray(x),
                       metric)
    else:
        want = gather_distance_pallas(jnp.asarray(ids), jnp.asarray(q),
                                      jnp.asarray(x), metric, interpret=True)
    got = gather_distance_ref(torch.from_numpy(ids), torch.from_numpy(q),
                              torch.from_numpy(x), metric)
    want = np.asarray(want)
    assert np.array_equal(np.isinf(got.numpy()), ids < 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cpu_tensors_route_to_plain_version():
    ids, q, x = _inputs(1)
    t = [torch.from_numpy(a) for a in (ids, q, x)]
    before = gather_distance_cuda.launches
    assert torch.equal(gather_distance(*t, metric="l2"),
                       gather_distance_ref(*t, metric="l2"))
    assert gather_distance_cuda.launches == before


@pytest.mark.parametrize("ci", range(len(CARD_CASES)), ids=_edge_id)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_edge_cases_match_reference(metric, ci):
    ids, q, x = _edge_inputs(**CARD_CASES[ci], seed=ci)
    j = [jnp.asarray(a) for a in (ids, q, x)]
    got = gather_distance(*(torch.from_numpy(a) for a in (ids, q, x)),
                          metric=metric).numpy()
    assert np.array_equal(np.isinf(got), ids < 0)
    for want in (jax_ref(*j, metric),
                 gather_distance_pallas(*j, metric, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("ci", range(len(CARD_CASES)), ids=_edge_id)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_kernel_matches_plain_version(cuda_device, metric, ci):
    t = [torch.from_numpy(a).to(cuda_device)
         for a in _edge_inputs(**CARD_CASES[ci], seed=ci)]
    got = gather_distance_cuda(*t, metric=metric)
    want = gather_distance_ref(*t, metric=metric)
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
