"""gather_distance in the PyTorch port against the JAX reference.

The port's plain version is held against the reference's jnp oracle and
its Pallas kernel (interpret mode) on the same numpy inputs, for l2 and
ip, with -1 padding and out-of-range ids (clipped into [0, n-1] before
the row load).  Tolerance rtol 1e-5 / atol 1e-5: the fp32 sums run in
different orders.  The CUDA kernel is held against the plain version on
the card (skipped without one).
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


@pytest.mark.parametrize("d", [D, 13])   # d % 4 != 0 takes the scalar loads
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_kernel_matches_plain_version(cuda_device, metric, d):
    ids, q, x = _inputs(2, d)
    t = [torch.from_numpy(a).to(cuda_device) for a in (ids, q, x)]
    got = gather_distance_cuda(*t, metric=metric)
    want = gather_distance_ref(*t, metric=metric)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
