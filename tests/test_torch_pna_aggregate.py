"""pna_aggregate in the PyTorch port against the JAX reference.

The port's op (plain version on CPU tensors) is held against the
reference's op, which runs its Pallas kernel in interpret mode, and the
port's plain version against the reference's oracle, on the same numpy
inputs.  Tolerances, block by block of ``[mean | max | min | std]``:

* max and min are exact (each is one of the inputs, or 0);
* mean within rtol 1e-5 and atol 1e-6: the sums run in other orders, and
  a mean that cancels to near zero needs the small absolute floor;
* std within atol 2e-3, the reference's own tolerance for this block
  (``tests/test_kernels.py:246-247``): ``ssq / cnt - mean^2`` cancels, so
  for a node of degree 1, or whose neighbours carry nearly equal values,
  the error of the variance is ~eps |h|^2 and that of its square root up
  to ~sqrt(eps) |h|.

The CUDA kernel is held against the plain version on the card (skipped
without one) at the same tolerances.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pna_aggregate.ops import pna_aggregate as jax_op
from repro.kernels.pna_aggregate.ref import (pna_aggregate_ref as jax_ref,
                                             pna_aggregate_segment_ref as
                                             jax_segment_ref)
from repro_torch.kernels.pna_aggregate import (pna_aggregate,
                                               pna_aggregate_cuda,
                                               pna_aggregate_ref,
                                               pna_aggregate_segment,
                                               pna_aggregate_segment_ref)
from torch_parity import cuda_device, molecule_graphs  # noqa: F401


# a weighted case's adjacency values: the kernel's function holds for any
# finite weight, negative ones (which count in the sums but not in max or
# min) and zero sums included
WEIGHTS = (0, 0, 0, 0.5, 1, 2, -1)


def _inputs(b, n, f, kind="random", seed=0):
    """(adj, feats) float32 numpy of one case."""
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
        adj = rng.choice(np.array(WEIGHTS, np.float32), size=(b, n, n))
    else:
        raise ValueError(kind)
    return adj, feats


def assert_blocks_close(got, want, f):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    blk = [slice(k * f, (k + 1) * f) for k in range(4)]
    np.testing.assert_allclose(got[..., blk[0]], want[..., blk[0]],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[..., blk[1]], want[..., blk[1]])
    np.testing.assert_array_equal(got[..., blk[2]], want[..., blk[2]])
    np.testing.assert_allclose(got[..., blk[3]], want[..., blk[3]],
                               atol=2e-3)


CASES = {
    # the shapes of the reference's kernel tests, and the path's width
    "1x8x4": dict(b=1, n=8, f=4),
    "4x30x11": dict(b=4, n=30, f=11),
    "2x30x75": dict(b=2, n=30, f=75),
    "2x64x75": dict(b=2, n=64, f=75),
    "zero_2x9x5": dict(b=2, n=9, f=5, kind="zero"),
    "full_2x10x6": dict(b=2, n=10, f=6, kind="full"),
    "molecule_3x30x16": dict(b=3, n=30, f=16, kind="molecule"),
    "constant_2x12x7": dict(b=2, n=12, f=7, kind="constant"),
    "n1_3x1x5": dict(b=3, n=1, f=5),
    "weighted_3x30x75": dict(b=3, n=30, f=75, kind="weighted"),
    "weighted_2x12x7": dict(b=2, n=12, f=7, kind="weighted"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_reference(case):
    kw = CASES[case]
    adj, feats = _inputs(**kw, seed=len(case))
    ja, jf = jnp.asarray(adj), jnp.asarray(feats)
    ta, tf = torch.from_numpy(adj), torch.from_numpy(feats)
    # the op: the Pallas kernel in interpret mode
    assert_blocks_close(pna_aggregate(ta, tf),
                        jax_op(ja, jf, use_kernel=True, interpret=True),
                        kw["f"])
    # the plain versions
    assert_blocks_close(pna_aggregate_ref(ta, tf), jax_ref(ja, jf), kw["f"])


def test_isolated_nodes_give_zeros_and_the_std_floor():
    adj, feats = _inputs(2, 6, 3, kind="zero")
    out = pna_aggregate(torch.from_numpy(adj), torch.from_numpy(feats))
    assert torch.equal(out[..., :9], torch.zeros(2, 6, 9))
    assert torch.equal(out[..., 9:], torch.full((2, 6, 3), 1e-6))


@pytest.mark.parametrize("n,e,f", [(12, 40, 5), (30, 64, 75), (7, 0, 3)])
def test_segment_form_matches_reference(n, e, f):
    rng = np.random.default_rng(n + e)
    msgs = rng.normal(size=(e, f)).astype(np.float32)
    dst = rng.integers(0, n - 2, size=e).astype(np.int32)  # last 2 empty
    want = jax_segment_ref(jnp.asarray(msgs), jnp.asarray(dst), n)
    got = pna_aggregate_segment(torch.from_numpy(msgs),
                                torch.from_numpy(dst), n)
    assert pna_aggregate_segment is pna_aggregate_segment_ref
    assert_blocks_close(got, want, f)


def test_segment_form_matches_dense_form():
    adj, feats = _inputs(1, 12, 5, kind="molecule", seed=3)
    dst, src = np.nonzero(adj[0])    # row = destination, column = source
    dense = pna_aggregate_ref(torch.from_numpy(adj),
                              torch.from_numpy(feats))[0]
    seg = pna_aggregate_segment_ref(torch.from_numpy(feats[0][src]),
                                    torch.from_numpy(dst), 12)
    assert_blocks_close(seg, dense, 5)


def test_cpu_tensors_route_to_plain_version():
    adj, feats = (torch.from_numpy(a) for a in _inputs(2, 30, 11))
    before = pna_aggregate_cuda.launches
    assert torch.equal(pna_aggregate(adj, feats),
                       pna_aggregate_ref(adj, feats))
    assert pna_aggregate_cuda.launches == before


# the same as PNA_EDGE_CASES in chip_smoke.py, which runs them on the card
# (case i drawn with seed i): the edge cases above, plus N = 33 and N = 128,
# which cross a 32-source tile, F = 40, weighted adjacencies (one over
# several source tiles), N = 31 (every graph's adjacency and features start
# at another alignment), 5,000 graphs of N = 3 (more than the persistent
# grid holds at once), F = 1, F = 300 (split into feature blocks) and
# N = 600 (past a whole graph in shared memory)
CARD_CASES = [
    dict(b=1, n=8, f=4), dict(b=2, n=30, f=75),
    dict(b=2, n=9, f=5, kind="zero"), dict(b=2, n=10, f=6, kind="full"),
    dict(b=3, n=30, f=16, kind="molecule"),
    dict(b=2, n=12, f=7, kind="constant"), dict(b=3, n=1, f=5),
    dict(b=3, n=33, f=75), dict(b=2, n=128, f=75, kind="molecule"),
    dict(b=2, n=128, f=40), dict(b=3, n=30, f=75, kind="weighted"),
    dict(b=2, n=100, f=24, kind="weighted"), dict(b=4, n=31, f=75),
    dict(b=5000, n=3, f=4), dict(b=4, n=30, f=1), dict(b=3, n=30, f=300),
    dict(b=2, n=600, f=75)]


def _chip_smoke():
    """chip_smoke.py, loaded from the repo root (it imports no torch or
    JAX at module level)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("ci", range(len(CARD_CASES)))
def test_chip_smoke_draws_the_card_cases(ci):
    """chip_smoke.py holds the kernel to the plain version at the same
    cases, drawn from the same seeds, as this file."""
    smoke = _chip_smoke()
    assert smoke.PNA_EDGE_CASES[ci] == CARD_CASES[ci]
    assert len(smoke.PNA_EDGE_CASES) == len(CARD_CASES)
    for got, want in zip(smoke.pna_inputs(**CARD_CASES[ci], seed=ci),
                         _inputs(**CARD_CASES[ci], seed=ci)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ci", range(len(CARD_CASES)))
def test_plain_version_matches_reference_at_card_cases(ci):
    kw = CARD_CASES[ci]
    adj, feats = _inputs(**kw, seed=ci)
    assert_blocks_close(
        pna_aggregate_ref(torch.from_numpy(adj), torch.from_numpy(feats)),
        jax_ref(jnp.asarray(adj), jnp.asarray(feats)), kw["f"])


@pytest.mark.parametrize("ci", range(len(CARD_CASES)))
def test_cuda_kernel_matches_plain_version(cuda_device, ci):
    kw = CARD_CASES[ci]
    adj, feats = (torch.from_numpy(a).to(cuda_device)
                  for a in _inputs(**kw, seed=ci))
    got = pna_aggregate_cuda(adj, feats)
    want = pna_aggregate_ref(adj, feats)
    torch.cuda.synchronize()
    assert_blocks_close(got.cpu(), want.cpu(), kw["f"])


def test_cuda_kernel_refuses_autograd(cuda_device):
    adj, feats = (torch.from_numpy(a).to(cuda_device)
                  for a in _inputs(1, 8, 4))
    with pytest.raises(NotImplementedError, match="use_kernel=False"):
        pna_aggregate(adj, feats.requires_grad_())
