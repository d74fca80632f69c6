"""The embedding_bag op in the PyTorch port against the JAX reference,
forward and gradient.

The port's op (plain version on CPU tensors) is held against the
reference's op, which runs its Pallas kernel in interpret mode with its
``custom_vjp`` backward (``_bag_bwd``), and the port's plain version
against the reference's oracle, on the same numpy inputs.  Outputs and
gradients agree within atol 1e-5 and rtol 1e-5, the reference's own
tolerance for this op (``tests/test_kernels.py:206,222``): the rows of a
bag are summed in another order.  Ids >= V are clipped to row V-1 and
count as valid (the reference's quirk, reproduced); a mode other than sum
and mean raises on both devices, where the reference's Pallas route
silently sums (not reproduced).  A bf16 or fp16 table gives an output of
its dtype, summed and divided in fp32 and rounded once; it is held to the
reference's oracle on the same 16-bit table within one unit in the last
place of the output dtype times the bag's sum of |rows| (the reference
sums in the table's dtype).  The CUDA kernel is held against the plain
version on the card (skipped without one).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.ops import embedding_bag as jax_op
from repro.kernels.embedding_bag.ref import (embedding_bag_ref as jax_ref,
                                             embedding_bag_segment_ref as
                                             jax_segment_ref)
from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_cuda,
                                               embedding_bag_ref,
                                               embedding_bag_segment_ref)
from repro_torch.kernels.embedding_bag.kernel import launch_shape
from torch_parity import (cuda_device,  # noqa: F401  (fixture)
                          load_chip_smoke)

TOL = dict(rtol=1e-5, atol=1e-5)
# 16-bit tables: the torch and jnp dtypes and one unit in the last place
HALF = {"bf16": (torch.bfloat16, jnp.bfloat16, 2.0 ** -7),
        "fp16": (torch.float16, jnp.float16, 2.0 ** -10)}


def _inputs(b, l, v, d, kind="random", seed=0):
    """(ids (b, l) int32, table (v, d) f32, upstream grad (b, d) f32)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, v, size=(b, l))
    if kind == "padding":                 # every bag empty
        ids = np.full((b, l), -1)
    elif kind == "clip":                  # ids >= V read row V-1, counted
        ids = rng.integers(-1, v + 5, size=(b, l))
        ids[0, :] = v + 2
    elif kind == "dup":                   # repeated ids inside a bag
        ids = rng.integers(0, 3, size=(b, l))
    elif kind == "empty_bag":             # one bag of all -1 among others
        ids[b // 2, :] = -1
    elif kind != "random":
        raise ValueError(kind)
    table = rng.normal(size=(v, d)).astype(np.float32)
    g = rng.normal(size=(b, d)).astype(np.float32)
    return ids.astype(np.int32), table, g


CASES = {
    # the reference's kernel-test shapes (b, l, v, d)
    "1x1v10d4": dict(b=1, l=1, v=10, d=4),
    "16x8v1000d32": dict(b=16, l=8, v=1000, d=32),
    "5x20v64d16": dict(b=5, l=20, v=64, d=16),
    "padding_3x4v10d8": dict(b=3, l=4, v=10, d=8, kind="padding"),
    "clip_6x5v9d8": dict(b=6, l=5, v=9, d=8, kind="clip"),
    "dup_4x6v20d8": dict(b=4, l=6, v=20, d=8, kind="dup"),
    "d13_7x5v30d13": dict(b=7, l=5, v=30, d=13),       # the scalar path
    # across the CUDA kernel's structure: more ids than a warp's 32 lanes
    # (100: a DIEN-length history), several column slices (one ragged),
    # one bag and a number of bags that fills no block, an empty bag among
    # full ones past one chunk of ids, ids >= V past one chunk
    "l33_4x33v50d8": dict(b=4, l=33, v=50, d=8),
    "l100_3x100v200d16": dict(b=3, l=100, v=200, d=16),
    "d1024_2x3v20d1024": dict(b=2, l=3, v=20, d=1024),
    "d1028_2x3v20d1028": dict(b=2, l=3, v=20, d=1028),
    "b1_1x4v30d256": dict(b=1, l=4, v=30, d=256),
    "b131_131x4v300d8": dict(b=131, l=4, v=300, d=8),
    "empty_bag_5x40v60d8": dict(b=5, l=40, v=60, d=8, kind="empty_bag"),
    "clip_3x33v9d8": dict(b=3, l=33, v=9, d=8, kind="clip"),
}


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_grad_match_reference(case, mode):
    ids, table, g = _inputs(**CASES[case], seed=len(case))
    ji, jt = jnp.asarray(ids), jnp.asarray(table)
    want = jax_op(ji, jt, mode, use_kernel=True, interpret=True)
    want_grad = jax.grad(lambda t: (jax_op(ji, t, mode, use_kernel=True,
                                           interpret=True) * g).sum())(jt)
    tt = torch.from_numpy(table).requires_grad_()
    got = embedding_bag(torch.from_numpy(ids), tt, mode)
    (grad,) = torch.autograd.grad(got, tt, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), **TOL)
    # the plain versions
    np.testing.assert_allclose(
        embedding_bag_ref(torch.from_numpy(ids), torch.from_numpy(table),
                          mode).numpy(),
        np.asarray(jax_ref(ji, jt, mode)), **TOL)


def _abs_sum(ids, table, mode):
    """Per bag and column, the sum of |rows| its valid ids read (over the
    count for mean): the scale of one rounding of the output."""
    rows = np.abs(table[np.clip(ids, 0, table.shape[0] - 1)]).astype(
        np.float64) * (ids >= 0)[..., None]
    s = rows.sum(axis=1)
    if mode == "mean":
        s = s / np.maximum((ids >= 0).sum(axis=1, keepdims=True), 1)
    return s


def _assert_within_ulp(got, want, ids, table, mode, ulp):
    gap = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (gap <= ulp * _abs_sum(ids, table, mode)).all(), gap.max()


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("half", sorted(HALF))
@pytest.mark.parametrize("case", sorted(CASES))
def test_16bit_table_matches_reference(case, half, mode):
    """A bf16 or fp16 table: the output has its dtype and is within one
    unit in the last place (times the bag's sum of |rows|) of the
    reference's oracle on the same table."""
    tdt, jdt, ulp = HALF[half]
    ids, table, _ = _inputs(**CASES[case], seed=len(case))
    t16 = torch.from_numpy(table).to(tdt)
    tw = t16.float().numpy()
    want = jax_ref(jnp.asarray(ids), jnp.asarray(tw).astype(jdt), mode)
    assert want.dtype == jdt
    got = embedding_bag(torch.from_numpy(ids), t16, mode)
    assert got.dtype == tdt
    _assert_within_ulp(got.float().numpy(),
                       np.asarray(want).astype(np.float32), ids, tw, mode,
                       ulp)
    # the plain version rounds once what it sums in fp32
    wide = embedding_bag_ref(torch.from_numpy(ids), t16.float(), mode)
    assert torch.equal(embedding_bag_ref(torch.from_numpy(ids), t16, mode),
                       wide.to(tdt))


def test_clip_quirk_reads_the_last_row_and_counts_it():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    ids = torch.tensor([[7, -1, 0], [-1, -1, -1]], dtype=torch.int32)
    mean = embedding_bag(ids, table, "mean")
    assert torch.equal(mean[0], (table[3] + table[0]) / 2)
    assert torch.equal(mean[1], torch.zeros(3))


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_segment_form_matches_reference(mode):
    ids, table, _ = _inputs(4, 6, 30, 8, kind="clip", seed=1)
    flat = ids.reshape(-1)
    seg = np.repeat(np.arange(4), 6).astype(np.int32)
    want = jax_segment_ref(jnp.asarray(flat), jnp.asarray(seg),
                           jnp.asarray(table), 5, mode)   # bag 4 is empty
    got = embedding_bag_segment_ref(torch.from_numpy(flat),
                                    torch.from_numpy(seg),
                                    torch.from_numpy(table), 5, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got[:4].numpy(),
        embedding_bag_ref(torch.from_numpy(ids), torch.from_numpy(table),
                          mode).numpy(), **TOL)


@pytest.mark.parametrize("fn", [embedding_bag, embedding_bag_ref,
                                embedding_bag_cuda],
                         ids=["op", "ref", "cuda"])
def test_invalid_mode_raises(fn):
    ids, table, _ = _inputs(2, 3, 5, 4)
    with pytest.raises(ValueError, match="max"):
        fn(torch.from_numpy(ids), torch.from_numpy(table), "max")


def test_cpu_tensors_route_to_plain_version():
    ids, table, _ = (torch.from_numpy(a) for a in _inputs(8, 4, 50, 16))
    before = embedding_bag_cuda.launches
    assert torch.equal(embedding_bag(ids, table, "mean"),
                       embedding_bag_ref(ids, table, "mean"))
    assert embedding_bag_cuda.launches == before


# the same as BAG_EDGE_CASES in chip_smoke.py, which runs them on the card
# (case i drawn with seed i): the edge cases above, then D = 256 (two
# column slices of one float4 each a lane), D = 260 and 600 (a ragged
# slice), empty bags (L = 0); then L = 33 and 100 (more than one chunk of
# 32 ids), D = 1,024 and 1,028 (slices of several passes, one ragged), one
# bag and 131 bags, an empty bag among full ones at L = 40, ids >= V at
# L = 33
CARD_CASES = [
    dict(b=16, l=8, v=1000, d=32), dict(b=3, l=4, v=10, d=8, kind="padding"),
    dict(b=6, l=5, v=9, d=8, kind="clip"),
    dict(b=4, l=6, v=20, d=8, kind="dup"), dict(b=7, l=5, v=30, d=13),
    dict(b=1000, l=4, v=5000, d=256), dict(b=33, l=9, v=70, d=260),
    dict(b=9, l=3, v=40, d=600), dict(b=5, l=0, v=10, d=8),
    dict(b=64, l=33, v=500, d=256), dict(b=32, l=100, v=5000, d=256),
    dict(b=16, l=4, v=100, d=1024), dict(b=16, l=5, v=100, d=1028),
    dict(b=1, l=4, v=100, d=256), dict(b=131, l=4, v=1000, d=256),
    dict(b=8, l=40, v=300, d=256, kind="empty_bag"),
    dict(b=8, l=33, v=40, d=256, kind="clip")]


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("ci", range(len(CARD_CASES)))
def test_cuda_kernel_matches_plain_version(cuda_device, ci, mode):
    ids, table, g = (torch.from_numpy(a).to(cuda_device)
                     for a in _inputs(**CARD_CASES[ci], seed=ci))
    tt = table.clone().requires_grad_()
    got = embedding_bag(ids, tt, mode)
    (grad,) = torch.autograd.grad(got, tt, g)
    torch.cuda.synchronize()
    want = embedding_bag_ref(ids.cpu(), table.cpu(), mode)
    tc = table.cpu().requires_grad_()
    (want_grad,) = torch.autograd.grad(
        embedding_bag(ids.cpu(), tc, mode), tc, g.cpu())
    np.testing.assert_allclose(got.detach().cpu().numpy(), want.numpy(),
                               **TOL)
    np.testing.assert_allclose(grad.cpu().numpy(), want_grad.numpy(), **TOL)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("half", sorted(HALF))
@pytest.mark.parametrize("ci", range(len(CARD_CASES)))
def test_cuda_kernel_16bit_matches_plain_version(cuda_device, ci, half,
                                                 mode):
    """The kernel on a bf16 or fp16 table against the plain version on the
    card: the output in the table's dtype, within one unit in its last
    place (times the bag's sum of |rows|; fp32 sums in another order)."""
    tdt, _, ulp = HALF[half]
    ids, table, _ = (torch.from_numpy(a).to(cuda_device)
                     for a in _inputs(**CARD_CASES[ci], seed=ci))
    t16 = table.to(tdt)
    got = embedding_bag_cuda(ids, t16, mode)
    want = embedding_bag_ref(ids, t16, mode)
    torch.cuda.synchronize()
    assert got.dtype == tdt
    _assert_within_ulp(got.float().cpu().numpy(), want.float().cpu().numpy(),
                       ids.cpu().numpy(), t16.float().cpu().numpy(), mode,
                       ulp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
def test_launch_shape_tiles_every_bag(dtype):
    """The kernel's launch shape: each bag's column slices tile [0, D)
    exactly (whole multiples of 8 columns, none empty, at most 4 warps),
    the blocks (1-8 warps each) cover every warp, and at the serve_p99
    bags (512 of D = 256) the grid has a block for each of the 132 SMs.
    The shape depends on the bags and D only, not on L."""
    for b in (1, 2, 7, 31, 131, 132, 512, 1000, 65_536, 3_000_000):
        for d in (1, 3, 4, 7, 8, 13, 31, 64, 100, 128, 255, 256, 260, 512,
                  600, 1024, 1028, 4097):
            w, sc, wb, blocks = launch_shape(b, d, dtype)
            assert 1 <= w <= 4 and sc % 8 == 0 and 1 <= wb <= 8
            cols = np.zeros(d, np.int64)
            for part in range(w):
                lo, hi = part * sc, min(d, (part + 1) * sc)
                assert lo < hi, (b, d, part)
                cols[lo:hi] += 1
            assert (cols == 1).all(), (b, d)
            assert (blocks - 1) * wb < b * w <= blocks * wb
    assert launch_shape(512, 256, dtype).blocks >= 132
    for bad in ((0, 8), (4, 0)):
        with pytest.raises(ValueError):
            launch_shape(*bad, dtype)


def test_cuda_kernel_refuses_other_dtypes(cuda_device):
    ids, table, _ = (torch.from_numpy(a).to(cuda_device)
                     for a in _inputs(2, 3, 5, 4))
    with pytest.raises(TypeError, match="int32"):
        embedding_bag(ids.long(), table)
    with pytest.raises(TypeError, match="float32"):
        embedding_bag(ids, table.double())


def test_chip_smoke_draws_the_card_cases():
    """chip_smoke.py holds the kernel to the plain version (fp32, and the
    16-bit copies within the same one unit in the last place) at the same
    cases as this file's card tests, drawn from the same seeds."""
    smoke = load_chip_smoke()
    assert smoke.BAG_EDGE_CASES == CARD_CASES
    assert smoke.HALF_ULP == {str(t).split(".")[-1]: ulp
                              for t, _, ulp in HALF.values()}
    for ci, case in enumerate(CARD_CASES):
        for got, want in zip(smoke.bag_inputs(**case, seed=ci),
                             _inputs(**case, seed=ci)):
            np.testing.assert_array_equal(got, want)
