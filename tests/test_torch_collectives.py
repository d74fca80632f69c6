"""The PyTorch port's cross-shard ``merge_topk`` against the JAX
reference's.

The seeded sweeps and hypothesis properties of
``tests/test_merge_topk_properties.py`` (shard-permutation invariance,
mirror idempotence, tie stability, degraded input, self idempotence), each
merge also held to the reference's ``merge_topk`` on the same input.
Tolerance: none — ids and distances bit-identical (distances compared as
their bits, so -0.0 / +0.0 and the -inf / inf padding count), including
ties at equal distance and rows with no valid candidate.  The mesh forms
(``gathered_topk_merge``, ``sharded_topk``) run on ``gloo`` ranks in
``test_torch_query_parallel.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:  # property tests degrade to skips when hypothesis is absent
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - exercised on minimal installs
    HAVE_HYPOTHESIS = False

from repro.distributed.collectives import merge_topk as ref_merge_topk
from repro_torch.distributed import merge_topk
from test_merge_topk_properties import (INVALID, make_shard_blocks,
                                        reference_merge)


def merge_both(ids, d, k):
    """The port's merge of (ids, d) numpy (B, C), held bit for bit to the
    reference's; returns the port's (ids, d) as numpy."""
    got_i, got_d = merge_topk(torch.as_tensor(ids), torch.as_tensor(d), k)
    want_i, want_d = ref_merge_topk(jnp.asarray(ids), jnp.asarray(d), k)
    got_i, got_d = got_i.numpy(), got_d.numpy()
    assert got_i.dtype == np.int32 and got_d.dtype == np.float32
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    np.testing.assert_array_equal(got_d.view(np.int32),
                                  np.asarray(want_d).view(np.int32))
    return got_i, got_d


def run_merge(blocks, k):
    ids = np.concatenate([b[0] for b in blocks])[None, :]
    d = np.concatenate([b[1] for b in blocks])[None, :]
    got_i, got_d = merge_both(ids, d, k)
    return got_i[0], got_d[0]


def check_all(blocks, k, seed):
    got_i, got_d = run_merge(blocks, k)
    ids = np.concatenate([b[0] for b in blocks])
    d = np.concatenate([b[1] for b in blocks])
    want_i, want_d = reference_merge(ids, d, k)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)
    assert ((got_i == INVALID) == ~np.isfinite(got_d)).all()
    # shard permutation, with columns scrambled inside each block
    rng = np.random.default_rng(seed)
    perm = [blocks[j] for j in rng.permutation(len(blocks))]
    perm = [(i[p], dd[p]) for (i, dd) in perm
            for p in [rng.permutation(len(i))]]
    for a, b in zip(run_merge(perm, k), (got_i, got_d)):
        np.testing.assert_array_equal(a, b)
    # mirror idempotence
    mirrored = list(blocks) + [blocks[seed % len(blocks)]]
    for a, b in zip(run_merge(mirrored, k), (got_i, got_d)):
        np.testing.assert_array_equal(a, b)
    # self idempotence
    again = merge_both(got_i[None], got_d[None], k)
    np.testing.assert_array_equal(again[0][0], got_i)
    np.testing.assert_array_equal(again[1][0], got_d)


@pytest.mark.parametrize("seed", range(10))
def test_merge_topk_sweep(seed):
    rng = np.random.default_rng(1000 + seed)
    n_shards = int(rng.integers(1, 6))
    k = int(rng.integers(1, 12))
    check_all(make_shard_blocks(seed, n_shards, k), k, seed)


def test_merge_topk_tie_break_is_global_id():
    d = np.asarray([[2.0, 1.0, 1.0, 1.0, 3.0, np.inf]], np.float32)
    ids = np.asarray([[7, 42, 3, 9, 1, -1]], np.int32)
    out_i, out_d = merge_both(ids, d, 4)
    np.testing.assert_array_equal(out_i, [[3, 9, 42, 7]])
    np.testing.assert_array_equal(out_d, [[1.0, 1.0, 1.0, 2.0]])


def test_merge_topk_duplicate_dispatch_does_not_crowd_out():
    shard_a = (np.asarray([10, 11], np.int32),
               np.asarray([1.0, 2.0], np.float32))
    shard_b = (np.asarray([20, 21], np.int32),
               np.asarray([1.5, 2.5], np.float32))
    base_i, _ = run_merge([shard_a, shard_b], 4)
    got_i, _ = run_merge([shard_a, shard_a, shard_b], 4)
    np.testing.assert_array_equal(got_i, base_i)
    np.testing.assert_array_equal(got_i, [10, 20, 11, 21])


def test_merge_topk_all_shards_empty_degrades():
    ids = np.full((3, 8), INVALID, np.int32)
    d = np.full((3, 8), np.inf, np.float32)
    out_i, out_d = merge_both(ids, d, 5)
    assert (out_i == INVALID).all() and np.isinf(out_d).all()


def test_merge_topk_keeps_distinct_distances_for_same_id():
    ids = np.asarray([[5, 5, 6]], np.int32)
    d = np.asarray([[1.0, 2.0, 3.0]], np.float32)
    out_i, out_d = merge_both(ids, d, 3)
    np.testing.assert_array_equal(out_i, [[5, 5, 6]])
    np.testing.assert_array_equal(out_d, [[1.0, 2.0, 3.0]])


def test_merge_topk_signed_zero_and_ties():
    """-0.0 and +0.0 are one distance: ties among them go by id, and a
    mirrored (id, -0.0) duplicates (id, +0.0)."""
    ids = np.asarray([[5, 4, 3, 2, 4, 9, -1],
                      [1, 1, 2, 2, 3, 3, -1]], np.int32)
    d = np.asarray([[0.0, -0.0, 0.0, -0.0, 0.0, 1.0, np.inf],
                    [-0.0, 0.0, 2.0, 2.0, 1.0, 1.0, np.inf]], np.float32)
    out_i, _ = merge_both(ids, d, 6)
    np.testing.assert_array_equal(out_i[0], [2, 3, 4, 5, 9, -1])
    np.testing.assert_array_equal(out_i[1], [1, 3, 2, -1, -1, -1])


@pytest.mark.parametrize("seed", range(4))
def test_merge_topk_random_rows(seed):
    """Several rows at once, duplicated ids and distances from a small pool
    (exact ties), k past the candidate count."""
    rng = np.random.default_rng(seed)
    b, c = 6, int(rng.integers(2, 40))
    ids = rng.integers(-1, 12, size=(b, c)).astype(np.int32)
    d = rng.choice(np.array([0.0, -0.0, 0.5, 1.0, 2.0], np.float32),
                   size=(b, c))
    d[ids < 0] = np.inf
    d[0] = np.inf
    ids[0] = -1                       # one all-invalid row
    for k in (1, c // 2 + 1, c + 3):
        merge_both(ids, d, k)


if HAVE_HYPOTHESIS:
    @settings(max_examples=40)
    @given(seed=st.integers(0, 10_000), n_shards=st.integers(1, 6),
           k=st.integers(1, 12), tie_prob=st.floats(0.0, 1.0),
           empty_prob=st.floats(0.0, 1.0))
    def test_merge_topk_property(seed, n_shards, k, tie_prob, empty_prob):
        check_all(make_shard_blocks(seed, n_shards, k, tie_prob,
                                    empty_prob), k, seed)

    @settings(max_examples=25)
    @given(seed=st.integers(0, 10_000), n_shards=st.integers(2, 5),
           k=st.integers(1, 8), mirrors=st.integers(1, 3))
    def test_merge_topk_repeated_mirrors_property(seed, n_shards, k, mirrors):
        blocks = make_shard_blocks(seed, n_shards, k)
        base_i, base_d = run_merge(blocks, k)
        rng = np.random.default_rng(seed)
        mirrored = list(blocks)
        for _ in range(mirrors):
            mirrored.append(blocks[int(rng.integers(0, n_shards))])
        got_i, got_d = run_merge(mirrored, k)
        np.testing.assert_array_equal(got_i, base_i)
        np.testing.assert_array_equal(got_d, base_d)
else:
    @pytest.mark.skip(reason="hypothesis not installed")
    def test_merge_topk_property():
        pytest.importorskip("hypothesis")

    @pytest.mark.skip(reason="hypothesis not installed")
    def test_merge_topk_repeated_mirrors_property():
        pytest.importorskip("hypothesis")
