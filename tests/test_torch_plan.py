"""The PyTorch port's predicate compiler and evaluator against the JAX
reference.

Seeded random predicate trees (nested And/Or/Not over Equals, OneOf,
Between, ContainsAny, RegexMatch, TruePredicate, with empty operand
tuples) over an HCPS-like table made by the reference's generator and
carried across with ``table_from_arrays``: the compiled program arrays,
the pass-masks and the selectivity-sketch estimates must be bit-identical
to the reference's.
"""
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.data import make_hcps_dataset
from torch_parity import build, port_table, random_tree

N = 700


@pytest.fixture(scope="module")
def tables():
    ds = make_hcps_dataset(n=N, d=8, seed=3)
    jt = ds.table
    return jt, port_table(jt)


@pytest.mark.parametrize("seed", range(6))
def test_masks_bit_identical(tables, seed):
    jt, tt = tables
    rng = np.random.default_rng(seed)
    descs = [random_tree(rng) for _ in range(24)]
    jprog = J.compile_predicates([build(J, d) for d in descs], jt)
    tprog = T.compile_predicates([build(T, d) for d in descs], tt)
    for name in ("ops", "slot", "lo", "hi", "vals", "nval", "qbits"):
        assert np.array_equal(getattr(tprog, name),
                              np.asarray(getattr(jprog, name))), name
    assert tprog.shape_sig == jprog.shape_sig
    assert tprog.regex_leaves == jprog.regex_leaves
    want = np.asarray(jprog.evaluate(jt))
    got = tprog.evaluate(tt)
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)
    # a row subset evaluates the same rows
    idx = np.array([3, 0, 5, 5])
    assert np.array_equal(tprog.take(idx).evaluate(tt).numpy(), want[idx])


@pytest.mark.parametrize("seed", range(3))
def test_sketch_estimates_bit_identical(tables, seed):
    jt, tt = tables
    rng = np.random.default_rng(100 + seed)
    descs = [random_tree(rng) for _ in range(16)]
    js = J.SelectivitySketch.build(jt, sample_size=256, seed=seed)
    ts = T.SelectivitySketch.build(tt, sample_size=256, seed=seed)
    want = js.estimate_batch([build(J, d) for d in descs])
    got = ts.estimate_batch([build(T, d) for d in descs])
    assert got.dtype == np.float64
    assert np.array_equal(got, want)


def test_n_valid_guard_and_concat(tables):
    jt, tt = tables
    preds = [T.TruePredicate(), T.Between("date", 0, 119)]
    prog = T.compile_predicates(preds, tt)
    cols = T.pack_columns(tt, prog.schema)
    aux = T.regex_aux(tt, prog.regex_leaves)
    out = T.evaluate_program(prog, cols.ints, cols.bitsets, aux, n_valid=100)
    assert bool(out[:, :100].all()) and not bool(out[:, 100:].any())
    both = T.PredicateProgram.concat([prog, prog])
    assert both.n_queries == 4
    assert T.admission_key(prog, 10, 64, None) == T.admission_key(
        both, 10, 64, None)
