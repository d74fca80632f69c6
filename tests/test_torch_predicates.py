"""The PyTorch port's tree-walk predicate evaluator against the JAX
reference.

``evaluate``, ``evaluate_batch``, ``selectivity`` and
``evaluate_predicates`` on an LCPS table and an HCPS table made by the
reference's generators and carried across with ``table_from_arrays``:
every leaf kind (Equals, OneOf, Between, ContainsAny, RegexMatch,
TruePredicate, empty operand tuples among them), And / Or / Not, and
seeded random trees.  Tolerance: none — masks must be bit-identical to the
reference's and to the port's compiled ``evaluate_program`` pass, and
selectivities equal as floats.
"""
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.data import make_hcps_dataset, make_lcps_dataset
from torch_parity import build, port_table, random_tree

N = 700

# (table, predicate description) pairs: every leaf kind and combinator
LCPS_CASES = [
    ("Equals", "label", 3), ("Equals", "label", 99),
    ("OneOf", "label", (1, 4, 7)), ("OneOf", "label", ()),
    ("Between", "label", 2, 5), ("Between", "label", 5, 2),
    ("TruePredicate",),
    ("And", (("Equals", "label", 1), ("OneOf", "label", (1, 2)))),
    ("Or", (("Equals", "label", 1), ("Between", "label", 8, 11),
            ("Equals", "label", 0))),
    ("Not", ("Between", "label", 0, 5)),
]
HCPS_CASES = [
    ("Equals", "date", 17), ("OneOf", "date", (3, 50, 119)),
    ("Between", "date", 10, 40),
    ("ContainsAny", "keywords", (3, 7)), ("ContainsAny", "keywords", ()),
    ("ContainsAny", "keywords", tuple(range(30))),
    ("RegexMatch", "caption", r"\bgreen\b"),
    ("RegexMatch", "caption", r"^photo of (red|blue)"),
    ("RegexMatch", "caption", r"no such word"),
    ("TruePredicate",),
    ("And", (("ContainsAny", "keywords", (5,)), ("Between", "date", 0, 60))),
    ("Or", (("RegexMatch", "caption", r"\bcity\b"),
            ("Not", ("ContainsAny", "keywords", (1, 2))))),
    ("Not", ("And", (("TruePredicate",), ("Equals", "date", 5)))),
]


@pytest.fixture(scope="module")
def tables():
    lcps = make_lcps_dataset(n=N, d=8, card=12, seed=2).table
    hcps = make_hcps_dataset(n=N, d=8, seed=3).table
    return {"lcps": (lcps, port_table(lcps)),
            "hcps": (hcps, port_table(hcps))}


def _cases():
    return ([("lcps", c) for c in LCPS_CASES]
            + [("hcps", c) for c in HCPS_CASES])


@pytest.mark.parametrize("which,desc", _cases(),
                         ids=lambda v: v if isinstance(v, str) else repr(v))
def test_evaluate_leaf_and_combinator(tables, which, desc):
    jt, tt = tables[which]
    want = np.asarray(J.evaluate(build(J, desc), jt))
    got = T.evaluate(build(T, desc), tt)
    assert got.dtype == torch.bool and got.device == tt.device
    assert got.shape == (N,)
    assert np.array_equal(got.numpy(), want)
    assert (T.selectivity(build(T, desc), tt)
            == J.selectivity(build(J, desc), jt))


@pytest.mark.parametrize("which", ["lcps", "hcps"])
def test_batch_forms_bit_identical(tables, which):
    """evaluate_batch, evaluate_predicates and the compiled program all
    give the reference's (B, n) masks."""
    jt, tt = tables[which]
    descs = LCPS_CASES if which == "lcps" else HCPS_CASES
    want = np.asarray(J.evaluate_batch([build(J, d) for d in descs], jt))
    tpreds = [build(T, d) for d in descs]
    batch = T.evaluate_batch(tpreds, tt)
    fused = T.evaluate_predicates(tpreds, tt)
    prog = T.compile_predicates(tpreds, tt)
    cols = T.pack_columns(tt, prog.schema)
    program = T.evaluate_program(prog, cols.ints, cols.bitsets,
                                 T.regex_aux(tt, prog.regex_leaves))
    for got in (batch, fused, program):
        assert got.dtype == torch.bool
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        fused.numpy(),
        np.asarray(J.evaluate_predicates([build(J, d) for d in descs], jt)))


@pytest.mark.parametrize("seed", range(4))
def test_random_trees_bit_identical(tables, seed):
    jt, tt = tables["hcps"]
    rng = np.random.default_rng(200 + seed)
    descs = [random_tree(rng) for _ in range(16)]
    want = np.asarray(J.evaluate_batch([build(J, d) for d in descs], jt))
    tpreds = [build(T, d) for d in descs]
    assert np.array_equal(T.evaluate_batch(tpreds, tt).numpy(), want)
    assert np.array_equal(T.evaluate_predicates(tpreds, tt).numpy(), want)
    for d, p in zip(descs, tpreds):
        assert T.selectivity(p, tt) == J.selectivity(build(J, d), jt)


def test_regex_leaf_is_cached_per_table(tables):
    _, tt = tables["hcps"]
    pred = T.RegexMatch("caption", r"\bocean\b")
    first = T.evaluate(pred, tt)
    mask = tt._plan_cache["regex"][("caption", r"\bocean\b")]
    assert isinstance(mask, np.ndarray) and np.array_equal(mask,
                                                           first.numpy())
    assert torch.equal(T.evaluate(pred, tt), first)


def test_unknown_predicate_raises(tables):
    _, tt = tables["lcps"]
    with pytest.raises(TypeError, match="unknown predicate"):
        T.evaluate(T.Predicate(), tt)
