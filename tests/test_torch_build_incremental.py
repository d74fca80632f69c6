"""The PyTorch port's incremental (sequential-insert) builder against the
JAX reference.

For hnsw, acorn-1 and acorn-gamma at n = 300, d = 16, M = 8 (γ = 6) with
the reference's levels: neighbour lists, ``pos``, ``node_ids``, entry
point and levels identical to ``repro.core.build_incremental``'s.  Should
they differ, every insert is replayed from the reference's state in both
packages, and each insert that diverges must be explained by a near tie
(``torch_parity.insert_near_tie``).  On integer data, where distances are
exact in both packages and tie often, the graphs must be identical: that
pins the stable beam sort and the first-argmin / first-argmax choices.
For hnsw and acorn-1 the incremental graph's recall@10 at ef 64 is
within 0.02 of the bulk builder's at the same parameters, as the
reference's docstring has it.  acorn-gamma is not held to that: its
incremental lists are the M·γ nearest of the beam, sorted, and the
search's 'filter' lookup reads their first M, so at n = 300 it reaches
0.90 against the bulk graph's 1.0, with the reference's graph itself
(the two graphs are identical, above).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_incremental as jinc
from repro.data import make_lcps_dataset
from repro_torch.core import (ann_search, build_bulk, hybrid_search,
                              masked_topk, recall_at_k)
from repro_torch.core.build_incremental import (IncrementalState,
                                                build_incremental, insert,
                                                variant_params)
from torch_parity import insert_near_tie, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

N, D, M, GAMMA, SEED = 300, 16, 8, 6, 0
VARIANTS = {"hnsw": {}, "acorn-1": {}, "acorn-gamma": dict(gamma=GAMMA)}


@pytest.fixture(scope="module")
def x():
    return np.asarray(make_lcps_dataset(n=N, d=D, card=8, seed=SEED).x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _replay_divergences(x, levels, variant, kw, efc=40):
    """Insert by insert from the reference's state in both packages; the
    count of inserts whose results differ, each explained by a near tie."""
    n, n_levels = len(x), int(levels.max()) + 1
    caps, ef_b = variant_params(variant, M, kw.get("gamma", 1), efc,
                                n_levels)
    js = jinc.IncrementalState(
        neighbors=tuple(jnp.full((n, c), -1, jnp.int32) for c in caps),
        counts=tuple(jnp.zeros((n,), jnp.int32) for _ in caps),
        entry=jnp.asarray(0, jnp.int32),
        entry_level=jnp.asarray(int(levels[0]), jnp.int32))
    xj, xt = jnp.asarray(x), _t(x)
    spare = [np.full((1, c), -1, np.int32) for c in caps]
    diverged = 0
    for v in range(n):
        pre = [np.asarray(a) for a in js.neighbors]
        ts = IncrementalState(
            tuple(_t(np.vstack([a, s])) for a, s in zip(pre, spare)),
            tuple(_t(np.append(np.asarray(c), 0)) for c in js.counts),
            int(js.entry), int(js.entry_level))
        js = jinc._insert(js, xj, jnp.asarray(v, jnp.int32),
                          jnp.asarray(int(levels[v]), jnp.int32), n_levels,
                          caps, M, ef_b, caps)
        ts = insert(ts, xt, v, int(levels[v]), caps, M, ef_b)
        a = [t[:n].numpy() for t in ts.neighbors]
        b = [np.asarray(t) for t in js.neighbors]
        same = (ts.entry == int(js.entry) and all(
            np.array_equal(p, q) for p, q in zip(a, b)) and all(
            np.array_equal(t[:n].numpy(), np.asarray(c))
            for t, c in zip(ts.counts, js.counts)))
        if not same:
            diverged += 1
            assert insert_near_tie(x, v, pre, a, b), (variant, v)
    return diverged


def _assert_same_graph(tg, jg):
    assert tg.num_levels == jg.num_levels
    assert int(tg.entry_point) == int(jg.entry_point)
    assert np.array_equal(tg.levels.numpy(), np.asarray(jg.levels))
    for lvl in range(jg.num_levels):
        for f in ("neighbors", "pos", "node_ids"):
            assert np.array_equal(getattr(tg, f)[lvl].numpy(),
                                  np.asarray(getattr(jg, f)[lvl])), (f, lvl)


def _same_graph(tg, jg):
    try:
        _assert_same_graph(tg, jg)
    except AssertionError:
        return False
    return True


@pytest.fixture(scope="module")
def builds(x):
    out = {}
    for variant, kw in VARIANTS.items():
        jg, _ = jinc.build_incremental(x, jax.random.PRNGKey(SEED), M,
                                       variant=variant, **kw)
        levels = np.asarray(jg.levels)
        tg, secs = build_incremental(_t(x), None, M, variant=variant,
                                     levels=levels, **kw)
        out[variant] = (jg, tg, levels, secs)
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_build_incremental_matches_reference(x, builds, variant):
    jg, tg, levels, secs = builds[variant]
    assert secs > 0
    if not _same_graph(tg, jg):
        # the graphs must still agree on their shapes; any divergence is
        # an insert that a near tie explains
        assert tg.num_levels == jg.num_levels
        assert _replay_divergences(x, levels, variant,
                                   VARIANTS[variant]) > 0


@pytest.mark.parametrize("variant", ["hnsw", "acorn-1"])
def test_incremental_recall_near_bulk(x, builds, variant):
    """The reference's docstring: the two builders' recall agrees."""
    _, tg, levels, _ = builds[variant]
    bulk = build_bulk(_t(x), None, M, variant=variant, levels=levels)
    rng = np.random.default_rng(1)
    xq = _t(x[rng.integers(0, N, 64)] + 0.1 * rng.normal(size=(64, D))
            .astype(np.float32))
    gt, _ = masked_topk(xq, _t(x), None, 10)

    def recall(g):
        if variant == "hnsw":
            ids = ann_search(g, _t(x), xq, k=10, ef=64, m=M)[0]
        else:
            ids = hybrid_search(g, _t(x), xq, None, k=10, ef=64,
                                variant=variant, m=M, m_beta=M)[0]
        return recall_at_k(ids, gt)

    r_inc, r_bulk = recall(tg), recall(bulk)
    assert r_inc >= r_bulk - 0.02, (r_inc, r_bulk)


def _grid():
    """8 x 8 integer grid points plus 16 duplicates, shuffled, d = 4:
    distances are exact in both packages and tie throughout."""
    g = np.stack(np.meshgrid(np.arange(8), np.arange(8)), -1).reshape(-1, 2)
    pts = np.concatenate([g, g[:16]]).astype(np.float32)
    pts = pts[np.random.default_rng(0).permutation(len(pts))]
    return np.concatenate([pts, np.zeros_like(pts)], axis=1)


@pytest.mark.parametrize("variant,kw", [("hnsw", dict(efc=8)),
                                        ("acorn-1", dict(efc=8)),
                                        ("acorn-gamma",
                                         dict(gamma=3, efc=8))])
def test_equal_distances_fall_as_in_reference(variant, kw):
    x = _grid()
    jg, _ = jinc.build_incremental(x, jax.random.PRNGKey(3), 4,
                                   variant=variant, **kw)
    tg, _ = build_incremental(_t(x), None, 4, variant=variant,
                              levels=np.asarray(jg.levels), **kw)
    _assert_same_graph(tg, jg)


def test_cap_above_beam_width_pads_with_invalid(x):
    """efc < 2M: the reference raises a shape error; the port's lists
    take the beam's entries, -1 padded, and stay valid."""
    with pytest.raises(ValueError):
        jinc.build_incremental(x[:40], jax.random.PRNGKey(0), 4,
                               variant="hnsw", efc=6)
    g, _ = build_incremental(_t(x[:120]), torch.Generator().manual_seed(0),
                             4, variant="hnsw", efc=6)
    for nb, ids in zip(g.neighbors, g.node_ids):
        nb = nb.numpy()
        assert ((nb >= -1) & (nb < 120)).all()
        for row, v in zip(nb, ids.numpy()):
            if v == 0:
                # the first insert links to itself twice, as the
                # reference's does
                assert list(row[:2]) == [0, 0]
                row = row[1:]
            assert len(np.unique(row[row >= 0])) == (row >= 0).sum()
    # every node but the first has a forward edge at level 0
    assert ((g.neighbors[0].numpy() >= 0).sum(axis=1)[1:] >= 1).all()
