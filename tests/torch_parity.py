"""Shared helpers of the PyTorch port's parity tests (``test_torch_*.py``).

The reference's state crosses over as numpy (``repro_torch.convert``), the
tests compare on the CPU, and a test that needs the card asks for the
``cuda_device`` fixture, which skips when no GPU is present (decided at
run time, never at import time).
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import (graph_from_arrays, pna_params_from_arrays,
                                 table_from_arrays)

# caption words of the random trees' regex leaves
KW_WORDS = ["animal", "green", "blue", "city", "ocean"]

# relative width of a near tie in distance: two ids whose distances to the
# query agree this closely may swap places between the packages (their
# fp32 sums run in different orders)
NEAR_TIE_REL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def one_thread():
    """One intra-op torch thread for a module of many small CPU ops: they
    run no faster on more, and the test workers share the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def port_graph(g, device="cpu"):
    """The port's graph from a reference ``LayeredGraph``."""
    return graph_from_arrays(
        [np.asarray(a) for a in g.neighbors], [np.asarray(a) for a in g.pos],
        [np.asarray(a) for a in g.node_ids], np.asarray(g.entry_point),
        np.asarray(g.levels), device=device)


def port_table(t, device="cpu"):
    """The port's table from a reference ``AttributeTable``."""
    return table_from_arrays(
        {k: np.asarray(v) for k, v in t.int_cols.items()},
        {k: np.asarray(v) for k, v in t.bitset_cols.items()},
        dict(t.str_cols), dict(t.n_keywords), device=device)


def port_pna(params, cfg, device="cpu"):
    """The port's ``PNA`` from a reference ``init_pna`` parameter tree."""
    tree = {"enc": np.asarray(params["enc"]), "dec": np.asarray(params["dec"]),
            "layers": [{k: np.asarray(v) for k, v in lp.items()}
                       for lp in params["layers"]]}
    return pna_params_from_arrays(tree, cfg, device=device)


def molecule_graphs(b, n, d_in, seed, min_nodes=None, undirected_edges=32):
    """(adj (b, n, n), feats (b, n, d_in)) float32 numpy: molecule-like
    graphs padded to n nodes.  Each has between ``min_nodes`` (n // 3) and
    n real nodes joined by a random spanning tree plus random ring
    closures up to ``undirected_edges`` edges, symmetric, no self-loops;
    real nodes get normal features, padding nodes zeros and no edges."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((b, n, n), np.float32)
    feats = np.zeros((b, n, d_in), np.float32)
    lo = max(1, n // 3 if min_nodes is None else min_nodes)
    for g in range(b):
        k = int(rng.integers(lo, n + 1))
        for v in range(1, k):
            u = int(rng.integers(0, v))
            adj[g, u, v] = adj[g, v, u] = 1.0
        iu, ju = np.triu_indices(k, 1)
        free = np.nonzero(adj[g, iu, ju] == 0)[0]
        extra = min(len(free), max(0, undirected_edges - (k - 1)))
        pick = rng.choice(free, size=extra, replace=False)
        adj[g, iu[pick], ju[pick]] = adj[g, ju[pick], iu[pick]] = 1.0
        feats[g, :k] = rng.normal(size=(k, d_in))
    return adj, feats


def assert_ids_match(ids_port, ids_ref, d_port, d_ref, x, xq, metric="l2",
                     expanded=False):
    """Ids identical to the reference's, except where a differing slot is a
    near tie (the two ids' float64 distances to the query agree within
    ``NEAR_TIE_REL``); distances within rtol 1e-5 where ids agree.

    ``expanded=True`` marks distances of the exact route's expanded form
    ``|q|^2 + |x|^2 - 2 q.x``: its fp32 terms are as large as
    ``|q|^2 + |x|^2`` and cancel, so the absolute tolerance is 1e-6 of
    that scale per query.  Returns the near ties found, as
    (query, slot, port id, ref id)."""
    ids_port, ids_ref = np.asarray(ids_port), np.asarray(ids_ref)
    d_port, d_ref = np.asarray(d_port), np.asarray(d_ref)
    x, xq = np.asarray(x, np.float64), np.asarray(xq, np.float64)
    assert ids_port.shape == ids_ref.shape
    ties = []
    for qi, j in zip(*np.nonzero(ids_port != ids_ref)):
        a, b = int(ids_port[qi, j]), int(ids_ref[qi, j])
        assert a >= 0 and b >= 0, (
            f"query {qi} slot {j}: port id {a} vs reference id {b}")
        if metric == "l2":
            da = float(((x[a] - xq[qi]) ** 2).sum())
            db = float(((x[b] - xq[qi]) ** 2).sum())
        else:
            da, db = -float(x[a] @ xq[qi]), -float(x[b] @ xq[qi])
        assert abs(da - db) <= NEAR_TIE_REL * max(abs(da), abs(db)), (
            f"query {qi} slot {j}: port id {a} (d={da}) vs reference id {b} "
            f"(d={db}) is not a near tie")
        ties.append((int(qi), int(j), a, b))
    same = (ids_port == ids_ref) & np.isfinite(d_ref)
    atol = np.full(d_ref.shape, 1e-6)
    if expanded:
        scale = (xq ** 2).sum(axis=1) + (x ** 2).sum(axis=1).max()
        atol = np.broadcast_to(1e-6 * scale[:, None], d_ref.shape)
    np.testing.assert_array_less(np.abs(d_port[same] - d_ref[same]),
                                 (atol + 1e-5 * np.abs(d_ref))[same] + 1e-30)
    assert np.array_equal(np.isfinite(d_port), np.isfinite(d_ref))
    return ties


def port_engine(engine, torch_acorn, torch_cfg, seed=0, device="cpu"):
    """The port's ``ServingEngine`` over a reference engine's shards (its
    graphs, vectors and tables, as numpy)."""
    from repro_torch.convert import engine_from_arrays

    def graph(g):
        return dict(neighbors=[np.asarray(a) for a in g.neighbors],
                    pos=[np.asarray(a) for a in g.pos],
                    node_ids=[np.asarray(a) for a in g.node_ids],
                    entry_point=np.asarray(g.entry_point),
                    levels=np.asarray(g.levels))

    def table(t):
        return dict(int_cols={k: np.asarray(v) for k, v in t.int_cols.items()},
                    bitset_cols={k: np.asarray(v)
                                 for k, v in t.bitset_cols.items()},
                    str_cols=dict(t.str_cols), n_keywords=dict(t.n_keywords))

    return engine_from_arrays(
        [dict(graph=graph(s.index.graph), x=np.asarray(s.index.x),
              table=table(s.index.table))
         for s in engine.shards], torch_acorn, torch_cfg, seed=seed,
        device=device)


def random_tree(rng, depth=0):
    """A random predicate tree as a neutral description (kind, args)."""
    leaves = [
        lambda: ("Equals", "date", int(rng.integers(0, 120))),
        lambda: ("OneOf", "date", tuple(int(v) for v in rng.choice(
            120, size=rng.integers(0, 6), replace=False))),
        lambda: ("Between", "date", int(rng.integers(0, 60)),
                 int(rng.integers(40, 120))),
        lambda: ("ContainsAny", "keywords", tuple(int(v) for v in rng.choice(
            30, size=rng.integers(0, 4), replace=False))),
        lambda: ("RegexMatch", "caption",
                 rf"\b{rng.choice(KW_WORDS)}\b"),
        lambda: ("TruePredicate",),
    ]
    if depth >= 3 or rng.random() < 0.4:
        return leaves[int(rng.integers(0, len(leaves)))]()
    kind = int(rng.integers(0, 3))
    if kind == 2:
        return ("Not", random_tree(rng, depth + 1))
    parts = tuple(random_tree(rng, depth + 1)
                  for _ in range(int(rng.integers(1, 4))))
    return ("And" if kind == 0 else "Or", parts)


def build(mod, desc):
    """Instantiate a tree description with one package's classes."""
    kind = desc[0]
    if kind in ("And", "Or"):
        return getattr(mod, kind)(tuple(build(mod, p) for p in desc[1]))
    if kind == "Not":
        return mod.Not(build(mod, desc[1]))
    return getattr(mod, kind)(*desc[1:])


def insert_near_tie(x, v, pre, a, b):
    """Does a near tie explain why inserting node ``v`` into the tables
    ``pre`` (numpy, per level) gave ``a`` in one package and ``b`` in the
    other?  Where v's own list differs at some level, the float64
    distances from x[v] to the ids of both lists must hold a near tie; a
    reverse list that differs while v's lists agree must hold one among
    its owner's distances to its earlier entries and v.  (A copy of
    ``chip_smoke.insert_near_tie``.)"""
    x = np.asarray(x, np.float64)

    def tie(owner, ids):
        d = np.sort(((x[ids] - x[owner]) ** 2).sum(-1))
        return bool((np.diff(d) <= NEAR_TIE_REL * d[1:]).any())

    for lvl in range(len(pre)):
        if not np.array_equal(a[lvl][v], b[lvl][v]):
            ids = np.union1d(a[lvl][v], b[lvl][v])
            return tie(v, ids[ids >= 0])
    for lvl in range(len(pre)):
        for u in np.nonzero((a[lvl] != b[lvl]).any(axis=1))[0]:
            if not tie(u, np.append(pre[lvl][u][pre[lvl][u] >= 0], v)):
                return False
    return True
