"""Shared helpers of the PyTorch port's parity tests (``test_torch_*.py``).

The reference's state crosses over as numpy (``repro_torch.convert``), the
tests compare on the CPU, and a test that needs the card asks for the
``cuda_device`` fixture, which skips when no GPU is present (decided at
run time, never at import time).
"""
import datetime
import importlib.util
import os
import pickle
import time
import traceback
import uuid

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.convert import (adamw_state_from_arrays,
                                 dcnv2_params_from_arrays,
                                 dien_params_from_arrays, graph_from_arrays,
                                 lm_params_from_arrays,
                                 pna_params_from_arrays,
                                 sasrec_params_from_arrays, table_from_arrays,
                                 two_tower_params_from_arrays)
from repro_torch.models.recsys import DCNv2Config, DIENConfig, SASRecConfig

# caption words of the random trees' regex leaves
KW_WORDS = ["animal", "green", "blue", "city", "ocean"]

# relative width of a near tie in distance: two ids whose distances to the
# query agree this closely may swap places between the packages (their
# fp32 sums run in different orders)
NEAR_TIE_REL = 1e-5


def load_chip_smoke():
    """chip_smoke.py, loaded from the repo root (it imports no torch or
    JAX at module level)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


# the longest a spawned rank group may run; a stuck collective fails one
# test instead of running the suite into its time limit
RANK_TIMEOUT_S = 300
# a collective that waits this long raises instead of hanging
GROUP_TIMEOUT = datetime.timedelta(seconds=60)


def _rank_main(fn, rank, world, store, out, env, args):
    """One spawned rank: one torch thread, a gloo group over a FileStore
    (or, with ``env``, the environment's own rendezvous left to ``fn``);
    ``fn(rank, world, *args)``'s return value, or its traceback, pickled
    to ``out``."""
    torch.set_num_threads(1)
    os.environ.update(env or {})
    status = ("err", "did not finish")
    try:
        if not env:
            dist.init_process_group(
                "gloo", store=dist.FileStore(store, world), rank=rank,
                world_size=world, timeout=GROUP_TIMEOUT)
        status = ("ok", fn(rank, world, *args))
    except BaseException:  # noqa: BLE001  (reported by the parent)
        status = ("err", traceback.format_exc())
    finally:
        with open(out, "wb") as f:
            pickle.dump(status, f)
        if dist.is_initialized():
            dist.destroy_process_group()
    os._exit(0 if status[0] == "ok" else 1)


def run_ranks(fn, world, tmp_path, *args, torchrun_env=False,
              timeout=RANK_TIMEOUT_S):
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes, the
    ranks of a gloo group on the CPU, and return their results in rank
    order.  ``fn`` must be a module-level function of a module the ranks
    can import.  ``torchrun_env=True`` sets ``RANK``/``LOCAL_RANK``/
    ``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT`` (a free localhost port)
    as ``torchrun`` does and leaves joining the group to ``fn``.  Fails the
    test on the first rank that raises (with its traceback) or, killing
    every rank, when they outlive ``timeout`` seconds."""
    ctx = torch.multiprocessing.get_context("spawn")
    tag = uuid.uuid4().hex[:8]
    store = str(tmp_path / f"store-{tag}")
    outs = [str(tmp_path / f"rank{r}-{tag}.pkl") for r in range(world)]
    port = None
    if torchrun_env:
        import socket
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
    procs = []
    for r in range(world):
        env = (dict(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                    MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
               if torchrun_env else None)
        p = ctx.Process(target=_rank_main,
                        args=(fn, r, world, store, outs[r], env, args),
                        daemon=True)
        p.start()
        procs.append(p)
    deadline = time.monotonic() + timeout
    failed = None
    while any(p.is_alive() for p in procs):
        failed = next((r for r, p in enumerate(procs)
                       if p.exitcode not in (None, 0)), None)
        if failed is not None or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    statuses = []
    for r, path in enumerate(outs):
        status = ("err", f"killed, or exited {procs[r].exitcode} without a "
                  "result")
        if os.path.exists(path):
            with open(path, "rb") as f:
                status = pickle.load(f)
        statuses.append(status)
    bad = [r for r, st in enumerate(statuses) if st[0] != "ok"]
    if bad:
        r = failed if failed is not None else bad[0]
        hung = failed is None and time.monotonic() > deadline
        pytest.fail(f"rank {r} of {world}"
                    + (f" (the group outlived {timeout} s)" if hung else "")
                    + f":\n{statuses[r][1]}")
    return [st[1] for st in statuses]


def assert_ranks_equal(results):
    """Every rank returned the same arrays (nested dicts / lists)."""
    def eq(a, b, where):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), where
            for key in a:
                eq(a[key], b[key], f"{where}[{key!r}]")
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                eq(x, y, f"{where}[{i}]")
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), where
    for r, res in enumerate(results[1:], start=1):
        eq(results[0], res, f"rank {r} vs rank 0")


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
    return pna_params_from_arrays(_numpy_tree(params), cfg, device=device)


def _numpy_tree(tree):
    """A JAX pytree (dicts and lists of arrays) as numpy."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return np.asarray(tree)


def port_two_tower(params, cfg, device="cpu"):
    """The port's ``TwoTower`` from a reference ``init_two_tower`` tree."""
    return two_tower_params_from_arrays(_numpy_tree(params), cfg,
                                        device=device)


def port_recsys(params, cfg, device="cpu"):
    """The port's DIEN, SASRec or DCN-v2 (after ``cfg``'s type) from the
    reference's ``init_dien`` / ``init_sasrec`` / ``init_dcnv2`` tree."""
    conv = {DIENConfig: dien_params_from_arrays,
            SASRecConfig: sasrec_params_from_arrays,
            DCNv2Config: dcnv2_params_from_arrays}[type(cfg)]
    return conv(_numpy_tree(params), cfg, device=device)


def port_lm(params, cfg, device="cpu"):
    """The port's ``Transformer`` from a reference ``init_lm`` tree (its
    stacked layers sliced per layer)."""
    return lm_params_from_arrays(_numpy_tree(params), cfg, device=device)


def port_adamw_state(state, model, device="cpu"):
    """The port's ``AdamWState`` for ``model`` (a ported ``TwoTower``,
    ``PNA``, ``DIEN``, ``SASRec``, ``DCNv2`` or ``Transformer``) from a reference
    ``AdamWState`` over the same parameters."""
    return adamw_state_from_arrays(np.asarray(state.step),
                                   _numpy_tree(state.mu),
                                   _numpy_tree(state.nu), model,
                                   device=device)


def assert_grad_close(got, want, rtol, atol=1e-6, what=""):
    """|got - want| <= rtol |want| + atol max(1, max|want|), elementwise:
    above magnitude 1 a gradient's fp32 rounding grows with its largest
    entry (one ulp of 10 is ~1e-6), so the atol scales with it there."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale,
                               err_msg=what)


def reference_grads64(loss_fn, params, batch):
    """The gradients of a reference loss ``loss_fn(params, batch)`` run in
    float64 (``jax.enable_x64``): the params and the batch's fp32 arrays
    cast up, integers as they are.  Returned as a numpy pytree."""
    import jax
    import jax.numpy as jnp

    def up(a):
        a = np.asarray(a)
        return jnp.asarray(a.astype(np.float64) if a.dtype == np.float32
                           else a)
    with jax.enable_x64(True):
        g = jax.jit(jax.grad(loss_fn))(jax.tree_util.tree_map(up, params),
                              {k: up(v) for k, v in batch.items()})
        return jax.tree_util.tree_map(np.asarray, g)


def assert_grad_within_noise(got, want, want64, factor=4.0, floor=1e-5,
                             what=""):
    """``got`` (the port's fp32 gradient) within ``factor`` times the
    reference's own fp32 rounding (``want`` against its float64 run
    ``want64``) of ``want``, or within ``floor``, in L2 relative to
    ``want64``.  PNA's std block turns fp32 rounding of a variance near 0
    into gradient noise (its gradient there is 5e5): the reference's fp32
    gradients of the early layers stand ~1 % from its float64 run, so
    they cannot be matched elementwise; the port's distance to them is
    held to the size of that noise instead."""
    got, want, want64 = (np.asarray(a, np.float64)
                         for a in (got, want, want64))
    norm = float(np.linalg.norm(want64)) or 1.0
    err = float(np.linalg.norm(got - want)) / norm
    noise = float(np.linalg.norm(want - want64)) / norm
    assert err <= max(floor, factor * noise), (
        f"{what}: port vs reference {err:.3g} (relative L2) > "
        f"{max(floor, factor * noise):.3g} (the reference's fp32 vs float64 "
        f"{noise:.3g})")


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


def graph_arrays(g):
    """A reference ``LayeredGraph``'s fields as numpy: the keyword
    arguments of ``convert.graph_from_arrays`` but ``device``."""
    return dict(neighbors=[np.asarray(a) for a in g.neighbors],
                pos=[np.asarray(a) for a in g.pos],
                node_ids=[np.asarray(a) for a in g.node_ids],
                entry_point=np.asarray(g.entry_point),
                levels=np.asarray(g.levels))


def engine_arrays(engine):
    """A reference engine's shards (graphs, vectors, tables) as numpy, the
    ``shards`` argument of ``convert.engine_from_arrays``."""
    def table(t):
        return dict(int_cols={k: np.asarray(v) for k, v in t.int_cols.items()},
                    bitset_cols={k: np.asarray(v)
                                 for k, v in t.bitset_cols.items()},
                    str_cols=dict(t.str_cols), n_keywords=dict(t.n_keywords))

    return [dict(graph=graph_arrays(s.index.graph), x=np.asarray(s.index.x),
                 table=table(s.index.table)) for s in engine.shards]


def port_engine(engine, torch_acorn, torch_cfg, seed=0, device="cpu"):
    """The port's ``ServingEngine`` over a reference engine's shards (its
    graphs, vectors and tables, as numpy)."""
    from repro_torch.convert import engine_from_arrays
    return engine_from_arrays(engine_arrays(engine), torch_acorn, torch_cfg,
                              seed=seed, device=device)


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
