"""neighbor_expand in the PyTorch port against the JAX reference.

One parametrised test: on seeded small inputs (B = 4 lanes, cap = 8,
duplicate-heavy rows, -1 padding, ids absent from the level), the port's
plain version with either dedup (scatter-min and argsort) must give ids
identical to the reference's ``neighbor_expand_ref``,
``neighbor_expand_argsort`` and ``neighbor_expand_pallas`` (interpret
mode), for all three strategies, with the predicate mask and the visited
set given or None, ``m_beta`` in {0, mid, cap}, and an empty level table;
one more case has the search path's shape (cap = 128, m = 32, m_beta = 64,
duplicate-heavy 2-hop rows) with every lane stopping past stream position
1,024.  The CUDA kernel's edge cases (``CARD_CASES``, the same list as
``chip_smoke.py``'s ``NE_EDGE_CASES``) are held against the reference on
the CPU and against the plain version on the card (skipped without one).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.neighbor_expand.kernel import neighbor_expand_pallas
from repro.kernels.neighbor_expand.ref import (
    neighbor_expand_argsort as jax_argsort, neighbor_expand_ref as jax_ref)
from repro_torch.kernels.neighbor_expand import (neighbor_expand,
                                                 neighbor_expand_argsort,
                                                 neighbor_expand_cuda,
                                                 neighbor_expand_ref)
from repro_torch.kernels.neighbor_expand.ref import (_dedup_argsort, _passes,
                                                     expansion_candidates)
from torch_parity import cuda_device  # noqa: F401  (fixture)

B, CAP, N, N_L, M = 4, 8, 30, 20, 6

# the CUDA kernel's edge cases, the same as NE_EDGE_CASES in chip_smoke.py
# (case i is drawn with seed i by _edge_inputs): ids that share hash slots,
# one id throughout a stream, lanes that stop before m (all visited,
# nothing passes), m wider than a round (the shared-memory opt-in), filter
# at the upper levels' cap = 384, two_hop at acorn-1's cap = 64, an empty
# level, m_beta 0 and cap, and the path's shape with duplicate-heavy 2-hop
# rows whose lanes stop past 1,024 positions
CARD_CASES = [
    dict(kind="collide", strategy="compress", cap=128, m=32, m_beta=64,
         n=1 << 17),
    dict(kind="repeat", strategy="compress", cap=128, m=32, m_beta=64),
    dict(kind="repeat", strategy="two_hop", cap=64, m=32),
    dict(kind="all_visited", strategy="compress", cap=128, m=32, m_beta=64),
    dict(strategy="compress", cap=128, m=2000, m_beta=64, n=200_000,
         p_pass=1.0, p_vis=0.05),
    dict(strategy="filter", cap=384, m=32, p_pass=0.1),
    dict(strategy="two_hop", cap=64, m=32, p_pass=1 / 12),
    dict(strategy="compress", cap=128, m=32, m_beta=64, n_l=0),
    dict(strategy="two_hop", cap=64, m=32, n_l=0),
    dict(strategy="compress", cap=128, m=32, m_beta=0),
    dict(strategy="compress", cap=128, m=32, m_beta=128),
    dict(kind="path", strategy="compress", cap=128, m=32, m_beta=64,
         p_pass=0.03),
]
PATH = len(CARD_CASES) - 1   # the path-shape case


def _fib_slot(ids, bits):
    """The kernel's hash slot of each id in a set of 2^bits slots
    (``csrc/neighbor_expand.cu``, Fibonacci hashing)."""
    return ((ids.astype(np.uint64) * 0x9E3779B1) & 0xFFFFFFFF) >> (32 - bits)


def _edge_inputs(strategy, cap, m, m_beta=0, kind="random", b=4, n=4000,
                 n_l=None, p_pass=0.5, p_vis=0.1, seed=0):
    """(row, tbl, pos, pm, vis) numpy arrays of a CARD_CASES entry, as
    chip_smoke.py's expand_edge_inputs draws them."""
    rng = np.random.default_rng(seed)
    n_l = n if n_l is None else n_l
    level = rng.permutation(n)[:n_l]
    pos = np.full(n, -1, np.int32)
    pos[level] = np.arange(n_l, dtype=np.int32)
    pool = np.arange(n)
    if kind == "collide":   # two adjacent slots of the m = 32 set (4,096
        slot = _fib_slot(pool, 12)            # slots), and ids = 7 mod 4096
        pool = np.concatenate([pool[(slot == 5) | (slot == 6)],
                               pool[pool % 4096 == 7]])
    elif kind == "path":    # 2-hop rows overlap: 1,500 ids fill the stream
        pool = rng.choice(n, 1500, replace=False)
    row, tbl = (np.where(rng.random(s) < 0.03, -1, rng.choice(pool, size=s))
                .astype(np.int32) for s in ((b, cap), (n_l, cap)))
    if kind == "repeat":    # one id throughout each lane's stream
        x = rng.choice(level, size=b)
        row[:] = x[:, None]
        tbl[pos[x]] = x[:, None]
    pm = rng.random((b, n)) < p_pass
    vis = rng.random((b, n)) < p_vis
    if kind in ("repeat", "all_visited"):
        vis[0] = True           # lane 0: every id visited
        pm[1] = False           # lane 1: nothing passes
    return row, tbl, pos, pm, vis


def _edge_call(ci):
    """(inputs, keyword arguments) of CARD_CASES[ci]."""
    case = CARD_CASES[ci]
    kw = dict(strategy=case["strategy"], m=case["m"],
              m_beta=case.get("m_beta", 0))
    return _edge_inputs(**case, seed=ci), kw


def _stop_positions(row, tbl, pos, pm, vis, *, strategy, m, m_beta):
    """Each lane's stop: one past its m-th packed stream position (the
    stream's length where fewer pack)."""
    cand = expansion_candidates(row, tbl, pos, strategy, m_beta)
    ok = _passes(cand, pm, vis)
    if strategy != "filter":
        ok = ok & _dedup_argsort(cand)
    full = torch.cumsum(ok.to(torch.int64), dim=1) >= m
    return torch.where(full.any(dim=1), full.int().argmax(dim=1) + 1,
                       torch.full((row.shape[0],), cand.shape[1]))


def _inputs(seed, empty_table):
    rng = np.random.default_rng(seed)
    row = rng.integers(-1, 12, size=(B, CAP)).astype(np.int32)  # duplicates
    level_ids = rng.permutation(N)[:N_L]
    pos = np.full((N,), -1, np.int32)
    pos[level_ids] = np.arange(N_L, dtype=np.int32)
    n_l = 0 if empty_table else N_L
    tbl = rng.integers(-1, N, size=(n_l, CAP)).astype(np.int32)
    pm = rng.random((B, N)) < 0.6
    vis = rng.random((B, N)) < 0.3
    return row, tbl, pos, pm, vis


def _cases():
    out = []
    for strategy in ("filter", "compress", "two_hop"):
        m_betas = (0, CAP // 2, CAP) if strategy == "compress" else (0,)
        tables = (False,) if strategy == "filter" else (False, True)
        for mb in m_betas:
            for empty in tables:
                for has_pm in (False, True):
                    for has_vis in (False, True):
                        out.append((strategy, mb, empty, has_pm, has_vis))
    return out


def _ids(case):
    if case == "path":
        return "path-cap128-m32-mb64"
    s, mb, empty, pm, vis = case
    return f"{s}-mb{mb}-{'empty' if empty else 'table'}-pm{int(pm)}-vis{int(vis)}"


@pytest.mark.parametrize("case", _cases() + ["path"], ids=_ids)
def test_port_matches_reference(case):
    if case == "path":
        (row, tbl, pos, pm, vis), kw = _edge_call(PATH)
        stop = _stop_positions(*(torch.from_numpy(a) for a in
                                 (row, tbl, pos, pm, vis)), **kw)
        assert bool((stop > 1024).all()), stop   # several rounds of 512
    else:
        strategy, m_beta, empty, has_pm, has_vis = case
        row, tbl, pos, pm, vis = _inputs(_cases().index(case), empty)
        pm = pm if has_pm else None
        vis = vis if has_vis else None
        kw = dict(strategy=strategy, m=M, m_beta=m_beta)
    j = [None if a is None else jnp.asarray(a)
         for a in (row, tbl, pos, pm, vis)]
    t = [None if a is None else torch.from_numpy(np.array(a))
         for a in (row, tbl, pos, pm, vis)]
    want = np.asarray(jax_ref(*j, **kw))
    assert np.array_equal(np.asarray(jax_argsort(*j, **kw)), want)
    assert np.array_equal(
        np.asarray(neighbor_expand_pallas(*j, **kw, interpret=True)), want)
    for fn in (neighbor_expand_ref, neighbor_expand_argsort, neighbor_expand):
        got = fn(*t, **kw)
        assert got.dtype == torch.int32 and got.shape == (B, kw["m"])
        assert np.array_equal(got.numpy(), want), fn.__name__


def _edge_id(ci):
    case = CARD_CASES[ci]
    return (f"{case.get('kind', 'random')}-{case['strategy']}-cap"
            f"{case['cap']}-m{case['m']}-mb{case.get('m_beta', 0)}"
            f"{'-empty' if case.get('n_l') == 0 else ''}")


@pytest.mark.parametrize("ci", range(len(CARD_CASES)), ids=_edge_id)
def test_edge_cases_match_reference(ci):
    """The kernel's edge-case inputs, with the mask and visited set, through
    the plain version, the JAX reference and its Pallas kernel."""
    arrays, kw = _edge_call(ci)
    j = [jnp.asarray(a) for a in arrays]
    want = np.asarray(jax_ref(*j, **kw))
    assert np.array_equal(
        np.asarray(neighbor_expand_pallas(*j, **kw, interpret=True)), want)
    got = neighbor_expand(*(torch.from_numpy(a) for a in arrays), **kw)
    assert np.array_equal(got.numpy(), want)


def test_empty_batch_and_zero_m():
    row, tbl, pos, pm, vis = _inputs(0, False)
    t = [torch.from_numpy(a) for a in (row, tbl, pos, pm, vis)]
    assert neighbor_expand(t[0][:0], *t[1:3], strategy="compress",
                           m=M, m_beta=2).shape == (0, M)
    assert neighbor_expand(*t, strategy="two_hop", m=0).shape == (B, 0)


def _card_id(case):
    return _ids(case) if isinstance(case, tuple) else "edge-" + _edge_id(case)


@pytest.mark.parametrize(
    "case", [c for c in _cases() if c[3] and c[4]] + list(
        range(len(CARD_CASES))), ids=_card_id)
def test_cuda_kernel_matches_plain_version(cuda_device, case):
    if isinstance(case, tuple):
        strategy, m_beta, empty, _, _ = case
        arrays = _inputs(7, empty)
        kw = dict(strategy=strategy, m=M, m_beta=m_beta)
    else:   # an edge case, with and without the mask and visited set
        arrays, kw = _edge_call(case)
    row, tbl, pos, pm, vis = (torch.from_numpy(np.array(a)).to(cuda_device)
                              for a in arrays)
    masks = ((pm, vis),) if isinstance(case, tuple) else (
        (None, None), (pm, None), (None, vis), (pm, vis))
    for p_, v_ in masks:
        got = neighbor_expand_cuda(row, tbl, pos, p_, v_, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, neighbor_expand_ref(row, tbl, pos, p_, v_,
                                                    **kw))
