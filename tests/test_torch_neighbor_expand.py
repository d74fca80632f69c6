"""neighbor_expand in the PyTorch port against the JAX reference.

One parametrised test: on seeded small inputs (B = 4 lanes, cap = 8,
duplicate-heavy rows, -1 padding, ids absent from the level), the port's
plain version with either dedup (scatter-min and argsort) must give ids
identical to the reference's ``neighbor_expand_ref``,
``neighbor_expand_argsort`` and ``neighbor_expand_pallas`` (interpret
mode), for all three strategies, with the predicate mask and the visited
set given or None, ``m_beta`` in {0, mid, cap}, and an empty level table.
The CUDA kernel is held against the plain version on the card (skipped
without one).
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
from torch_parity import cuda_device  # noqa: F401  (fixture)

B, CAP, N, N_L, M = 4, 8, 30, 20, 6


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
    s, mb, empty, pm, vis = case
    return f"{s}-mb{mb}-{'empty' if empty else 'table'}-pm{int(pm)}-vis{int(vis)}"


@pytest.mark.parametrize("case", _cases(), ids=_ids)
def test_port_matches_reference(case):
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
        assert got.dtype == torch.int32 and got.shape == (B, M)
        assert np.array_equal(got.numpy(), want), fn.__name__


def test_empty_batch_and_zero_m():
    row, tbl, pos, pm, vis = _inputs(0, False)
    t = [torch.from_numpy(a) for a in (row, tbl, pos, pm, vis)]
    assert neighbor_expand(t[0][:0], *t[1:3], strategy="compress",
                           m=M, m_beta=2).shape == (0, M)
    assert neighbor_expand(*t, strategy="two_hop", m=0).shape == (B, 0)


@pytest.mark.parametrize("case", [c for c in _cases() if c[3] and c[4]],
                         ids=_ids)
def test_cuda_kernel_matches_plain_version(cuda_device, case):
    strategy, m_beta, empty, _, _ = case
    row, tbl, pos, pm, vis = _inputs(7, empty)
    t = [torch.from_numpy(np.array(a)).to(cuda_device)
         for a in (row, tbl, pos, pm, vis)]
    kw = dict(strategy=strategy, m=M, m_beta=m_beta)
    got = neighbor_expand_cuda(*t, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, neighbor_expand_ref(*t, **kw))
