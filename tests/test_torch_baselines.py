"""The PyTorch port's HNSW builder and the paper's baselines against the
JAX reference.

Data: ``make_lcps_dataset(n=1500, d=16, card=8, seed=0)``, M = 8, the
reference's levels passed in.  ``rng_prune`` on the reference's own KNN
lists must be identical; ``build_hnsw`` identical except where the exact
KNN meets a near tie, which the test explains as ``test_torch_build.py``
does (the port's prune and reverse-slack passes on the reference's KNN
lists give the reference's lists exactly).  ``postfilter_search`` on a
converted reference graph at two selectivities that land in different
pool buckets, and ``OraclePartitionIndex`` carried across with
``convert.oracle_from_arrays``: ids identical except at near ties,
distances within float32 tolerance (``torch_parity.assert_ids_match``).
A port-built oracle with the reference's per-partition levels has the
reference's graphs.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import OraclePartitionIndex as JOracle
from repro.core import build as jbuild
from repro.core import postfilter_search as j_postfilter
from repro.core.baselines import _bucket as j_bucket
from repro.data import make_lcps_dataset, make_workload
from repro_torch.convert import oracle_from_arrays
from repro_torch.core import OraclePartitionIndex, build_hnsw, rng_prune
from repro_torch.core import build as tbuild
from repro_torch.core import postfilter_search
from repro_torch.core.baselines import _bucket, postfilter_pool
from torch_parity import (NEAR_TIE_REL, assert_ids_match, one_thread,  # noqa: F401
                          port_graph)

pytestmark = pytest.mark.usefixtures("one_thread")

N, D, CARD, SEED, M = 1500, 16, 8, 0, 8
KEY = jax.random.PRNGKey(SEED)
ORACLE_PIDS = (0, 5)


@pytest.fixture(scope="module")
def ds():
    return make_lcps_dataset(n=N, d=D, card=CARD, seed=SEED)


@pytest.fixture(scope="module")
def x(ds):
    return np.asarray(ds.x)


@pytest.fixture(scope="module")
def wl(ds):
    return make_workload(ds, kind="equals", n_queries=32, seed=1, card=CARD)


@pytest.fixture(scope="module")
def ref_hnsw(x):
    return jbuild.build_hnsw(x, KEY, M)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("m_out,block", [(12, 97), (4, None)])
def test_rng_prune_matches_reference(x, m_out, block):
    """Level 0's and the upper levels' prune widths (2M and M less the
    slack); the port's output does not depend on its block."""
    knn = np.asarray(jbuild.knn_among(x, max(2 * M, 40)))
    want = np.asarray(jbuild.rng_prune(x, knn, m_out))
    got = rng_prune(_t(x), _t(knn), m_out, block=block).numpy()
    assert np.array_equal(got, want)


def test_build_hnsw_matches_reference(x, ref_hnsw):
    jg = ref_hnsw
    levels = np.asarray(jg.levels)
    tg = build_hnsw(_t(x), None, M, levels=levels)
    assert tg.num_levels == jg.num_levels
    assert int(tg.entry_point) == int(jg.entry_point)
    efc = max(2 * M, 40)
    for lvl in range(jg.num_levels):
        assert np.array_equal(tg.pos[lvl].numpy(), np.asarray(jg.pos[lvl]))
        assert np.array_equal(tg.node_ids[lvl].numpy(),
                              np.asarray(jg.node_ids[lvl]))
        want = np.asarray(jg.neighbors[lvl])
        got = tg.neighbors[lvl].numpy()
        assert got.shape == want.shape
        if np.array_equal(got, want):
            continue
        # a difference must trace back to an exact-KNN near tie: the KNN
        # lists differ only at near ties, and the port's prune and slack
        # on the reference's own KNN lists give the reference's lists
        members = np.nonzero(levels >= lvl)[0]
        xm = x[members]
        k_cand = min(efc, max(len(members) - 1, 1))
        knn_ref = np.asarray(jbuild.knn_among(xm, k_cand))
        knn_port = tbuild.knn_among(_t(xm), k_cand).numpy()
        for r in np.nonzero((knn_port != knn_ref).any(axis=1))[0]:
            for a, b in zip(knn_port[r], knn_ref[r]):
                da = ((xm[a] - xm[r]).astype(np.float64) ** 2).sum()
                db = ((xm[b] - xm[r]).astype(np.float64) ** 2).sum()
                assert abs(da - db) <= NEAR_TIE_REL * max(da, db), (r, a, b)
        r_slack = max(2, M // 2)
        cap = 2 * M if lvl == 0 else M
        local = tbuild.with_reverse_slack(
            rng_prune(_t(xm), _t(knn_ref), max(cap - r_slack, 1)), r_slack)
        glob = np.where(local.numpy() >= 0, members[local.numpy()], -1)
        assert np.array_equal(glob, want)


@pytest.mark.parametrize("selectivity", [0.125, 0.3])
def test_postfilter_matches_reference(ds, x, wl, ref_hnsw, selectivity):
    masks = np.asarray(wl.masks(ds))
    kk, ef_eff = postfilter_pool(10, selectivity, 64)
    assert (kk, ef_eff) == ((80, 128) if selectivity == 0.125 else (40, 64))
    want_ids, want_d = j_postfilter(ref_hnsw, ds.x, wl.xq, masks, 10,
                                    selectivity=selectivity, ef=64, m=M)
    ids, d = postfilter_search(port_graph(ref_hnsw), _t(x), _t(wl.xq),
                               _t(masks), 10, selectivity=selectivity, ef=64,
                               m=M)
    assert_ids_match(ids.numpy(), want_ids, d.numpy(), want_d, x, wl.xq)
    got = ids.numpy()
    assert masks[np.arange(len(got))[:, None], got.clip(0)][got >= 0].all()


@pytest.fixture(scope="module")
def ref_oracle(ds):
    labels = np.asarray(ds.table.int_cols["label"])
    return JOracle.build(ds.x, {v: labels == v for v in ORACLE_PIDS}, KEY,
                         M=M)


def _graph_arrays(g):
    return dict(neighbors=[np.asarray(a) for a in g.neighbors],
                pos=[np.asarray(a) for a in g.pos],
                node_ids=[np.asarray(a) for a in g.node_ids],
                entry_point=np.asarray(g.entry_point),
                levels=np.asarray(g.levels))


def test_oracle_from_arrays_matches_reference(x, wl, ref_oracle):
    oracle = oracle_from_arrays(
        {pid: (_graph_arrays(g), np.asarray(xp), np.asarray(gids))
         for pid, (g, xp, gids) in ref_oracle.partitions.items()},
        M, device="cpu")
    assert sorted(oracle.partitions) == list(ORACLE_PIDS)
    for pid in ORACLE_PIDS:
        want_ids, want_d, want_st = ref_oracle.search(pid, wl.xq, k=10, ef=32)
        ids, d, st = oracle.search(pid, _t(wl.xq), k=10, ef=32)
        assert_ids_match(ids.numpy(), want_ids, d.numpy(), want_d, x, wl.xq)
        assert np.array_equal(st.dist_comps.numpy(),
                              np.asarray(want_st.dist_comps))


def test_oracle_build_matches_reference(ds, x, ref_oracle):
    labels = np.asarray(ds.table.int_cols["label"])
    oracle = OraclePartitionIndex.build(
        _t(x), {v: labels == v for v in ORACLE_PIDS}, M=M,
        levels={pid: np.asarray(g.levels)
                for pid, (g, _, _) in ref_oracle.partitions.items()})
    for pid in ORACLE_PIDS:
        jg, jxp, jgids = ref_oracle.partitions[pid]
        tg, txp, tgids = oracle.partitions[pid]
        assert np.array_equal(tgids.numpy(), np.asarray(jgids))
        assert np.array_equal(txp.numpy(), np.asarray(jxp))
        assert int(tg.entry_point) == int(jg.entry_point)
        for a, b in zip(tg.neighbors, jg.neighbors):
            assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("v,lo,hi", [
    (1, 10, 4096), (10, 10, 4096), (11, 10, 4096), (20, 10, 4096),
    (21, 10, 4096), (4096, 10, 4096), (5000, 10, 4096), (5000, 64, 64),
    (64, 64, 4096), (65, 64, 4096), (3, 5, 4), (0, 1, 1)])
def test_bucket_edges(v, lo, hi):
    assert _bucket(v, lo, hi) == j_bucket(v, lo, hi)
    b = _bucket(v, lo, hi)
    assert b <= max(hi, lo) and (b >= min(v, hi) or b == hi)
